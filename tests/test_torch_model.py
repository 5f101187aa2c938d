"""The port's DecoderModel (forward + logits) and loader against the JAX
package's, on a tiny Llama in float32: one mixed prefill/decode batch and
two decode steps after it, over the same paged KV cache layout. Tolerance
1e-4 on logits (two layers of f32 matmuls summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import tiny_llama
from scalellm_tpu.config import ModelArgs as JaxModelArgs
from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
from scalellm_tpu.models.common import DecoderModel as JaxDecoderModel
from scalellm_tpu_torch.config import ModelArgs
from scalellm_tpu_torch.engine.params import ModelInputs
from scalellm_tpu_torch.models.common import DecoderModel, convert_params

TOL = 1e-4
PAGE = 4
KW = dict(
    model_type="llama", dtype="float32", hidden_size=64, intermediate_size=128,
    n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256,
    max_position_embeddings=512,
)


def _inputs(chunks, S=4, T=16, maxp=4):
    """chunks: (seq index, first position, token ids) per scheduled sequence.
    Sequence i owns pages 1 + i*maxp ... (page 0 is the padding page)."""
    tok = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    seg = np.zeros(T, np.int32)
    slots = np.zeros(T, np.int32)
    tables = np.zeros((S, maxp), np.int32)
    kv_lens = np.zeros(S, np.int32)
    cu = np.zeros(S + 1, np.int32)
    sel = np.zeros(S, np.int32)
    mask = np.zeros(S, np.float32)
    t = 0
    for s, (i, start, ids) in enumerate(chunks):
        n = len(ids)
        pages = 1 + i * maxp + np.arange(maxp)
        p = np.arange(start, start + n)
        tok[t : t + n] = ids
        pos[t : t + n] = p
        seg[t : t + n] = s
        slots[t : t + n] = pages[p // PAGE] * PAGE + p % PAGE
        tables[s] = pages
        kv_lens[s] = start + n
        cu[s + 1] = t + n
        sel[s] = t + n - 1
        mask[s] = 1.0
        t += n
    cu[len(chunks) + 1 :] = cu[len(chunks)]
    return dict(
        token_ids=tok, positions=pos, token_seg=seg, new_kv_slot_ids=slots,
        block_tables=tables, kv_lens=kv_lens, cu_q_lens=cu,
        num_seqs=np.array([len(chunks)], np.int32), selected_idxes=sel,
        seq_mask=mask,
    )


@pytest.fixture(scope="module")
def models():
    jmodel = JaxDecoderModel(JaxModelArgs(**KW))
    params = jmodel.init_params(jax.random.PRNGKey(0), scale=0.1)
    params = jax.tree_util.tree_map(np.asarray, params)
    args = ModelArgs(**KW)
    tmodel = DecoderModel(args, device="meta")
    tmodel.load_state_dict(convert_params(params, args), assign=True)
    return jmodel, params, tmodel


def test_forward_and_logits_match_jax_over_steps(models):
    jmodel, params, tmodel = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (8, 10, 5)]
    # Step 0 prefills A and B's first chunk; step 1 mixes A's decode, B's
    # second chunk and C's prefill; steps 2-3 decode all three.
    steps = [
        [(0, 0, prompts[0][:7]), (1, 0, prompts[1][:5])],
        [(0, 7, prompts[0][7:]), (1, 5, prompts[1][5:9]), (2, 0, prompts[2][:3])],
        [(0, 8, [11]), (1, 9, prompts[1][9:]), (2, 3, prompts[2][3:4])],
        [(0, 9, [12]), (1, 10, [13]), (2, 4, prompts[2][4:])],
    ]

    @jax.jit
    def jax_step(p, kv, mi):
        h, kv = jmodel.forward(p, kv, mi)
        return jmodel.logits(p, h), kv

    kv_shape = jmodel.kv_cache_shape(16, PAGE)
    assert tuple(kv_shape) == tmodel.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(kv_shape, jnp.float32)
    tkv = torch.zeros(kv_shape)
    for chunks in steps:
        arrays = _inputs(chunks)
        want, jkv = jax_step(params, jkv, JaxModelInputs(
            **{k: jnp.asarray(v) for k, v in arrays.items()}))
        with torch.inference_mode():
            mi = ModelInputs(**arrays).to("cpu")
            got = tmodel.logits(tmodel(tkv, mi))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=TOL, rtol=TOL)


def test_loader_reads_the_checkpoint_like_jax():
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu_torch.engine.llm_engine import LLMEngine  # noqa: F401
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    path = tiny_llama()  # fixtures.make_tiny_llama's checkpoint, shared
    jl = JaxLoader(path)
    from scalellm_tpu.parallel.config import ParallelConfig

    jm = JaxRegistry.get_causal_lm_factory("llama")(jl.model_args, ParallelConfig())
    sd_want = convert_params(jl.load_params(jm), jl.model_args)

    tl = HFModelLoader(path)
    tm = ModelRegistry.get_causal_lm_factory("llama")(tl.model_args, device="meta")
    sd_got = tl.load_state_dict(tm, "cpu")
    assert sorted(sd_got) == sorted(sd_want)
    for name, t in sd_got.items():
        assert t.dtype == torch.float32, name
        assert torch.equal(t, sd_want[name]), name
