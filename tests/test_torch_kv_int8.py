"""The port's int8 KV cache against the JAX package's, on the CPU:

- the scatters (set_kv_cache, set_latent_cache) into int8 pages: the same
  bits as the JAX functions;
- the plain ragged paged attention over int8 pages with static k/v scales,
  with ALiBi, a window and a soft cap, and the plain MLA versions over int8
  latent pages, against ref_ragged_paged_attention and
  ref_mla_paged_attention: tolerance 1e-5 (the same f32 products summed in
  another order; the MLA plain versions round int8 * k_scale to bf16 as the
  kernels do, exact at the scales used);
- the models' logits with kv_cache_dtype="int8" over mixed and decode-only
  paged steps, the per-layer kv_scales (random, in the JAX tree) carried by
  convert_params: a tiny Llama in f32 and bf16, MPT (ALiBi), GPT-2 in f32,
  Mixtral (MoE) and a tiny DeepSeek-V2 (the static kv_scale): f32 1e-4
  (1e-3 for the MoE families, whose routing softmax amplifies), bf16 as the
  bf16 tests of the zoo; the int8 pages they wrote the same bits in f32, and
  in bf16 within one step in at most 1% of the elements (bf16 k and v an
  ulp apart, from sums in another order, land across a .5 now and then);
- LLM.generate with kv_cache_dtype="int8" and a kv_scales.json sidecar: the
  JAX LLM's greedy ids, with async scheduling (the default) and without.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import _inputs
from tests.torch_port_util import generate_within, latent_batch, ragged_batch, shared_checkpoint, tiny_llama

TOL = 1e-5
PAGE = 4
STEPS = [  # mixed prefill chunks, then decode-only steps
    ([(0, 0, [3, 17, 42, 9, 100, 7, 120]), (1, 0, [5, 6, 7, 8, 9])], False),
    ([(0, 7, [11]), (1, 5, [12, 13]), (2, 0, [1, 2, 3, 4, 60, 61, 62, 63, 64, 65])], False),
    ([(0, 8, [21]), (1, 7, [22]), (2, 10, [23])], True),
    ([(0, 9, [31]), (1, 8, [32]), (2, 11, [33])], True),
]


# ------------------------------------------------------------------ scatters


def test_set_kv_cache_int8_is_bit_equal_to_jax():
    from scalellm_tpu.ops.kv_update import set_kv_cache as jax_set
    from scalellm_tpu_torch.ops.kv_update import set_kv_cache

    rng = np.random.default_rng(0)
    k = (rng.standard_normal((10, 2, 16)) * 3).astype(np.float32)
    v = (rng.standard_normal((10, 2, 16)) * 3).astype(np.float32)
    slots = rng.permutation(np.arange(4, 40))[:10].astype(np.int32)
    pages = np.zeros((10, 4, 4, 16), np.int8)
    for ks, vs in ((0.05, 0.02), (np.float32(0.0625), np.float32(0.0371))):  # clipping at 127 included
        want = np.asarray(jax_set(jnp.asarray(pages), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots),
                                  k_scale=ks, v_scale=vs))
        got = set_kv_cache(torch.from_numpy(pages.copy()), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(slots), k_scale=torch.tensor(ks, dtype=torch.float32),
                           v_scale=torch.tensor(vs, dtype=torch.float32))
        assert got.dtype == torch.int8 and np.abs(want).max() == 127
        np.testing.assert_array_equal(got.numpy(), want)


def test_set_latent_cache_int8_is_bit_equal_to_jax():
    from scalellm_tpu.ops.mla_attention import set_latent_cache as jax_set
    from scalellm_tpu_torch.ops.mla_attention import set_latent_cache

    rng = np.random.default_rng(1)
    k_lat = (rng.standard_normal((9, 24)) * 4).astype(np.float32)
    slots = rng.permutation(np.arange(16, 64))[:9].astype(np.int32)
    pages = np.zeros((16, 4, 1, 24), np.int8)
    want = np.asarray(jax_set(jnp.asarray(pages), jnp.asarray(k_lat), jnp.asarray(slots), scale=0.0625))
    got = set_latent_cache(torch.from_numpy(pages.copy()), torch.from_numpy(k_lat), torch.from_numpy(slots),
                           scale=0.0625)
    assert got.dtype == torch.int8 and np.abs(want).max() == 127
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ plain versions

# (n_heads, n_kv_heads, head_dim, window, soft cap, ALiBi)
K1_CASES = {
    "gqa2_d64": (4, 2, 64, None, None, False),
    "alibi_d128": (4, 4, 128, None, None, True),
    "window_softcap_d80": (8, 2, 80, 5, 30.0, False),
    "alibi_window_d256": (4, 1, 256, 6, None, True),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_plain_attention_over_int8_pages_matches_jax(case):
    from scalellm_tpu.ops.attention_ref import ref_ragged_paged_attention as jax_ref
    from scalellm_tpu_torch.layers.alibi import alibi_slopes
    from scalellm_tpu_torch.ops.attention import plain_ragged_paged_attention, plain_split_kv_attention

    H, Hkv, D, window, cap, alibi = K1_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    inputs = ragged_batch(rng, q_lens=[6, 4, 1, 1, 1], kv_lens=[6, 11, 9, 1, 14], S=8, T=16, n_heads=H,
                          n_kv_heads=Hkv, head_dim=D)
    inputs["kv_pages"] = rng.integers(-127, 128, inputs["kv_pages"].shape).astype(np.int8)
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap, k_scale=0.03, v_scale=0.05)
    if alibi:
        kw["alibi_slopes"] = np.asarray(alibi_slopes(H), np.float32)
    want = np.asarray(jax_ref(*[jnp.asarray(inputs[k]) for k in inputs], **kw))
    tkw = dict(kw, alibi_slopes=torch.from_numpy(kw["alibi_slopes"])) if alibi else kw
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    got = plain_ragged_paged_attention(**tin, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert np.all(got[13:] == 0.0)
    # The split-and-merge of the decode kernel on the decode slots alone
    # (rows 0-2 of a decode-only batch): int8 * scale rounded to q's type,
    # which is exact in f32.
    dec = ragged_batch(np.random.default_rng(3), q_lens=[1, 1, 1], kv_lens=[9, 1, 14], S=4, T=4, n_heads=H,
                       n_kv_heads=Hkv, head_dim=D)
    dec["kv_pages"] = rng.integers(-127, 128, dec["kv_pages"].shape).astype(np.int8)
    dec = {k: torch.from_numpy(v) for k, v in dec.items()}
    np.testing.assert_allclose(plain_split_kv_attention(**dec, **tkw).numpy(),
                               plain_ragged_paged_attention(**dec, **tkw).numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("decode_only", [False, True])
def test_plain_mla_over_int8_pages_matches_jax(decode_only):
    from scalellm_tpu.ops.mla_attention import ref_mla_paged_attention as jax_ref
    from scalellm_tpu_torch.ops.mla_attention import plain_mla_paged_attention, plain_mla_split_decode

    rng = np.random.default_rng(5 + decode_only)
    q_lens = [1, 1, 1] if decode_only else [5, 1, 3]
    inputs = latent_batch(rng, q_lens=q_lens, kv_lens=[20, 7, 33], S=4, T=12, n_heads=4, latent_dim=24,
                          page_size=4)
    inputs["k_pages"] = rng.integers(-127, 128, inputs["k_pages"].shape).astype(np.int8)
    kw = dict(sm_scale=0.2, v_dim=16, k_scale=0.0625)  # int8 * 1/16 is a bf16 value
    order = ("q", "k_pages", "kv_lens", "page_indices", "cu_q_lens", "num_seqs")
    want = np.asarray(jax_ref(*[jnp.asarray(inputs[k]) for k in order], **kw))
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    got = plain_mla_paged_attention(**tin, **kw, decode_only=decode_only).numpy()
    n = sum(q_lens)
    np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
    assert np.all(got[n:] == 0.0)
    if decode_only:
        split = plain_mla_split_decode(tin["q"], tin["k_pages"], tin["kv_lens"], tin["page_indices"], **kw)
        np.testing.assert_allclose(split.numpy()[:n], want[:n], atol=TOL, rtol=TOL)


# ------------------------------------------------------------------ models

# name -> (checkpoint, dtype, logits tolerance)
MODEL_CASES = {
    "llama_f32": ("llama", "float32", 1e-4),
    "llama_bf16": ("llama", "bfloat16", None),
    "mpt_alibi_f32": ("mpt", "float32", 1e-4),
    "gpt2_f32": ("gpt2", "float32", 1e-4),
    "mixtral_f32": ("mixtral", "float32", 1e-3),
    "deepseek_f32": ("deepseek", "float32", 1e-3),
}


def _deepseek_checkpoint() -> str:
    """tests/test_torch_deepseek.py's tiny deepseek_v2 (3 layers, 4 routed
    experts, yarn rope), built once for every file that asks for it."""
    from tests.test_torch_deepseek import HF_KW, YARN

    def build(d):
        from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

        torch.manual_seed(0)
        DeepseekV2ForCausalLM(DeepseekV2Config(**HF_KW)).to(torch.float32).save_pretrained(
            d, safe_serialization=True)
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        cfg["rope_scaling"] = YARN
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)

    return shared_checkpoint("tiny_deepseek_v2_yarn_seed0", build)


def _checkpoint(name):
    if name == "llama":
        return tiny_llama()
    if name == "deepseek":
        return _deepseek_checkpoint()
    if name in ("mpt", "gpt2"):
        from tests.test_torch_layernorm_models import checkpoint
    else:
        from tests.test_torch_moe_models import checkpoint
    return checkpoint(name)


def _int8_models(name, dtype):
    """The JAX model with int8 KV and its params (random per-layer kv_scales
    where the model has them), and the port's model from convert_params of
    the same tree."""
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.models import common, deepseek

    loader = JaxLoader(_checkpoint(name))
    jargs = loader.model_args
    jargs.dtype, jargs.kv_cache_dtype = dtype, "int8"
    jmodel = JaxRegistry.get_causal_lm_factory(loader.model_type)(jargs, ParallelConfig())
    params = jax.tree_util.tree_map(np.asarray, loader.load_params(jmodel))
    if "kv_scales" in params.get("layers", {}):
        rng = np.random.default_rng(11)
        params["layers"]["kv_scales"] = rng.uniform(0.01, 0.04, (jargs.n_layers, 2)).astype(np.float32)
    args = ModelArgs(**{k: getattr(jargs, k) for k in ModelArgs.__dataclass_fields__ if k != "quant_args"})
    mla = name == "deepseek"
    cls = deepseek.MLADecoderModel if mla else common.DecoderModel
    tmodel = cls(args, device="meta")
    tmodel.load_state_dict((deepseek if mla else common).convert_params(params, args), assign=True)
    return jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_int8_kv_logits_match_jax(case):
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
    from scalellm_tpu_torch.engine.params import ModelInputs

    name, dtype, tol = MODEL_CASES[case]
    jmodel, params, tmodel = _int8_models(name, dtype)
    assert tmodel.kv_quant
    if name != "deepseek":
        np.testing.assert_array_equal(tmodel.kv_scales.numpy(), np.asarray(params["layers"]["kv_scales"]))

    @functools.partial(jax.jit, static_argnames="decode_only")
    def jax_step(p, kv, mi, decode_only):
        h, kv = jmodel.forward(p, kv, mi, decode_only=decode_only)
        return jmodel.logits(p, h), kv

    shape = jmodel.kv_cache_shape(16, PAGE)
    assert tuple(shape) == tmodel.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(shape, jnp.int8)
    tkv = torch.zeros(shape, dtype=torch.int8)
    for chunks, decode_only in STEPS:
        arrays = _inputs(chunks)
        want, jkv = jax_step(params, jkv, JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                             decode_only=decode_only)
        with torch.inference_mode():
            got = tmodel.logits(tmodel(tkv, ModelInputs(**arrays).to("cpu"), decode_only=decode_only))
        n = len(chunks)
        want = np.asarray(want, np.float32)[:n]
        got = got.float().numpy()[:n]
        if tol is None:  # bf16: as the zoo's bf16 paged steps
            from tests.test_torch_moe_models import TOL_BF16

            np.testing.assert_allclose(got, want, atol=TOL_BF16, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # The int8 pages of the real tokens (page 0 takes the padding rows).
    diff = np.abs(tkv[:, 1:].numpy().astype(np.int32) - np.asarray(jkv)[:, 1:].astype(np.int32))
    if tol is None:  # bf16 k and v an ulp apart (sums in another order) land across a .5 now and then
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2
    else:
        assert diff.max() == 0


# ------------------------------------------------------------------ LLM

PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps", "abc", "hello world, hello world"]


@pytest.fixture(scope="module")
def llama_with_sidecar(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("int8_kv_sidecar") / "model")
    shutil.copytree(tiny_llama(), d)
    with open(os.path.join(d, "kv_scales.json"), "w") as f:
        json.dump({"k": [0.021, 0.034], "v": [0.017, 0.026]}, f)
    return d


def _generate(llm_cls, sp_cls, path, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, kv_cache_dtype="int8", **kw)
    try:
        engine = llm._handler.engine if hasattr(llm._handler, "engine") else None
        sp = sp_cls(max_tokens=8, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, sp)], engine
    finally:
        llm.close()


@pytest.mark.parametrize("async_scheduling", [True, False])
def test_int8_kv_generate_with_a_sidecar_matches_jax(llama_with_sidecar, async_scheduling):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    want, _ = _generate(JaxLLM, JaxSamplingParams, llama_with_sidecar, enable_cuda_graph=False,
                        enable_async_scheduling=async_scheduling)
    got, engine = _generate(LLM, SamplingParams, llama_with_sidecar, devices="cpu",
                            enable_async_scheduling=async_scheduling)
    assert got == want and all(len(ids) == 8 for ids in got)
    assert engine.executor.kv_cache.dtype == torch.int8
    np.testing.assert_array_equal(engine.model.kv_scales.numpy(),
                                  np.array([[0.021, 0.017], [0.034, 0.026]], np.float32))
    # One byte an element: 2 layers x 2 x 2 KV heads x 16 dims a slot.
    assert engine.kv_cache_slot_size_in_bytes() == 2 * 2 * 2 * 16
