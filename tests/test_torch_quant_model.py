"""The INT4/INT8 slice as a whole against the JAX package on tiny Llamas:
GPTQ, AWQ (real zero points) and GPTQ desc_act checkpoints, and runtime
int4/int8 quantization with an int8 or int4 lm_head.

On the CPU the JAX package computes a quantized projection with its float
reference (ref_quant_matmul: float activations), while the port's default
dispatch runs the plain version of the kernel the card would run (W4A8:
int8 activations; dequant: bf16-rounded weights). So each comparison names
its numerics:

- variant "ref" forced on the port: logits and KV cache within 1e-4 of the
  JAX model's (two layers of f32 matmuls summed in another order), and equal
  greedy tokens from LLM.generate;
- the default dispatch: logits within 0.02 of the JAX model's float logits
  (std 0.15-0.22). That covers activations rounded to bf16 and quantized to
  int8 per (row, k-block), about 0.4% of each row's largest activation, over
  two layers (largest difference measured: 0.0085), and the greedy token of
  every sequence must still agree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
from scalellm_tpu_torch.engine.params import ModelInputs
from scalellm_tpu_torch.models.common import QuantLinear
from scalellm_tpu_torch.ops import quant_matmul as TQ
from tests.test_torch_model import PAGE, _inputs
from tests.test_torch_quantization import CHECKPOINTS, _jax_params, _torch_state
from tests.torch_port_util import generate_within, quantize_checkpoint, tiny_llama, trained_tiny_llama

TOL_REF = 1e-4
TOL_DISPATCH = 0.02

# name: (quantize, quantize_lm_head), on the hidden-128 fixture (G = 128).
RUNTIME = {
    "int4": ("int4", False),
    "int8_lm_head_int8": ("int8", True),
    "int4_lm_head_int4": ("int4", "int4"),
}


@pytest.fixture(scope="module")
def dense_dirs():
    return {h: tiny_llama(h) for h in (64, 128)}


@pytest.fixture(scope="module")
def model_dir(dense_dirs, tmp_path_factory):
    """name -> (checkpoint dir, quantize, quantize_lm_head), made on demand."""
    root = tmp_path_factory.mktemp("quant_model_ckpt")
    made = {}

    def get(name):
        if name in RUNTIME:
            return (dense_dirs[128],) + RUNTIME[name]
        if name not in made:
            hidden, fmt, group, desc_act, lm_head = CHECKPOINTS[name]
            made[name] = (quantize_checkpoint(dense_dirs[hidden], str(root / name), fmt,
                                              group=group, desc_act=desc_act), "", lm_head)
        return made[name]

    return get


def _steps():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (8, 10, 5)]
    # Step 0 prefills A and B's first chunk; step 1 mixes A's decode, B's
    # second chunk and C's prefill; steps 2-3 decode.
    return [
        [(0, 0, prompts[0][:7]), (1, 0, prompts[1][:5])],
        [(0, 7, prompts[0][7:]), (1, 5, prompts[1][5:9]), (2, 0, prompts[2][:3])],
        [(0, 8, [11]), (1, 9, prompts[1][9:]), (2, 3, prompts[2][3:4])],
        [(0, 9, [12]), (1, 10, [13]), (2, 4, prompts[2][4:])],
    ]


@pytest.mark.parametrize("name", list(CHECKPOINTS) + list(RUNTIME))
def test_logits_match_jax_over_steps(name, model_dir):
    path, quantize, lm_head = model_dir(name)
    jmodel, params = _jax_params(path, quantize=quantize, lm_head=lm_head)
    tmodel, _ = _torch_state(path, quantize=quantize, lm_head=lm_head)
    assert isinstance(tmodel.layers[0].o_proj, QuantLinear)

    @jax.jit
    def jax_step(p, kv, mi):
        h, kv = jmodel.forward(p, kv, mi)
        return jmodel.logits(p, h), kv

    kv_shape = jmodel.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(kv_shape, jnp.float32)
    tkv = {v: torch.zeros(kv_shape) for v in ("ref", "")}
    for chunks in _steps():
        arrays = _inputs(chunks)
        want, jkv = jax_step(params, jkv, JaxModelInputs(
            **{k: jnp.asarray(v) for k, v in arrays.items()}))
        want = np.asarray(want)
        for variant, tol in (("ref", TOL_REF), ("", TOL_DISPATCH)):
            tmodel.quant_impl = functools.partial(TQ.quant_matmul, variant=variant)
            with torch.inference_mode():
                got = tmodel.logits(tmodel(tkv[variant], ModelInputs(**arrays).to("cpu"))).numpy()
            np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=repr(variant))
            n = len(chunks)
            assert (got[:n].argmax(-1) == want[:n].argmax(-1)).all(), variant
    np.testing.assert_allclose(tkv["ref"].numpy(), np.asarray(jkv), atol=TOL_REF, rtol=0)


def test_default_dispatch_runs_the_kernels_plain_versions(model_dir, monkeypatch):
    """At T = 16 a G = 128 model's projections run W4A8 (with the norm fused
    where the k-block spans K) and a G = 32 model's run dequant."""
    seen = []
    real = TQ.plan

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(TQ, "plan", spy)
    for name, variant in (("awq_g128", "w4a8"), ("gptq_g32", "dequant")):
        path, quantize, lm_head = model_dir(name)
        tmodel, _ = _torch_state(path)
        seen.clear()
        with torch.inference_mode():
            tmodel(torch.zeros(tmodel.kv_cache_shape(16, PAGE)),
                   ModelInputs(**_inputs(_steps()[0])).to("cpu"))
        assert len(seen) == 4 * tmodel.args.n_layers
        assert {v for v, _, _ in seen} == {variant}
        # qkv and gate_up get the un-normed input and fuse the norm.
        assert [fuse for _, _, fuse in seen[:4]] == [True, False, True, False]


PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps", "abc"]


def _generate(llm_cls, sp_cls, path, variant=None, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        if variant is not None:
            llm._handler.engine.model.quant_impl = functools.partial(TQ.quant_matmul, variant=variant)
        sp = sp_cls(max_tokens=6, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, sp)]
    finally:
        llm.close()


@pytest.mark.parametrize("name", ["gptq_desc_act", "awq_g128", "int4_lm_head_int4"])
def test_greedy_tokens_match_jax(name, model_dir):
    """LLM.generate, chunked prefill and prefix cache on. The port with the
    float reference forced must give the JAX package's tokens."""
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    path, quantize, lm_head = model_dir(name)
    opts = dict(quantize=quantize, quantize_lm_head=lm_head)
    want = _generate(JaxLLM, JaxSamplingParams, path, enable_cuda_graph=False, **opts)
    got = _generate(LLM, SamplingParams, path, variant="ref", devices="cpu", **opts)
    assert got == want
    assert all(len(t) == 6 for t in got)


TRAINED_OPTS = dict(quantize="int4", quantize_lm_head=True)


@pytest.fixture(scope="module")
def trained_jax_tokens():
    """The char-level model trained on tests/data/corpus.txt, runtime int4
    with an int8 lm_head, and the JAX package's greedy tokens on it (its
    engine built once for the file)."""
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams

    path = trained_tiny_llama()
    return path, _generate(JaxLLM, JaxSamplingParams, path, enable_cuda_graph=False, **TRAINED_OPTS)


def test_default_dispatch_greedy_tokens_match_jax_on_the_trained_model(trained_jax_tokens):
    """The random fixtures' logits are too flat for greedy tokens to survive
    int8 activations (their top-two margins are below TOL_DISPATCH); the
    char-level model trained on tests/data/corpus.txt has real margins. With
    runtime int4 and an int8 lm_head (G = 128: every projection W4A8), the
    port's default dispatch gives the JAX package's tokens."""
    from scalellm_tpu_torch import LLM, SamplingParams

    path, want = trained_jax_tokens
    got = _generate(LLM, SamplingParams, path, devices="cpu", **TRAINED_OPTS)
    assert got == want


@pytest.mark.parametrize("variant", ["gemv", "w4a8g"])
def test_small_m_variants_greedy_tokens_match_jax_on_the_trained_model(variant, trained_jax_tokens):
    """The same run with the small-M variants set on the model's quantized
    matmul, as the reference's QUANT_VARIANT selects them (every decode
    step through the variant, prefill chunks of 16 tokens too): the JAX
    package's tokens."""
    from scalellm_tpu_torch import LLM, SamplingParams

    path, want = trained_jax_tokens
    got = _generate(LLM, SamplingParams, path, variant=variant, devices="cpu", **TRAINED_OPTS)
    assert got == want
