"""The port's DecoderModel families of the GPT-2 / Phi / MPT / BLOOM slice
against transformers and the JAX package's DecoderModel on the CPU, with the
ALiBi slopes and the plain ragged paged attention (ALiBi, head dim 80, f32)
against the JAX package's, and the f32 products of the dense projections.
Tiny checkpoints of gpt2, phi (partial rotary 0.5), mpt (ALiBi, clip_qkv 6,
no biases) and bloom (ALiBi, the embedding LayerNorm) are written by
transformers with the kwargs of tests/test_model_zoo.py:FAMILIES (float32,
untrained, seed 0) and shared between test processes.

- logits of one prefill against HF's and the JAX model's, float32,
  tolerance 1e-4 (f32 sums in another order through 2 layers, logits of
  magnitude < 1.5; measured 2.4e-7);
- the port's loader (GPT-2's Conv1D weights transposed, BLOOM's per-head
  query_key_value reordered) against convert_params of the JAX loader's
  tree, exactly;
- mixed and decode-only paged steps against the JAX model in bf16:
  tolerance 1e-2 on logits of magnitude < 1.5 (bf16 activations rounded at
  other points); GPT-2 also in float32, 1e-4;
- runtime INT4/INT8 of phi and mpt (quantize_model against the JAX
  package's quantize_model_params, exactly, the biases kept; G = 32), logits
  with the port's float reference (variant="ref") within 1e-4, and with the
  default dispatch within 1.5% of the largest |logit|, every greedy token
  the same;
- LLM.generate on the CPU against scalellm_tpu.LLM for bloom, phi and gpt2
  (the char tokenizer beside the checkpoint), and for mpt and gpt2 with
  num_decode_steps=4, the same greedy ids;
- alibi_slopes against the JAX package's for every head count 1-128,
  exactly;
- the plain ragged paged attention with ALiBi (GQA groups 1 and 4, head
  counts 12 and 20), at head dim 80 and in f32 against the JAX package's
  ref_ragged_paged_attention, 1e-5;
- the f32 product of a dense projection, as the reference keeps it
  (preferred_element_type=float32): a dense lm_head's logits of magnitude
  4-8 against the JAX model's within 1e-5 of their size (a bf16 rounding
  is up to 2e-3 of it), and a qwen2 layer's qkv after its bias and the
  activation's f32 inputs against the JAX package's _proj on the same
  input within 1e-6 of their largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_zoo import FAMILIES, PROMPT
from tests.test_torch_model import _inputs
from tests.test_torch_moe_models import (
    PAGE,
    TOL,
    TOL_BF16,
    TOL_DISPATCH,
    _jax_inputs,
    _jax_loaded,
    _jax_step,
    _port_loaded,
    _run_steps,
)
from tests.test_torch_moe_models import checkpoint as moe_slice_checkpoint
from tests.torch_port_util import generate_within, ragged_batch, shared_checkpoint

FAMILY_NAMES = ("gpt2", "phi", "mpt", "bloom")


def checkpoint(name: str) -> str:
    cfg_cls, model_cls, kwargs = FAMILIES[name]

    def build(d):
        import transformers

        torch.manual_seed(0)
        model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kwargs))
        model.to(torch.float32).save_pretrained(d, safe_serialization=True)

    return shared_checkpoint(f"zoo_{name}_seed0_v1", build)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_logits_match_hf_and_jax(name):
    import transformers

    from scalellm_tpu_torch.engine.params import ModelInputs

    path = checkpoint(name)
    jmodel, params, _ = _jax_loaded(path, "float32")
    loader, model = _port_loaded(path, "float32")
    model = loader.load_model(model, "cpu")
    arrays = _inputs([(0, 0, PROMPT)], S=1, T=16)
    n_pages = 1 + 4
    want_jax, _ = _jax_step(jmodel)(params, jnp.zeros(jmodel.kv_cache_shape(n_pages, PAGE), jnp.float32),
                                    _jax_inputs(arrays), all_hidden=True)
    with torch.inference_mode():
        kv = torch.zeros(model.kv_cache_shape(n_pages, PAGE))
        got = model.logits(model(kv, ModelInputs(**arrays).to("cpu"), all_hidden=True))[: len(PROMPT)].numpy()
    np.testing.assert_allclose(got, np.asarray(want_jax)[: len(PROMPT)], atol=TOL, rtol=TOL)
    hf = getattr(transformers, FAMILIES[name][1]).from_pretrained(path, torch_dtype=torch.float32).eval()
    with torch.no_grad():
        want_hf = hf(torch.tensor([PROMPT])).logits[0].numpy()
    np.testing.assert_allclose(got, want_hf, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_loader_matches_convert_params(name):
    from scalellm_tpu_torch.models.common import convert_params

    path = checkpoint(name)
    _, params, _ = _jax_loaded(path, "float32")
    loader, model = _port_loaded(path, "float32")
    a = loader.model_args
    want = convert_params(params, a)
    got = loader.load_state_dict(model, "cpu")
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[key]), key
    assert ("embed_positions" in got) == (name == "gpt2")
    assert ("embed_norm_bias" in got) == (name == "bloom")
    assert ("lm_head_bias" in got) == (name == "phi")
    assert ("layers.0.post_norm" in got) == (name != "phi")  # Phi's parallel residual
    assert ("layers.0.input_norm_bias" in got) == (name != "mpt")  # MPT's no_bias
    assert got["layers.0.up_proj"].shape == (a.intermediate_size, a.hidden_size)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_paged_steps_match_jax_bf16(name):
    path = checkpoint(name)
    jmodel, params, _ = _jax_loaded(path, "bfloat16")
    loader, model = _port_loaded(path, "bfloat16")
    model = loader.load_model(model, "cpu")
    assert model.dtype == torch.bfloat16
    for n, want, got in _run_steps(jmodel, params, model, dtype=torch.bfloat16):
        np.testing.assert_allclose(got[""][:n], want[:n], atol=TOL_BF16, rtol=0)


def test_paged_steps_match_jax_f32_gpt2():
    """GPT-2's checkpoints are float32, and the model runs in float32 (the
    reference's dtype rule): the KV cache, the attention and the logits."""
    path = checkpoint("gpt2")
    jmodel, params, _ = _jax_loaded(path, "float32")
    loader, model = _port_loaded(path, "float32")
    model = loader.load_model(model, "cpu")
    assert model.dtype == torch.float32 and loader.model_args.dtype == "float32"
    for n, want, got in _run_steps(jmodel, params, model, dtype=torch.float32):
        np.testing.assert_allclose(got[""][:n], want[:n], atol=TOL, rtol=TOL)


QUANT_CASES = {"phi-int4-g32": ("phi", 4), "phi-int8-g32": ("phi", 8),
               "mpt-int4-g32": ("mpt", 4), "mpt-int8-g32": ("mpt", 8)}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_runtime_quant_matches_jax(case):
    from scalellm_tpu.config import QuantArgs as JaxQuantArgs
    from scalellm_tpu.quantization.runtime import quantize_model_params
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.models.common import QuantLinear, convert_params
    from scalellm_tpu_torch.quantization.runtime import quantize_model

    name, bits = QUANT_CASES[case]
    path = checkpoint(name)
    jdense, jparams, _ = _jax_loaded(path, "float32")
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    jmodel, jq = quantize_model_params(jdense, jparams, JaxQuantArgs(quant_method="internal", bits=bits,
                                                                     group_size=32))
    loader, dense = _port_loaded(path, "float32")
    qmodel = quantize_model(loader.load_model(dense, "cpu"), QuantArgs(quant_method="internal", bits=bits,
                                                                       group_size=32))
    want_sd = convert_params(jq, qmodel.args)
    got_sd = qmodel.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, t in got_sd.items():
        assert t.dtype == want_sd[key].dtype and torch.equal(t, want_sd[key]), key
    layer = qmodel.layers[0]
    assert isinstance(layer.qkv_proj, QuantLinear) and isinstance(layer.up_proj, QuantLinear)
    assert layer.qkv_proj.bits == bits
    if name == "phi":  # the biases stay dense
        assert layer.up_bias.shape == (qmodel.args.intermediate_size,) and "lm_head_bias" in got_sd
    else:  # ALiBi's slopes ride over to the quantized model
        assert torch.equal(qmodel.alibi_slopes, dense.alibi_slopes)
    for n, want, got in _run_steps(jmodel, jax.tree_util.tree_map(jnp.asarray, jq), qmodel, ("ref", "")):
        np.testing.assert_allclose(got["ref"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[""], want, atol=TOL_DISPATCH * np.abs(want).max(), rtol=0)
        assert (got[""][:n].argmax(-1) == want[:n].argmax(-1)).all()


def _with_tokenizer(name: str) -> str:
    """The family's checkpoint with the char tokenizer beside it (ids are
    ord(char); the prompts are ASCII, below the vocabulary of 128)."""
    import shutil

    import tests.fixtures as fixtures

    def build(d):
        shutil.copytree(checkpoint(name), d)
        fixtures.save_char_tokenizer(d)

    return shared_checkpoint(f"zoo_{name}_seed0_v1_tok", build)


GENERATE_PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps", "abc"]


def _generate(llm_cls, sp_cls, path, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        sp = sp_cls(max_tokens=6, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].token_ids for o in generate_within(llm, GENERATE_PROMPTS, sp)]
    finally:
        llm.close()


@pytest.mark.parametrize("name,steps", [("bloom", 1), ("phi", 1), ("gpt2", 1), ("mpt", 4), ("gpt2", 4)])
def test_generate_matches_jax(name, steps):
    """The defaults (async scheduling; graphs, which run eagerly on the
    CPU), and num_decode_steps=4 for mpt and gpt2, against the JAX
    package's LLM with the same options."""
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    path = _with_tokenizer(name)
    want = _generate(JaxLLM, JaxSamplingParams, path, enable_cuda_graph=False, num_decode_steps=steps)
    before = COUNTERS.get("num_multi_steps")
    got = _generate(LLM, SamplingParams, path, devices="cpu", num_decode_steps=steps)
    assert all(len(ids) == 6 for ids in want)
    assert got == want
    assert (COUNTERS.get("num_multi_steps") > before) == (steps > 1)


def test_alibi_slopes_match_jax():
    from scalellm_tpu.layers.alibi import alibi_slopes as jax_slopes
    from scalellm_tpu_torch.layers.alibi import alibi_slopes

    for n in range(1, 129):
        assert alibi_slopes(n) == jax_slopes(n), n


# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window, soft_cap, alibi)
ATTENTION_CASES = {
    "decode_alibi_group1_h12": ([1, 1, 1], [9, 30, 17], 4, 4, 12, 12, 64, None, None, True),
    "mixed_alibi_group4_h20_window_softcap": ([6, 4, 1, 1], [6, 11, 9, 14], 8, 16, 20, 5, 64, 5, 30.0, True),
    "mixed_d80_group2": ([6, 4, 1, 1], [6, 11, 9, 14], 8, 16, 8, 4, 80, None, None, False),
    "mixed_d80_alibi_h12": ([5, 1, 3], [5, 20, 12], 4, 16, 12, 12, 80, None, None, True),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_plain_attention_with_alibi_at_head_dim_80_in_f32_matches_jax(case):
    from scalellm_tpu.layers.alibi import alibi_slopes as jax_slopes
    from scalellm_tpu.ops.attention_ref import ref_ragged_paged_attention as jax_ref
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, alibi = ATTENTION_CASES[case]
    inputs = ragged_batch(np.random.default_rng(13), q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H,
                          n_kv_heads=Hkv, head_dim=D)
    args = [inputs[k] for k in ("q", "kv_pages", "kv_lens", "page_indices", "cu_q_lens", "num_seqs")]
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)
    slopes = np.asarray(jax_slopes(H), np.float32) if alibi else None
    want = np.asarray(jax_ref(*[jnp.asarray(a) for a in args], **kw,
                              **({"alibi_slopes": jnp.asarray(slopes)} if alibi else {})))
    got = ragged_paged_attention(*[torch.from_numpy(a) for a in args], **kw,
                                 **({"alibi_slopes": torch.from_numpy(slopes)} if alibi else {}))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.all(got.numpy()[sum(q_lens):] == 0.0)


def test_f32_kernel_ctypes_signature_matches_the_cuda_source():
    """The f32 kernel's argtypes follow its C entry point's parameter list in
    csrc/ragged_paged_attention_f32.cu, so no argument is passed with another
    type or width."""
    import ctypes
    import pathlib
    import re

    from scalellm_tpu_torch.ops import _build, attention

    assert _build.SOURCES["ragged_paged_attention_f32"] == "ragged_paged_attention_f32.cu"
    src = (pathlib.Path(attention.__file__).parent.parent / "csrc" / "ragged_paged_attention_f32.cu").read_text()
    params = re.search(r'extern "C" int scalellm_ragged_paged_attention_f32\((.*?)\)\s*\{', src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    want = []
    for p in params.split(","):
        words = p.replace("*", " * ").split()[:-1]  # drop the parameter name
        want.append(kinds["void*" if "*" in words else words[-1]])
    assert attention._F32_ARGTYPES == want


def test_quant_rules_keep_a_layout_transform_only_outside_the_projections():
    """A weight rule's layout transform (GPT-2's transpose, BLOOM's reorder)
    rides through build_quant_rules on the rules it passes through, and is
    dropped where a projection's .weight becomes qweight / qzeros / scales:
    the checkpoint's qweight is [K/8, N] whatever the dense layout."""
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.models.gpt2 import GPT2_WEIGHT_RULES, _conv1d
    from scalellm_tpu_torch.quantization.linear import build_quant_rules

    rules = build_quant_rules(GPT2_WEIGHT_RULES, QuantArgs(quant_method="gptq", bits=4, group_size=32))
    by_target = {target: fn for _, target, fn in rules}
    assert by_target["layers.{}.qkv_proj"] is _conv1d  # not a PROJ_NAMES target: passes through
    assert by_target["layers.{}.qkv_bias"] is None and by_target["final_norm_bias"] is None
    assert "layers.{}.o_proj" not in by_target and by_target["layers.{}.o_proj.qweight"] is not _conv1d
    assert all(fn is not _conv1d for target, fn in by_target.items() if target.endswith((".qweight", ".scales")))


def test_dense_lm_head_logits_keep_the_f32_product():
    """Logits of a dense (untied) lm_head in bf16, at |logit| in [4, 8),
    against the JAX model's, which takes the f32 product of the bf16
    operands: within 1e-5 of their size (rounding them to bf16 first would
    be off by up to 2e-3 of it)."""
    path = moe_slice_checkpoint("qwen2")
    jmodel, params, _ = _jax_loaded(path, "bfloat16")
    loader, model = _port_loaded(path, "bfloat16")
    model = loader.load_model(model, "cpu")
    assert not model.args.tie_word_embeddings
    hidden = (np.random.default_rng(21).standard_normal((16, model.args.hidden_size)) * 40).astype(np.float32)
    hb = torch.from_numpy(hidden).to(torch.bfloat16)
    want = np.asarray(jmodel.logits(params, jnp.asarray(hb.float().numpy()).astype(jnp.bfloat16)), np.float32)
    with torch.inference_mode():
        got = model.logits(hb).numpy()
    band = (np.abs(want) >= 4) & (np.abs(want) < 8)
    assert band.sum() > 100
    np.testing.assert_allclose(got[band], want[band], rtol=1e-5, atol=0)


def test_qkv_bias_and_activation_inputs_keep_the_f32_product(monkeypatch):
    """A qwen2 layer in bf16 (the qkv bias, the gated MLP): q, k and v after
    the bias and before their cast, and the gate and up inputs of the
    activation, against the JAX package's _proj (the f32 product) plus the
    bias on the same input, within 1e-6 of their largest magnitude (a bf16
    product is off by up to 4e-3 of it)."""
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.models import common

    path = moe_slice_checkpoint("qwen2")
    jmodel, params, _ = _jax_loaded(path, "bfloat16")
    loader, model = _port_loaded(path, "bfloat16")
    model = loader.load_model(model, "cpu")
    layer, jl = model.layers[0], params["layers"]
    calls, acts = [], []
    real_proj, real_act = model._proj, common.act_with_mul
    model._proj = lambda x, w, *a, **kw: calls.append((x, w, real_proj(x, w, *a, **kw))) or calls[-1][2]
    monkeypatch.setattr(common, "act_with_mul", lambda name, g, u: acts.append((g, u)) or real_act(name, g, u))
    arrays = _inputs([(0, 0, PROMPT)], S=1, T=16)
    with torch.inference_mode():
        model(torch.zeros(model.kv_cache_shape(5, PAGE), dtype=torch.bfloat16), ModelInputs(**arrays).to("cpu"))

    def close(got, want):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)

    def jax_proj(x, name):
        return jmodel._proj(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jl[name][0])

    x, _, qkv = next(c for c in calls if c[1] is layer.qkv_proj)
    close(qkv.float() + layer.qkv_bias.float(), jax_proj(x, "qkv_proj") + jl["qkv_bias"][0].astype(jnp.float32))
    x, _, _ = next(c for c in calls if c[1] is layer.gate_up_proj)
    g, u = acts[0]
    F_ = model.args.intermediate_size
    want = jax_proj(x, "gate_up_proj")
    close(g, want[:, :F_])
    close(u, want[:, F_:])
