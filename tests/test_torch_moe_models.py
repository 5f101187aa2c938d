"""The port's DecoderModel families of the MoE slice (mixtral, qwen2_moe)
and the dense families that share its flags (qwen2: the qkv bias; mistral:
a sliding window on every layer) against transformers and the JAX package's
DecoderModel on the CPU. Tiny checkpoints are written by transformers with
the kwargs of tests/test_model_zoo.py:FAMILIES (float32, untrained, seed 0)
and shared between test processes; "mixtral_window" is the Mixtral one
with sliding_window=8, below the 10-token prompt.

- logits of one prefill against HF's and the JAX model's, float32,
  tolerance 1e-4 (f32 sums in another order through 2 layers, logits of
  magnitude < 1);
- the port's loader against convert_params of the JAX loader's tree,
  exactly;
- mixed and decode-only paged steps against the JAX model in bf16 (the
  f32 router on bf16 activations picks the same experts here): tolerance
  1e-2 on logits of magnitude < 1 (bf16 activations rounded at other
  points; largest difference measured 0.0026);
- runtime INT4/INT8 (quantize_model against the JAX package's
  quantize_model_params, exactly): int4 experts where G divides both
  widths (the trained Mixtral at hidden 128, FFN 256, G = 128), the int8
  fallback where it does not (Qwen2-MoE's expert width 48 at G = 32,
  Mixtral's 96 at G = 64), int8 everywhere at 8 bits; logits over mixed and
  decode-only steps with the port's float reference (variant="ref", what
  the JAX package computes on the CPU) within 1e-4 (measured 1.4e-6), and
  with the port's default dispatch (the plain versions of W4A8 / dequant
  and of K8 + K7: activations rounded to bf16 and quantized to int8 per
  k-block) within 1.5% of the largest |logit| of the JAX logits (measured
  0.69% on the trained Mixtral, whose logits reach 4.3; 0.3% on the
  others), every greedy token the same;
- a GPTQ qwen2 checkpoint (fused qkv bias; with desc_act the unfused
  biases) against the JAX model, float reference, 1e-4;
- flags this slice did not port still raise, and a GPTQ MoE checkpoint is
  refused."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.fixtures as fixtures
from tests.test_model_zoo import FAMILIES, PROMPT
from tests.test_torch_model import _inputs
from tests.torch_port_util import shared_checkpoint

TOL = 1e-4
TOL_BF16 = 1e-2
TOL_DISPATCH = 1.5e-2  # of the largest |logit|
PAGE = 4
CHECKPOINTS = {
    "mixtral": FAMILIES["mixtral"],
    "mixtral_window": (*FAMILIES["mixtral"][:2], dict(FAMILIES["mixtral"][2], sliding_window=8)),
    "qwen2_moe": FAMILIES["qwen2_moe"],
    "qwen2": FAMILIES["qwen2"],
    "mistral": FAMILIES["mistral"],
}
STEPS = [  # mixed prefill chunks, then decode-only steps
    ([(0, 0, [3, 17, 42, 9, 100, 7, 120]), (1, 0, [5, 6, 7, 8, 9])], False),
    ([(0, 7, [11]), (1, 5, [12, 13]), (2, 0, [1, 2, 3, 4, 60, 61, 62, 63, 64, 65])], False),
    ([(0, 8, [21]), (1, 7, [22]), (2, 10, [23])], True),
    ([(0, 9, [31]), (1, 8, [32]), (2, 11, [33])], True),
]


def checkpoint(name: str) -> str:
    """The tiny transformers checkpoint `name` of CHECKPOINTS, float32."""
    cfg_cls, model_cls, kwargs = CHECKPOINTS[name]

    def build(d):
        import transformers

        torch.manual_seed(0)
        model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kwargs))
        model.to(torch.float32).save_pretrained(d, safe_serialization=True)

    return shared_checkpoint(f"zoo_{name}_seed0_v1", build)


def trained_mixtral() -> str:
    """tests/fixtures.make_trained_tiny_mixtral at 60 steps (hidden 128, FFN
    256, 4 experts top-2, char tokenizer), shared with
    tests/test_torch_moe_generate.py."""
    return shared_checkpoint("trained_tiny_mixtral_s60_seed0",
                             lambda d: fixtures.make_trained_tiny_mixtral(d, steps=60))


def _jax_loaded(path, dtype):
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig

    loader = JaxLoader(path)
    loader.model_args.dtype = dtype
    model = JaxRegistry.get_causal_lm_factory(loader.model_type)(loader.model_args, ParallelConfig())
    return model, loader.load_params(model), loader.model_args


def _port_loaded(path, dtype):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    loader = HFModelLoader(path)
    loader.model_args.dtype = dtype
    factory = ModelRegistry.get_causal_lm_factory(loader.model_type)
    return loader, factory(loader.model_args, device="meta")


def _jax_step(jmodel):
    @functools.partial(jax.jit, static_argnames=("decode_only", "all_hidden"))
    def step(p, kv, mi, decode_only=False, all_hidden=False):
        out = jmodel.forward(p, kv, mi, all_hidden=all_hidden, decode_only=decode_only)
        return jmodel.logits(p, out[0]), out[1]

    return step


def _jax_inputs(arrays):
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs

    return JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_logits_match_hf_and_jax(name):
    import transformers

    from scalellm_tpu_torch.engine.params import ModelInputs

    path = checkpoint(name)
    hf = getattr(transformers, CHECKPOINTS[name][1]).from_pretrained(path, torch_dtype=torch.float32).eval()
    with torch.no_grad():
        want_hf = hf(torch.tensor([PROMPT])).logits[0].numpy()
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
    np.testing.assert_allclose(got, want_hf, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, np.asarray(want_jax)[: len(PROMPT)], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["mixtral", "qwen2_moe", "qwen2"])
def test_loader_matches_convert_params(name):
    from scalellm_tpu_torch.models.common import convert_params

    path = checkpoint(name)
    _, params, jargs = _jax_loaded(path, "float32")
    loader, model = _port_loaded(path, "float32")
    want = convert_params(params, loader.model_args)
    got = loader.load_state_dict(model, "cpu")
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == torch.float32 and torch.equal(t, want[key]), key
    a = loader.model_args
    if a.n_experts:
        assert got["layers.1.experts_gate"].shape == (a.n_experts, a.moe_intermediate_size, a.hidden_size)
        assert got["layers.1.router"].shape == (a.n_experts, a.hidden_size)
    if a.moe_shared_intermediate:
        assert got["layers.0.shared_gate"].shape == (1, a.hidden_size)
        assert got["layers.0.gate_up_proj"].shape == (2 * a.moe_shared_intermediate, a.hidden_size)
    if a.qkv_bias:
        assert got["layers.0.qkv_bias"].shape == ((a.n_heads + 2 * a.n_kv_heads) * a.head_dim,)


def _run_steps(jmodel, jparams, tmodel, variants=("",), dtype=torch.float32):
    """The JAX logits per step, and the port's for each quant variant."""
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.layers.moe import quant_expert_ffn
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

    shape = jmodel.kv_cache_shape(16, PAGE)
    assert tuple(shape) == tmodel.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(shape, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tkv = {v: torch.zeros(shape, dtype=dtype) for v in variants}
    step = _jax_step(jmodel)
    out = []
    for chunks, decode_only in STEPS:
        arrays = _inputs(chunks)
        want, jkv = step(jparams, jkv, _jax_inputs(arrays), decode_only=decode_only)
        got = {}
        for v in variants:
            tmodel.quant_impl = functools.partial(quant_matmul, variant=v)
            tmodel.qexperts_impl = functools.partial(quant_expert_ffn, variant=v)
            with torch.inference_mode():
                h = tmodel(tkv[v], ModelInputs(**arrays).to("cpu"), decode_only=decode_only)
                got[v] = tmodel.logits(h).float().numpy()
        out.append((len(chunks), np.asarray(want, np.float32), got))
    return out


@pytest.mark.parametrize("name", ["mixtral", "qwen2_moe", "qwen2"])
def test_paged_steps_match_jax_bf16(name):
    path = checkpoint(name)
    jmodel, params, _ = _jax_loaded(path, "bfloat16")
    loader, model = _port_loaded(path, "bfloat16")
    model = loader.load_model(model, "cpu")
    assert model.dtype == torch.bfloat16
    for n, want, got in _run_steps(jmodel, params, model, dtype=torch.bfloat16):
        np.testing.assert_allclose(got[""][:n], want[:n], atol=TOL_BF16, rtol=0)


# (checkpoint, bits, group size) -> the experts' (bits, group) by the rule.
QUANT_CASES = {
    "trained_mixtral-int4-g128": ("trained", 4, 128, (4, 128)),
    "mixtral-int4-g64": ("mixtral", 4, 64, (8, 0)),
    "qwen2_moe-int4-g32": ("qwen2_moe", 4, 32, (8, 0)),
    "qwen2_moe-int8-g32": ("qwen2_moe", 8, 32, (8, 0)),
}


@pytest.fixture(scope="module")
def quantized():
    """case -> (JAX model, its quantized params, their numpy tree, the
    port's quantize_model of the same dense checkpoint), built once."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        from scalellm_tpu.config import QuantArgs as JaxQuantArgs
        from scalellm_tpu.quantization.runtime import quantize_model_params
        from scalellm_tpu_torch.config import QuantArgs
        from scalellm_tpu_torch.quantization.runtime import quantize_model

        name, bits, G, _ = QUANT_CASES[case]
        path = trained_mixtral() if name == "trained" else checkpoint(name)
        jdense, jparams, _ = _jax_loaded(path, "float32")
        jparams = jax.tree_util.tree_map(np.asarray, jparams)
        jmodel, jq = quantize_model_params(jdense, jparams, JaxQuantArgs(quant_method="internal", bits=bits,
                                                                         group_size=G))
        loader, dense = _port_loaded(path, "float32")
        qmodel = quantize_model(loader.load_model(dense, "cpu"),
                                QuantArgs(quant_method="internal", bits=bits, group_size=G))
        cache[case] = (jmodel, jax.tree_util.tree_map(jnp.asarray, jq), jq, qmodel)
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_runtime_quant_matches_jax(case, quantized, monkeypatch):
    from scalellm_tpu_torch.models.common import QuantExperts, QuantLinear, convert_params
    from scalellm_tpu_torch.ops import moe_quant as TQ

    jmodel, jparams, jq, qmodel = quantized(case)
    want_sd = convert_params(jq, qmodel.args)
    got_sd = qmodel.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for key, t in got_sd.items():
        assert t.dtype == want_sd[key].dtype and torch.equal(t, want_sd[key]), key
    layer = qmodel.layers[0]
    assert isinstance(layer.experts_gate, QuantExperts) and isinstance(layer.qkv_proj, QuantLinear)
    assert (layer.experts_gate.bits, layer.experts_gate.group_size) == QUANT_CASES[case][3]
    assert layer.router.dtype == torch.float32

    pairs = []  # the plain K8 calls of the default dispatch
    real = TQ.plain_grouped_quant_matmul_pair
    monkeypatch.setattr(TQ, "plain_grouped_quant_matmul_pair", lambda *a: pairs.append(1) or real(*a))
    for n, want, got in _run_steps(jmodel, jparams, qmodel, ("ref", "")):
        np.testing.assert_allclose(got["ref"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[""], want, atol=TOL_DISPATCH * np.abs(want).max(), rtol=0)
        assert (got[""][:n].argmax(-1) == want[:n].argmax(-1)).all()
    # Decode-sized steps (at most 16 tokens x top-2 rows): K8 once a layer.
    assert len(pairs) == qmodel.args.n_layers * len(STEPS)


@pytest.mark.parametrize("desc_act", [False, True])
def test_gptq_qwen2_with_qkv_bias_matches_jax(desc_act, tmp_path):
    """A GPTQ qwen2 checkpoint (group 32): the fused qkv bias, and under
    desc_act the unfused q/k/v biases beside row-permuted projections,
    against the JAX model with the port's float reference forced."""
    from tests.torch_port_util import quantize_checkpoint

    path = quantize_checkpoint(checkpoint("qwen2"), str(tmp_path / "gptq"), "gptq", group=32, desc_act=desc_act)
    jmodel, params, _ = _jax_loaded(path, "float32")
    loader, model = _port_loaded(path, "float32")
    model = loader.load_model(model, "cpu")
    layer = model.layers[0]
    assert hasattr(layer, "q_bias") == desc_act and hasattr(layer, "qkv_bias") == (not desc_act)
    for _, want, got in _run_steps(jmodel, params, model, ("ref",)):
        np.testing.assert_allclose(got["ref"], want, atol=TOL, rtol=TOL)


def test_unported_flags_still_raise():
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.models.common import DecoderModel

    base = dict(model_type="gpt2", dtype="float32", hidden_size=64, intermediate_size=96, n_layers=1,
                n_heads=4, n_kv_heads=2, vocab_size=128)
    for flags, word in ((dict(kv_lora_rank=16), "MLA"),):
        with pytest.raises(NotImplementedError, match=word):
            DecoderModel(ModelArgs(**base, **flags), device="meta")
    # The int8 KV cache is ported: per-layer [k_scale, v_scale].
    assert DecoderModel(ModelArgs(**base, kv_cache_dtype="int8"), device="meta").kv_scales.shape == (1, 2)
    # What the MoE slice, the Gemma / Qwen slice and the GPT-2 / Phi / MPT /
    # BLOOM slice ported builds.
    DecoderModel(ModelArgs(**base, qkv_bias=True, n_experts=4, n_experts_per_token=2,
                           moe_intermediate_size=32, moe_shared_intermediate=48), device="meta")
    model = DecoderModel(ModelArgs(**base, use_qk_norm=True, residual_post_layernorm=True), device="meta")
    assert model.layers[0].q_norm.shape == (16,) and model.layers[0].post_ffw_norm.shape == (64,)
    model = DecoderModel(ModelArgs(**base, norm_type="layer_norm", norm_bias=True, pos_embedding_type="learned",
                                   o_proj_bias=True, mlp_bias=True, mlp_gated=False, parallel_residual=True,
                                   embedding_norm=True, qkv_clip=8.0, lm_head_bias=True), device="meta")
    layer = model.layers[0]
    assert layer.up_proj.shape == (96, 64) and layer.up_bias.shape == (96,) and layer.down_bias.shape == (64,)
    assert not hasattr(layer, "post_norm") and layer.input_norm_bias.shape == (64,)
    assert model.embed_positions.shape == (4096, 64) and model.lm_head_bias.shape == (128,)
    alibi = DecoderModel(ModelArgs(**base, pos_embedding_type="alibi"), device="meta")
    assert alibi.alibi_slopes.dtype == torch.float32 and not hasattr(alibi, "rope_inv_freq")


def test_a_gptq_moe_checkpoint_is_refused(tmp_path):
    import shutil

    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    d = str(tmp_path / "gptq")
    shutil.copytree(checkpoint("mixtral"), d)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["quantization_config"] = {"quant_method": "gptq", "bits": 4, "group_size": 32, "sym": True}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    loader = HFModelLoader(d)
    with pytest.raises(NotImplementedError, match="gptq MoE checkpoints are not supported"):
        ModelRegistry.get_causal_lm_factory("mixtral")(loader.model_args, device="meta")
