"""The port's runtime-quantized DeepSeek-V2 (INT4/INT8 routed experts and
projections) against the JAX package's MLADecoderModel on the CPU, on an
untrained tiny deepseek_v2 checkpoint written by transformers (float32, 3
layers: one dense, two MoE with 4 routed experts, top-2, and two shared
ones; hidden 256). At these widths pick_group quantizes the projections
whose input is the hidden width (q_proj, the dense and shared gate/up, the
lm_head: K = 256, G = 32) and leaves o_proj (K = 64), kv_a (width 24), the
dense down (K = 96) and the shared down (K = 64) in float; the int4 experts
take G = 32 (down: one group of 32).

- quantize_model's state_dict equals convert_params of the JAX package's
  quantize_model_params tree, exactly;
- logits over a mixed step and the decode-only steps after it, with the
  port's float reference forced (variant="ref" on the projections and the
  experts; the JAX package computes its float reference on the CPU):
  tolerance 1e-4 (f32 sums in another order through 3 layers, logits std
  about 0.3; largest difference measured 7e-7). With the port's default
  dispatch (the kernels' plain versions: W4A8/dequant projections, K8 + K7
  experts on these decode-sized steps) the logits stay within 0.02 of the
  float reference's (activations rounded to bf16 and quantized to int8 per
  k-block; largest difference measured 0.005) and every greedy token
  agrees;
- a T=1 step against the JAX model with MOE_DISPATCH_T1=force (its
  sort-free layout), and the port's T=1 layout against its own sorted
  dispatch (2e-5, the reference's own bound for that pair);
- LLM.generate(quantize="int4") greedy tokens equal scalellm_tpu.LLM's;
- a GPTQ DeepSeek checkpoint is refused with a clear error."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.fixtures as fixtures
from tests.test_torch_model import _inputs
from tests.torch_port_util import generate_within

TOL_REF = 1e-4
TOL_DISPATCH = 0.02
PAGE = 4
HF_KW = dict(vocab_size=256, hidden_size=256, intermediate_size=96, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
             q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, first_k_dense_replace=1, n_routed_experts=4, num_experts_per_tok=2,
             moe_intermediate_size=32, n_shared_experts=2, topk_method="greedy",
             routed_scaling_factor=1.0, tie_word_embeddings=False)
PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    d = str(tmp_path_factory.mktemp("tiny_deepseek_quant"))
    torch.manual_seed(1)
    DeepseekV2ForCausalLM(DeepseekV2Config(**HF_KW)).to(torch.float32).save_pretrained(
        d, safe_serialization=True)
    fixtures.save_char_tokenizer(d)
    return d


@pytest.fixture(scope="module")
def quantized(ckpt):
    """bits -> (JAX model, its quantized params as jnp and as numpy arrays,
    the port's quantize_model of the same dense checkpoint)."""
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu.config import QuantArgs as JaxQuantArgs
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig
    from scalellm_tpu.quantization.runtime import quantize_model_params
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.quantization.runtime import quantize_model

    jloader = JaxLoader(ckpt)
    jdense = JaxRegistry.get_causal_lm_factory("deepseek_v2")(jloader.model_args, ParallelConfig())
    jparams = jax.tree_util.tree_map(np.asarray, jloader.load_params(jdense))
    loader = HFModelLoader(ckpt)
    dense = loader.load_model(
        ModelRegistry.get_causal_lm_factory("deepseek_v2")(loader.model_args, device="meta"), "cpu")
    out = {}
    for bits in (4, 8):
        jmodel, jq = quantize_model_params(
            jdense, jparams, JaxQuantArgs(quant_method="internal", bits=bits, group_size=128))
        qmodel = quantize_model(dense, QuantArgs(quant_method="internal", bits=bits, group_size=128))
        out[bits] = (jmodel, jax.tree_util.tree_map(jnp.asarray, jq), jq, qmodel)
    return out


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_model_matches_jax_quantize_model_params(bits, quantized):
    from scalellm_tpu_torch.models.common import QuantExperts, QuantLinear
    from scalellm_tpu_torch.models.deepseek import convert_params

    _, _, jq, qmodel = quantized[bits]
    want = convert_params(jq, qmodel.args)
    got = qmodel.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
    # What pick_group decided at these widths.
    dense, moe = qmodel.layers[0], qmodel.layers[1]
    quant = {n for n, m in qmodel.named_modules() if isinstance(m, QuantLinear)}
    assert quant == {"lm_head", "layers.0.q_proj", "layers.0.gate_up_proj", "layers.1.q_proj",
                     "layers.1.shared_experts.gate_up_proj", "layers.2.q_proj",
                     "layers.2.shared_experts.gate_up_proj"}
    assert isinstance(moe.experts_down, QuantExperts) and qmodel.lm_head.bits == bits
    assert dense.down_proj.dtype == torch.float32 and moe.o_proj.dtype == torch.float32
    if bits == 4:
        assert moe.experts_gate.qweight.shape == (4, 32, 128)  # [E, N, K/2]
        assert moe.experts_down.scales.shape == (4, 1, 256)  # [E, K/G, N], G = 32
        assert qmodel.layers[0].q_proj.group_size == 32
    else:
        assert moe.experts_gate.qweight.shape == (4, 32, 256) and moe.experts_gate.scales.dtype == torch.float32


STEPS = [  # mixed prefill chunks, then decode-only steps
    ([(0, 0, [3, 17, 42, 9, 100, 7, 250]), (1, 0, [5, 6, 7, 8, 9])], False),
    ([(0, 7, [11]), (1, 5, [12, 13]), (2, 0, [1, 2, 3, 4])], False),
    ([(0, 8, [21]), (1, 7, [22]), (2, 4, [23])], True),
    ([(0, 9, [31]), (1, 8, [32]), (2, 5, [33])], True),
]


def _jax_step(jmodel):
    @functools.partial(jax.jit, static_argnames="decode_only")
    def step(p, kv, mi, decode_only):
        h, kv = jmodel.forward(p, kv, mi, decode_only=decode_only)
        return jmodel.logits(p, h), kv

    return step


def _run_steps(jmodel, jparams, tmodel, variants):
    """The JAX logits per step, and the port's for each variant."""
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.layers.moe import quant_expert_ffn
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

    shape = jmodel.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(shape, jnp.float32)
    tkv = {v: torch.zeros(shape) for v in variants}
    step = _jax_step(jmodel)
    out = []
    for chunks, decode_only in STEPS:
        arrays = _inputs(chunks)
        want, jkv = step(jparams, jkv, JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                         decode_only=decode_only)
        got = {}
        for v in variants:
            tmodel.quant_impl = functools.partial(quant_matmul, variant=v)
            tmodel.qexperts_impl = functools.partial(quant_expert_ffn, variant=v)
            with torch.inference_mode():
                h = tmodel(tkv[v], ModelInputs(**arrays).to("cpu"), decode_only=decode_only)
                got[v] = tmodel.logits(h).numpy()
        out.append((len(chunks), np.asarray(want), got))
    return out


@pytest.mark.parametrize("bits", [4, 8])
def test_logits_match_jax_over_steps(bits, quantized, monkeypatch):
    from scalellm_tpu_torch.ops import moe_quant as TQ

    jmodel, jparams, _, tmodel = quantized[bits]
    pairs = []  # the plain K8 calls of the default dispatch
    real = TQ.plain_grouped_quant_matmul_pair
    monkeypatch.setattr(TQ, "plain_grouped_quant_matmul_pair", lambda *a: pairs.append(1) or real(*a))
    for n, want, got in _run_steps(jmodel, jparams, tmodel, ("ref", "")):
        np.testing.assert_allclose(got["ref"], want, atol=TOL_REF, rtol=TOL_REF)
        np.testing.assert_allclose(got[""], want, atol=TOL_DISPATCH, rtol=0)
        assert (got[""][:n].argmax(-1) == want[:n].argmax(-1)).all()
    # Decode-sized steps (at most 16 tokens x top-2 rows): K8 once per MoE layer.
    assert len(pairs) == 2 * len(STEPS)


@pytest.mark.parametrize("bits", [4, 8])
def test_single_token_step_matches_jax_t1_dispatch(bits, quantized, monkeypatch):
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.layers.moe import quant_expert_ffn
    from scalellm_tpu_torch.models.deepseek import MLADecoderModel
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

    jmodel, jparams, _, tmodel = quantized[bits]
    arrays = _inputs([(0, 0, [42])], S=1, T=1)
    monkeypatch.setenv("MOE_DISPATCH_T1", "force")  # the JAX package's T=1 layout on the CPU
    want, _ = _jax_step(jmodel)(jparams, jnp.zeros(jmodel.kv_cache_shape(8, PAGE), jnp.float32),
                                JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                                decode_only=True)
    layouts = []
    real_layout = MLADecoderModel._single_token_fits
    monkeypatch.setattr(MLADecoderModel, "_single_token_fits",
                        staticmethod(lambda layer, k: layouts.append(real_layout(layer, k)) or layouts[-1]))
    got = {}
    for variant in ("ref", ""):
        tmodel.quant_impl = functools.partial(quant_matmul, variant=variant)
        tmodel.qexperts_impl = functools.partial(quant_expert_ffn, variant=variant)
        with torch.inference_mode():
            kv = torch.zeros(tmodel.kv_cache_shape(8, PAGE))
            got[variant] = tmodel.logits(tmodel(kv, ModelInputs(**arrays).to("cpu"), decode_only=True)).numpy()
    assert layouts and all(layouts)  # every MoE layer took the T=1 layout
    np.testing.assert_allclose(got["ref"], np.asarray(want), atol=TOL_REF, rtol=TOL_REF)
    # The port's T=1 layout against its own sorted dispatch, kernels' plain versions.
    monkeypatch.setattr(MLADecoderModel, "_single_token_fits", staticmethod(lambda layer, k: False))
    with torch.inference_mode():
        kv = torch.zeros(tmodel.kv_cache_shape(8, PAGE))
        sorted_ = tmodel.logits(tmodel(kv, ModelInputs(**arrays).to("cpu"), decode_only=True)).numpy()
    np.testing.assert_allclose(got[""], sorted_, atol=2e-5, rtol=2e-5)


def _generate(llm_cls, sp_cls, path, ref=False, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        if ref:
            from scalellm_tpu_torch.layers.moe import quant_expert_ffn
            from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

            model = llm._handler.engine.model
            model.quant_impl = functools.partial(quant_matmul, variant="ref")
            model.qexperts_impl = functools.partial(quant_expert_ffn, variant="ref")
        sp = sp_cls(max_tokens=6, temperature=0.0, ignore_eos=True)
        return [o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, sp)]
    finally:
        llm.close()


def test_greedy_generate_matches_jax(ckpt):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    want = _generate(JaxLLM, JaxSamplingParams, ckpt, quantize="int4", enable_cuda_graph=False)
    got = _generate(LLM, SamplingParams, ckpt, ref=True, quantize="int4", devices="cpu")
    assert got == want and all(len(ids) == 6 for ids in got)


def test_a_gptq_deepseek_checkpoint_is_refused(ckpt, tmp_path):
    import shutil

    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    d = str(tmp_path / "gptq")
    shutil.copytree(ckpt, d)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["quantization_config"] = {"quant_method": "gptq", "bits": 4, "group_size": 128, "sym": True}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    loader = HFModelLoader(d)
    with pytest.raises(NotImplementedError, match="gptq checkpoints are not supported"):
        ModelRegistry.get_causal_lm_factory("deepseek_v2")(loader.model_args, device="meta")
