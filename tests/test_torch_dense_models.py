"""The port's DecoderModel families of the Gemma / Qwen slice (gemma, gemma2,
qwen3, and Qwen v1 "qwen") against transformers and the JAX package's
DecoderModel on the CPU, with the reference's activation table and the
plain ragged paged attention at head dim 256 (Gemma's) against the JAX
package's. Tiny checkpoints of gemma, gemma2 (sliding window 8 on even
layers, soft caps 50 / 30) and qwen3 (qk norm) are written by transformers
with the kwargs of tests/test_model_zoo.py:FAMILIES (float32, untrained,
seed 0) and shared between test processes. Qwen v1 has no transformers
class: its checkpoint is written here from the JAX package's initialised
parameters (norms drawn too), under the HF names of QWEN_WEIGHT_RULES.

- logits of one prefill against HF's (not Qwen v1) and the JAX model's,
  float32, tolerance 1e-4 (f32 sums in another order through 2-4 layers);
- the port's loader against convert_params of the JAX loader's tree,
  exactly (Qwen v1: also against the parameters the checkpoint was written
  from);
- mixed and decode-only paged steps against the JAX model in bf16:
  tolerance 1e-2 on logits of magnitude < 1 (bf16 activations rounded at
  other points);
- runtime INT4/INT8 of gemma2 and qwen3 (quantize_model against the JAX
  package's quantize_model_params, exactly; G = 32 divides the widths 64
  and 128), logits over mixed and decode-only steps with the port's float
  reference (variant="ref") within 1e-4, and with the default dispatch (the
  plain W4A8 / dequant: activations rounded to bf16 and quantized to int8
  per k-block) within 1.5% of the largest |logit|, every greedy token the
  same;
- LLM.generate on the CPU against scalellm_tpu.LLM for gemma2 and qwen3
  (the char tokenizer beside the checkpoint), the same greedy ids;
- each activation of the table against its JAX function, 1e-6;
- the plain ragged paged attention at head dim 256 (decode, mixed, window
  and soft cap) against the JAX package's, which is what the JAX package
  itself computes at that head dim (its stock kernel refuses it), 1e-5."""

import os

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
from tests.torch_port_util import generate_within, ragged_batch, shared_checkpoint

HF_FAMILIES = ("gemma", "gemma2", "qwen3")
FAMILY_NAMES = HF_FAMILIES + ("qwen",)
# Qwen v1 at the zoo's widths: the checkpoint's intermediate_size is twice
# the FFN width.
QWEN_CFG = dict(model_type="qwen", architectures=["QWenLMHeadModel"], torch_dtype="float32", vocab_size=128,
                hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
                layer_norm_epsilon=1e-6, rotary_emb_base=10000.0, max_position_embeddings=256)


def _hf_checkpoint(name: str) -> str:
    cfg_cls, model_cls, kwargs = FAMILIES[name]

    def build(d):
        import transformers

        torch.manual_seed(0)
        model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kwargs))
        model.to(torch.float32).save_pretrained(d, safe_serialization=True)

    return shared_checkpoint(f"zoo_{name}_seed0_v1", build)


def _qwen_params():
    """The JAX package's qwen model at QWEN_CFG, its initialised parameters
    (every norm drawn around 1, so that a swapped norm shows) as numpy."""
    import scalellm_tpu.models  # noqa: F401
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig

    args = JaxRegistry.get_model_args_loader("qwen")(dict(QWEN_CFG))
    args.dtype = "float32"
    jmodel = JaxRegistry.get_causal_lm_factory("qwen")(args, ParallelConfig())
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for name in ("input_norm", "post_norm"):
        params["layers"][name] = (1.0 + 0.2 * rng.standard_normal(params["layers"][name].shape)).astype(np.float32)
    params["final_norm"] = (1.0 + 0.2 * rng.standard_normal(params["final_norm"].shape)).astype(np.float32)
    return params


def _qwen_checkpoint() -> str:
    """A Qwen v1 checkpoint of _qwen_params under its HF names."""

    def build(d):
        import json

        from safetensors.numpy import save_file

        p = _qwen_params()
        L, F_ = QWEN_CFG["num_hidden_layers"], QWEN_CFG["intermediate_size"] // 2
        lay = p["layers"]
        out = {"transformer.wte.weight": p["embed_tokens"], "transformer.ln_f.weight": p["final_norm"],
               "lm_head.weight": p["lm_head"].T}
        for l in range(L):
            h = f"transformer.h.{l}."
            out[h + "ln_1.weight"] = lay["input_norm"][l]
            out[h + "ln_2.weight"] = lay["post_norm"][l]
            out[h + "attn.c_attn.weight"] = lay["qkv_proj"][l].T
            out[h + "attn.c_attn.bias"] = lay["qkv_bias"][l]
            out[h + "attn.c_proj.weight"] = lay["o_proj"][l].T
            out[h + "mlp.w2.weight"] = lay["gate_up_proj"][l][:, :F_].T  # gate
            out[h + "mlp.w1.weight"] = lay["gate_up_proj"][l][:, F_:].T  # up
            out[h + "mlp.c_proj.weight"] = lay["down_proj"][l].T
        os.makedirs(d)
        save_file({k: np.ascontiguousarray(v, np.float32) for k, v in out.items()},
                  os.path.join(d, "model.safetensors"))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(QWEN_CFG, f)

    return shared_checkpoint("qwen_v1_jax_init_seed0_v2", build)


def checkpoint(name: str) -> str:
    return _qwen_checkpoint() if name == "qwen" else _hf_checkpoint(name)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_logits_match_hf_and_jax(name):
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
    if name in HF_FAMILIES:
        import transformers

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
    if name == "qwen":  # the parameters the checkpoint was written from
        written = convert_params(_qwen_params(), a)
        assert all(torch.equal(got[k], written[k]) for k in written)
    if a.use_qk_norm:
        assert got["layers.0.q_norm"].shape == got["layers.1.k_norm"].shape == (a.head_dim,)
    if a.residual_post_layernorm:
        assert got["layers.0.post_attn_norm"].shape == got["layers.0.post_ffw_norm"].shape == (a.hidden_size,)
    assert ("lm_head" in got) == (not a.tie_word_embeddings)


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_paged_steps_match_jax_bf16(name):
    path = checkpoint(name)
    jmodel, params, _ = _jax_loaded(path, "bfloat16")
    loader, model = _port_loaded(path, "bfloat16")
    model = loader.load_model(model, "cpu")
    assert model.dtype == torch.bfloat16
    for n, want, got in _run_steps(jmodel, params, model, dtype=torch.bfloat16):
        np.testing.assert_allclose(got[""][:n], want[:n], atol=TOL_BF16, rtol=0)


QUANT_CASES = {"gemma2-int4-g32": ("gemma2", 4), "gemma2-int8-g32": ("gemma2", 8),
               "qwen3-int4-g32": ("qwen3", 4), "qwen3-int8-g32": ("qwen3", 8)}


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
    assert isinstance(layer.qkv_proj, QuantLinear) and layer.qkv_proj.bits == bits
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


@pytest.mark.parametrize("name", ["gemma2", "qwen3"])
def test_generate_matches_jax(name):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    path = _with_tokenizer(name)
    want = _generate(JaxLLM, JaxSamplingParams, path, enable_cuda_graph=False)
    got = _generate(LLM, SamplingParams, path, devices="cpu")
    assert all(len(ids) == 6 for ids in want)
    assert got == want


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_fast", "gelu_new", "gelu_pytorch_tanh", "relu"])
def test_activation_table_matches_jax(name):
    from scalellm_tpu.layers import activations as jax_act
    from scalellm_tpu_torch.layers import activations

    x = np.random.default_rng(3).standard_normal((16, 64)).astype(np.float32) * 2
    want = np.asarray(jax_act.ACT2FN[name](jnp.asarray(x)))
    got = activations.ACT2FN[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, window, soft_cap) at head dim 256.
ATTENTION_D256 = {
    "decode_gqa2": ([1, 1, 1, 1], [9, 30, 1, 17], 8, 8, 4, 2, None, None),
    "mixed_mqa": ([6, 4, 1, 1], [6, 11, 9, 14], 8, 16, 8, 1, None, None),
    "mixed_window_softcap": ([6, 4, 1, 1], [6, 11, 9, 14], 8, 16, 4, 2, 5, 50.0),
}


@pytest.mark.parametrize("case", list(ATTENTION_D256))
def test_plain_attention_at_head_dim_256_matches_jax(case):
    from scalellm_tpu.ops.attention_ref import ref_ragged_paged_attention as jax_ref
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, window, cap = ATTENTION_D256[case]
    inputs = ragged_batch(np.random.default_rng(11), q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H,
                          n_kv_heads=Hkv, head_dim=256)
    args = [inputs[k] for k in ("q", "kv_pages", "kv_lens", "page_indices", "cu_q_lens", "num_seqs")]
    kw = dict(sm_scale=256 ** -0.5, sliding_window=window, logit_soft_cap=cap)
    want = np.asarray(jax_ref(*[jnp.asarray(a) for a in args], **kw))
    got = ragged_paged_attention(*[torch.from_numpy(a) for a in args], **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[sum(q_lens):] == 0.0)
