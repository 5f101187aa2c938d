"""The port's DeepSeek-V2 (MLA + MoE) against the JAX package's
MLADecoderModel on the CPU in float32, on an untrained tiny deepseek_v2
checkpoint written by transformers (3 layers: one dense, two MoE with 4
routed experts and a shared one) with a yarn rope_scaling:

- the loader's state_dict against convert_params of the JAX loader's tree
  (exactly equal), and a checkpoint that lacks an expert fails to load;
- forward + logits over a mixed prefill/decode batch and then decode-only
  steps (K9's path), here and with q_lora_rank and group-limited routing
  (random weights in the JAX model's tree): tolerance 1e-4 on logits of
  magnitude < 1 (f32 sums in another order through 3 layers);
- LLM.generate's greedy tokens equal to scalellm_tpu.LLM's, with chunked
  prefill (a 16-token budget) and the prefix cache on (a second pass)."""

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

TOL = 1e-4
PAGE = 4
HF_KW = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256,
             q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, first_k_dense_replace=1, n_routed_experts=4, num_experts_per_tok=2,
             moe_intermediate_size=32, n_shared_experts=1, topk_method="greedy",
             routed_scaling_factor=1.0, tie_word_embeddings=False)
YARN = dict(type="yarn", factor=40, original_max_position_embeddings=64, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
# Two prompts longer than the 16-token step budget, sharing a 20-char prefix
# (five 4-slot blocks that the second pass finds in the prefix cache).
PROMPTS = ["the quick brown fox jumps over", "the quick brown fox sleeps"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    d = str(tmp_path_factory.mktemp("tiny_deepseek_torch_port"))
    torch.manual_seed(0)
    DeepseekV2ForCausalLM(DeepseekV2Config(**HF_KW)).to(torch.float32).save_pretrained(
        d, safe_serialization=True)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg["rope_scaling"] = YARN
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    fixtures.save_char_tokenizer(d)
    return d


@pytest.fixture(scope="module")
def jax_loaded(ckpt):
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig

    loader = JaxLoader(ckpt)
    model = JaxRegistry.get_causal_lm_factory("deepseek_v2")(loader.model_args, ParallelConfig())
    return model, loader.load_params(model), loader.model_args


def _port_model(args, sd):
    from scalellm_tpu_torch.models.deepseek import MLADecoderModel

    model = MLADecoderModel(args, device="meta")
    model.load_state_dict(sd, assign=True)
    return model


def test_loader_reads_the_checkpoint_like_jax(ckpt, jax_loaded):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.deepseek import convert_params
    from scalellm_tpu_torch.models.registry import ModelRegistry

    _, params, jargs = jax_loaded
    want = convert_params(params, jargs)
    loader = HFModelLoader(ckpt)
    model = ModelRegistry.get_causal_lm_factory("deepseek_v2")(loader.model_args, device="meta")
    got = loader.load_state_dict(model, "cpu")
    assert sorted(got) == sorted(want)
    assert got["layers.1.experts_gate"].shape == (4, 32, 64)
    for name, t in got.items():
        assert t.dtype == torch.float32, name
        assert torch.equal(t, want[name]), name


def test_a_missing_expert_is_a_load_error(ckpt, tmp_path):
    from safetensors.numpy import load_file, save_file

    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry

    d = str(tmp_path / "no_expert_3")
    os.makedirs(d)
    tensors = load_file(os.path.join(ckpt, "model.safetensors"))
    del tensors["model.layers.2.mlp.experts.3.up_proj.weight"]
    save_file(tensors, os.path.join(d, "model.safetensors"))
    with open(os.path.join(ckpt, "config.json")) as f, open(os.path.join(d, "config.json"), "w") as g:
        g.write(f.read())
    loader = HFModelLoader(d)
    model = ModelRegistry.get_causal_lm_factory("deepseek_v2")(loader.model_args, device="meta")
    with pytest.raises(ValueError, match=r"layers\.2\.experts_up.*\[3\]"):
        loader.load_state_dict(model, "cpu")


def _lora_group_limited():
    """A q_lora_rank model with group-limited routing and norm_topk_prob,
    random weights (norms 1) in the JAX model's parameter tree."""
    from scalellm_tpu.config import ModelArgs as JaxModelArgs
    from scalellm_tpu.models.deepseek import MLADecoderModel as JaxMLA

    kw = dict(model_type="deepseek_v2", dtype="float32", hidden_size=64, intermediate_size=96,
              n_layers=3, n_heads=4, n_kv_heads=4, vocab_size=256, rms_norm_eps=1e-6,
              q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16, first_k_dense_replace=1, n_experts=8, n_experts_per_token=3,
              moe_intermediate_size=32, n_shared_experts=2, topk_method="group_limited_greedy",
              n_group=4, topk_group=2, norm_topk_prob=True)
    model = JaxMLA(JaxModelArgs(**kw))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, shape: np.ones(shape, np.float32) if path[-1].key.endswith("norm")
        else (rng.standard_normal(shape) * 0.1).astype(np.float32),
        model.param_shapes(), is_leaf=lambda x: isinstance(x, tuple))
    return model, params, kw


@pytest.mark.parametrize("config", ["hf_yarn", "q_lora_group_limited"])
def test_forward_and_logits_match_jax_over_steps(config, jax_loaded):
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.models.deepseek import convert_params

    if config == "hf_yarn":
        jmodel, params, jargs = jax_loaded
        args = ModelArgs(**{k: getattr(jargs, k) for k in ModelArgs.__dataclass_fields__
                            if k != "quant_args"})
    else:
        jmodel, params, kw = _lora_group_limited()
        args = ModelArgs(**kw)
    tmodel = _port_model(args, convert_params(params, args))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (8, 10, 5)]
    # Mixed prefill chunks, then two decode-only steps (K9's path on a card).
    steps = [
        ([(0, 0, prompts[0][:7]), (1, 0, prompts[1][:5])], False),
        ([(0, 7, prompts[0][7:]), (1, 5, prompts[1][5:]), (2, 0, prompts[2][:4])], False),
        ([(0, 8, [11]), (1, 10, [12]), (2, 4, prompts[2][4:])], True),
        ([(0, 9, [13]), (1, 11, [14]), (2, 5, [15])], True),
    ]
    kv_shape = jmodel.kv_cache_shape(16, PAGE)
    assert tuple(kv_shape) == tmodel.kv_cache_shape(16, PAGE)  # [L, P, page, 1, 24]
    @functools.partial(jax.jit, static_argnames="decode_only")
    def jax_step(p, kv, mi, decode_only):
        h, kv = jmodel.forward(p, kv, mi, decode_only=decode_only)
        return jmodel.logits(p, h), kv

    jkv = jnp.zeros(kv_shape, jnp.float32)
    tkv = torch.zeros(kv_shape)
    for chunks, decode_only in steps:
        arrays = _inputs(chunks)
        want, jkv = jax_step(params, jkv, JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                             decode_only=decode_only)
        want = np.asarray(want)
        with torch.inference_mode():
            got = tmodel.logits(tmodel(tkv, ModelInputs(**arrays).to("cpu"), decode_only=decode_only))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # The latent pages of the real tokens (page 0 takes the padding rows).
    np.testing.assert_allclose(tkv[:, 1:].numpy(), np.asarray(jkv)[:, 1:], atol=TOL, rtol=TOL)


def _generate(llm_cls, sp_cls, path, watch=None, **kw):
    llm = llm_cls(path, block_size=4, num_blocks=128, max_tokens_per_batch=16, **kw)
    try:
        if watch is not None:
            watch(llm._handler.engine)
        sp = sp_cls(max_tokens=6, temperature=0.0, ignore_eos=True)
        # The second pass re-reads the shared prompt blocks from the prefix cache.
        return [[o.outputs[0].token_ids for o in generate_within(llm, PROMPTS, sp)] for _ in range(2)]
    finally:
        llm.close()


def test_greedy_generate_matches_jax(ckpt):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import LLM, SamplingParams

    steps = []

    def watch(engine):
        # One latent row of 16 + 8 dims per layer and slot, f32.
        assert engine.kv_cache_slot_size_in_bytes() == 3 * 1 * 24 * 4
        real = engine.executor.execute

        def execute(mi, si, decode_only=False, **kw):  # kw: an async step's pending merge
            n = int(mi.num_seqs[0])
            steps.append((decode_only, bool((mi.cu_q_lens[1 : n + 1] - mi.cu_q_lens[:n] == 1).all())))
            return real(mi, si, decode_only=decode_only, **kw)

        engine.executor.execute = execute

    want = _generate(JaxLLM, JaxSamplingParams, ckpt, enable_cuda_graph=False)
    got = _generate(LLM, SamplingParams, ckpt, watch=watch, devices="cpu")
    assert got == want
    assert all(len(ids) == 6 for ids in got[0]) and got[0] == got[1]
    # decode_only reaches the model exactly on the steps where every
    # sequence has one token, and both kinds of step ran.
    assert all(flag == one_each for flag, one_each in steps)
    assert {flag for flag, _ in steps} == {True, False}
