"""Multi-LoRA serving in the port (scalellm_tpu_torch/lora/, DecoderModel's
per-token delta, the engine's adapter slots) against the JAX package, on the
CPU, with random adapters in the HF PEFT layout
(tests/torch_port_util.make_lora_adapter, tests/test_lora.py's layout):

- the loader: the port's load_lora_adapters gives the reference's stacked
  A/B arrays bit for bit and the same LoraMeta, for two adapters of other
  ranks and targets (slot 0 zeros); every refusal of the reference's loader
  is raised, with its words;
- the forward: on a mixed batch (base, "one", "two") over prefill, mixed and
  decode steps, DecoderModel with convert_params-carried weights gives the
  JAX DecoderModel's logits with the same lora_ids: bf16 Llama within 1e-2
  (the logits' bf16 rounding), runtime-INT4 Llama (the RMSNorm fold off on
  both sides) within 1e-4 under the port's float reference and within 1.5%
  of the largest logit under its default dispatch (int8 activations), and
  f32 Qwen2 (the qkv bias) and Phi (the ungated MLP, the parallel residual)
  within 1e-4;
- the engine (tests/test_lora.py's checks): a runtime adapter gives the
  texts of a checkpoint merged with it offline; a mixed batch gives each
  row's solo first-token logprob within 1e-4; the adapter moves the logits;
  an unknown adapter is a not-ok status naming it; one mixed batch gives
  scalellm_tpu.LLM's greedy texts; the step buffer carries lora_ids; async
  and 4-step serves equal the sync serve; the prefix cache keeps an
  adapter's KV from the base's;
- refusals: LoRA on MoE and MLA models (ValueError, as the reference);
  check_ported lets LoRA through, but not with speculative decoding.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import _inputs
from tests.torch_port_util import (
    generate_within, lora_dims, make_lora_adapter, merge_lora, shared_checkpoint, tiny_llama,
)

TOL = 1e-4
TOL_BF16 = 1e-2
TOL_DISPATCH = 1.5e-2  # of the largest |logit|
PAGE = 4
SCALE = 0.05  # the adapters' weights: large enough to move the tiny models' logits
ONE = dict(r=4, alpha=8, seed=1)  # every target
TWO = dict(r=2, alpha=2, seed=2, targets=("q_proj", "v_proj", "up_proj"))
# Sequence i of a step runs under adapter slot SLOTS[i] (base, "one", "two").
SLOTS = (0, 1, 2)
STEPS = [  # mixed prefill chunks, then decode-only steps
    ([(0, 0, [3, 17, 42, 9, 100, 7, 120]), (1, 0, [5, 6, 7, 8, 9])], False),
    ([(0, 7, [11]), (1, 5, [12, 13]), (2, 0, [1, 2, 3, 4, 60, 61, 62, 63, 64, 65])], False),
    ([(0, 8, [21]), (1, 7, [22]), (2, 10, [23])], True),
]


def _args(path):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader

    return HFModelLoader(path).model_args


def _adapters(path, drop=()):
    """{"one": dir, "two": dir}: the two adapters at the widths of the
    checkpoint `path` (targets in `drop` left out), built once per temp
    directory."""
    a = _args(path)
    dims, out = lora_dims(a), {}
    for name, kw in (("one", ONE), ("two", TWO)):
        kw = dict(kw, targets=tuple(t for t in kw.get("targets", tuple(dims)) if t not in drop))
        tag = f"lora_{os.path.basename(path)}_{name}_r{kw['r']}_s{kw['seed']}_{len(kw['targets'])}t_v1"
        out[name] = shared_checkpoint(tag, lambda d, kw=kw: make_lora_adapter(d, dims, a.n_layers, scale=SCALE,
                                                                              **kw))
    return out


@pytest.fixture(scope="module")
def base():
    return tiny_llama()


@pytest.fixture(scope="module")
def adapters(base):
    return _adapters(base)


@pytest.fixture(scope="module")
def merged_one(base, adapters, tmp_path_factory):
    a = _args(base)
    mats, scaling = make_lora_adapter(str(tmp_path_factory.mktemp("one_again")), lora_dims(a), a.n_layers,
                                      scale=SCALE, **ONE)
    return merge_lora(str(tmp_path_factory.mktemp("merged_one")), base, mats, scaling)


# ------------------------------------------------------------ loader


def _jax_model_stub(path, tp_size=1):
    """What the reference's load_lora_adapters reads of a model."""
    from types import SimpleNamespace

    import scalellm_tpu.models  # noqa: F401
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader

    args = JaxLoader(path).model_args
    return SimpleNamespace(args=args, parallel=SimpleNamespace(tp_size=tp_size), n_local_kv_heads=args.n_kv_heads)


def test_loader_matches_the_reference_bit_for_bit(base, adapters):
    from types import SimpleNamespace

    from scalellm_tpu.lora import load_lora_adapters as jax_load
    from scalellm_tpu_torch.lora import load_lora_adapters

    got, meta = load_lora_adapters(adapters, SimpleNamespace(args=_args(base)))
    want, jmeta = jax_load(adapters, _jax_model_stub(base))
    assert (meta.names, meta.targets, meta.n_slots, meta.r_max) == \
        (jmeta.names, jmeta.targets, jmeta.n_slots, jmeta.r_max) == \
        (["one", "two"], tuple(sorted(lora_dims(_args(base)))), 3, 4)
    assert sorted(got) == sorted(want)
    for key in got:
        for g, w in zip(got[key], want[key]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert not g[:, 0].any()  # slot 0: the base model
    assert not got["lora_k_proj"][0][:, 2].any()  # "two" has no k_proj
    A, B = got["lora_q_proj"]
    assert A[:, 2, :, :2].any() and not A[:, 2, :, 2:].any() and not B[:, 2, 2:].any()  # rank 2 of r_max 4
    assert meta.slot_of("two") == 2


def _refusal(case, d, dims, L):
    """Writes the adapter of a refusal `case` into d; returns (adapter dir,
    tp_size, vocab over the limit)."""
    adapter = dict(dims=dims, n_layers=L, r=2, targets=("q_proj",))
    if case == "peft_type":
        make_lora_adapter(d, **adapter, config={"peft_type": "IA3"})
    elif case == "tensor_name":
        make_lora_adapter(d, **adapter, extra={"base_model.model.lm_head.lora_A.weight": np.zeros((2, 4), np.float32)})
    elif case == "target":
        make_lora_adapter(d, **adapter, extra={
            "base_model.model.model.layers.0.self_attn.rotary.lora_A.weight": np.zeros((2, 4), np.float32)})
    elif case == "incomplete_pair":
        make_lora_adapter(d, **dict(adapter, n_layers=1))
        from safetensors.numpy import load_file, save_file

        f = os.path.join(d, "adapter_model.safetensors")
        t = load_file(f)
        del t["base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight"]
        save_file(t, f)
    elif case == "shape":
        make_lora_adapter(d, **dict(adapter, dims=dict(dims, q_proj=(dims["q_proj"][0] + 1, dims["q_proj"][1]))))
    else:
        make_lora_adapter(d, **adapter)
    return d, 2 if case == "tp_size" else 1, case == "vocab"


REFUSALS = ("peft_type", "tensor_name", "target", "incomplete_pair", "shape", "tp_size", "vocab")


@pytest.mark.parametrize("case", REFUSALS)
def test_loader_refuses_what_the_reference_refuses(case, base, tmp_path):
    from types import SimpleNamespace

    from scalellm_tpu.lora import load_lora_adapters as jax_load
    from scalellm_tpu_torch.lora import load_lora_adapters

    a = _args(base)
    d, tp, big_vocab = _refusal(case, str(tmp_path / case), lora_dims(a), a.n_layers)
    jmodel = _jax_model_stub(base, tp)
    if big_vocab:
        a.vocab_size = jmodel.args.vocab_size = 1 << 24
    with pytest.raises(ValueError) as want:
        jax_load({"x": d}, jmodel)
    with pytest.raises(ValueError) as got:
        load_lora_adapters({"x": d}, SimpleNamespace(args=a), tp_size=tp)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ forward


def _llama_int4():
    return tiny_llama(128)


def _zoo(module, name):
    import importlib

    return importlib.import_module(f"tests.{module}").checkpoint(name)


# name: (checkpoint, dtype, runtime quantization bits, targets the family lacks, tolerance)
FORWARD_CASES = {
    "llama_bf16": (lambda: tiny_llama(), "bfloat16", 0, (), TOL_BF16),
    "llama_int4": (_llama_int4, "float32", 4, (), TOL),
    "qwen2_qkv_bias": (lambda: _zoo("test_torch_moe_models", "qwen2"), "float32", 0, (), TOL),
    "phi_parallel_residual": (lambda: _zoo("test_torch_layernorm_models", "phi"), "float32", 0, ("gate_proj",), TOL),
}


def _jax_lora_model(path, dtype, bits, modules):
    import scalellm_tpu.models  # noqa: F401
    from scalellm_tpu.config import QuantArgs as JaxQuantArgs
    from scalellm_tpu.lora import load_lora_adapters as jax_load
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig
    from scalellm_tpu.quantization.runtime import quantize_model_params

    loader = JaxLoader(path)
    loader.model_args.dtype = dtype
    jm = JaxRegistry.get_causal_lm_factory(loader.model_type)(loader.model_args, ParallelConfig())
    params = jax.tree_util.tree_map(np.asarray, loader.load_params(jm))
    if bits:
        jm, params = quantize_model_params(jm, params, JaxQuantArgs(quant_method="internal", bits=bits,
                                                                    group_size=128))
    stacks, meta = jax_load(modules, jm)
    params["layers"].update(stacks)
    jm.lora_meta = meta
    return jm, params, meta


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_mixed_adapter_forward_matches_jax(case):
    """convert_params carries the reference's adapters; the JAX and port
    models run the same steps, sequence i under slot SLOTS[i]."""
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu.engine.params import ModelInputs as JaxModelInputs
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.models.common import QuantLinear, convert_params
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

    ckpt, dtype, bits, drop, tol = FORWARD_CASES[case]
    path = ckpt()
    modules = _adapters(path, drop)
    jm, jparams, meta = _jax_lora_model(path, dtype, bits, modules)
    args = _args(path)
    args.dtype = dtype
    if bits:
        args.quant_args = QuantArgs(quant_method="internal", bits=bits, group_size=128)
    model = ModelRegistry.get_causal_lm_factory(args.model_type)(args, device="cpu")
    model.set_lora(meta)
    model.load_state_dict(convert_params(jparams, args))
    assert model._fused_norm(model.layers[0], "qkv_proj", model.layers[0].input_norm) is None
    if bits:
        assert isinstance(model.layers[0].qkv_proj, QuantLinear)
    variants = ("ref", "") if bits else ("",)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    @functools.partial(jax.jit, static_argnames=("decode_only",))
    def jax_step(p, kv, mi, decode_only=False):
        h, kv = jm.forward(p, kv, mi, decode_only=decode_only)
        return jm.logits(p, h), kv

    shape = jm.kv_cache_shape(16, PAGE)
    jkv = jnp.zeros(shape, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tkv = {v: torch.zeros(shape, dtype=tdtype) for v in variants}
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    for chunks, decode_only in STEPS:
        arrays = _inputs(chunks)
        arrays["lora_ids"] = np.zeros(arrays["seq_mask"].shape, np.int32)
        arrays["lora_ids"][: len(chunks)] = [SLOTS[i] for i, _, _ in chunks]
        want, jkv = jax_step(jparams, jkv, JaxModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                             decode_only=decode_only)
        want = np.asarray(want, np.float32)
        n = len(chunks)
        for v in variants:
            model.quant_impl = functools.partial(quant_matmul, variant=v)
            with torch.inference_mode():
                got = model.logits(model(tkv[v], ModelInputs(**arrays).to("cpu"), decode_only=decode_only))
            got = got.float().numpy()
            limit = TOL_DISPATCH * np.abs(want).max() if (bits and v == "") else tol
            np.testing.assert_allclose(got[:n], want[:n], atol=limit, rtol=0 if bits else tol, err_msg=v)
            assert (got[:n].argmax(-1) == want[:n].argmax(-1)).all(), v


# ------------------------------------------------------------ engine


def _sp(**kw):
    from scalellm_tpu_torch import SamplingParams

    return SamplingParams(**{**dict(max_tokens=10, temperature=0.0, ignore_eos=True), **kw})


def _llm(path, **kw):
    from scalellm_tpu_torch import LLM

    return LLM(path, devices="cpu", num_blocks=256, block_size=4, **kw)


def _ids(outs):
    for o in outs:
        assert o.status.ok and o.finished, o.status
    return [o.outputs[0].token_ids for o in outs]


PROMPTS = ["hello lora world", "abc def"]
MIXED = (["mixed batch prompt", "hello lora world", "abc def", "hello lora world"], [None, "one", "two", "one"])


@pytest.fixture(scope="module")
def sync_llm(base, adapters):
    llm = _llm(base, lora_modules=adapters, enable_async_scheduling=False)
    yield llm
    llm.close()


@pytest.fixture(scope="module")
def sync_mixed(sync_llm):
    return _ids(generate_within(sync_llm, MIXED[0], _sp(), lora=MIXED[1]))


def test_runtime_adapter_matches_merged_checkpoint(base, sync_llm, merged_one):
    for lora, path in ((None, base), ("one", merged_one)):
        llm = _llm(path)
        try:
            want = [o.outputs[0].text for o in generate_within(llm, PROMPTS, _sp())]
        finally:
            llm.close()
        assert [o.outputs[0].text for o in generate_within(sync_llm, PROMPTS, _sp(), lora=lora)] == want, lora


def test_mixed_adapter_batch_matches_solo_runs(sync_llm):
    sp = _sp(max_tokens=1, logprobs=True)
    loras = [None, "one", "two"]
    outs = generate_within(sync_llm, ["mixed batch prompt"] * 3, sp, lora=loras)
    mixed = [o.outputs[0].logprobs[0] for o in outs]
    for row, lora in zip(mixed, loras):
        solo = generate_within(sync_llm, ["mixed batch prompt"], sp, lora=lora)[0].outputs[0].logprobs[0]
        assert row.token_id == solo.token_id
        assert abs(row.logprob - solo.logprob) < 1e-4, lora
    assert abs(mixed[1].logprob - mixed[0].logprob) > 1e-6


def test_adapter_changes_logits(sync_llm):
    sp = _sp(max_tokens=1, logprobs=True)
    base_lp = generate_within(sync_llm, ["probe"], sp)[0].outputs[0].logprobs[0].logprob
    one_lp = generate_within(sync_llm, ["probe"], sp, lora="one")[0].outputs[0].logprobs[0].logprob
    assert abs(one_lp - base_lp) > 1e-5


def test_unknown_adapter_is_a_status_naming_it(sync_llm):
    out = generate_within(sync_llm, ["x"], _sp(), lora="nope")[0]
    assert out.status is not None and not out.status.ok and "nope" in out.status.message
    with pytest.raises(ValueError):
        generate_within(sync_llm, PROMPTS, _sp(), lora=["one"])


def test_mixed_batch_greedy_texts_match_jax(base, adapters, sync_llm):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams

    jllm = JaxLLM(base, num_blocks=256, block_size=4, enable_cuda_graph=False, lora_modules=adapters)
    want = [o.outputs[0].text for o in generate_within(jllm, 
        MIXED[0], JaxSamplingParams(max_tokens=10, temperature=0.0, ignore_eos=True), lora=MIXED[1])]
    got = [o.outputs[0].text for o in generate_within(sync_llm, MIXED[0], _sp(), lora=MIXED[1])]
    assert got == want


def test_step_buffer_carries_lora_ids():
    from scalellm_tpu_torch.engine.executor import minimal_inputs
    from scalellm_tpu_torch.engine.params import StepInputs, step_words

    T, S, P = 16, 4, 4
    buf = StepInputs(step_words(T, S, P), "cpu")
    mi = minimal_inputs(T, S, P)
    mi.lora_ids = np.array([2, 0, 1, 0], np.int32)
    buf.fill(mi)
    assert buf.views(T, S, P).lora_ids.tolist() == [2, 0, 1, 0]
    mi.lora_ids = None  # an engine without adapters: zeros, whatever was there
    buf.fill(mi)
    assert buf.views(T, S, P).lora_ids.tolist() == [0, 0, 0, 0]
    assert buf.views(T, S, P).num_seqs.tolist() == [1]


@pytest.mark.parametrize("mode", ["async", "ms4"])
def test_async_and_multi_step_serves_equal_the_sync_serve(mode, base, adapters, sync_mixed):
    kw = dict(enable_async_scheduling=True) if mode == "async" else dict(num_decode_steps=4)
    llm = _llm(base, lora_modules=adapters, num_handling_threads=1, **kw)
    try:
        assert _ids(generate_within(llm, MIXED[0], _sp(), lora=MIXED[1])) == sync_mixed
    finally:
        llm.close()


def test_prefix_cache_keeps_an_adapters_kv_from_the_base(base, adapters, sync_llm):
    """A prompt served under "one" first, then under the base on the same
    engine (prefix cache on): the base gets its own output, and "one" its."""
    prompt = ["a prompt long enough to fill several blocks of the cache"]
    want_base = _ids(generate_within(sync_llm, prompt, _sp()))
    want_one = _ids(generate_within(sync_llm, prompt, _sp(), lora="one"))
    assert want_base != want_one
    llm = _llm(base, lora_modules=adapters, enable_prefix_cache=True)
    try:
        assert _ids(generate_within(llm, prompt, _sp(), lora="one")) == want_one
        assert _ids(generate_within(llm, prompt, _sp())) == want_base
        assert _ids(generate_within(llm, prompt, _sp(), lora="one")) == want_one
    finally:
        llm.close()


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("family", ["mixtral", "deepseek_v2"])
def test_lora_on_moe_and_mla_models_is_a_value_error(family, tmp_path):
    if family == "mixtral":  # the zoo checkpoint with the char tokenizer beside it
        import shutil

        import tests.fixtures as fixtures

        path = str(tmp_path / "mixtral")
        shutil.copytree(_zoo("test_torch_moe_models", "mixtral"), path)
        fixtures.save_char_tokenizer(path)
    else:
        from tests.test_torch_cuda_graph import shared_tiny_deepseek

        path = shared_tiny_deepseek()
    a = _args(path)
    d = str(tmp_path / "adapter")
    make_lora_adapter(d, {"q_proj": (a.hidden_size, a.hidden_size)}, 1, targets=("q_proj",))
    with pytest.raises(ValueError, match="LoRA"):
        _llm(path, lora_modules={"a": d})


def test_check_ported_lets_lora_through_but_not_with_speculation():
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandlerOptions

    LLMHandlerOptions(lora_modules={"a": "b"}).check_ported()
    for spec in (dict(draft_model_path="d", num_speculative_tokens=2), dict(num_speculative_tokens=2),
                 dict(distributed=True)):
        with pytest.raises(ValueError, match="LoRA"):
            LLMHandlerOptions(lora_modules={"a": "b"}, **spec).check_ported()
    with pytest.raises(ValueError, match="LoRA"):  # the reference's rule (lora/loader.py:112)
        LLMHandlerOptions(lora_modules={"a": "b"}, tp_size=2).check_ported()
