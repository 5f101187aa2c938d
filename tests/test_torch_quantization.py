"""The port's quantization host code against the JAX package's, bit for bit,
from numpy-seeded inputs: nibble packing, the int4/int8 quantizers, the
AWQ/GPTQ unpackers, the kernel-layout repack, the checkpoint weight rules,
and the loader and convert_params on quantized parameter trees."""

import numpy as np
import pytest
import torch

from scalellm_tpu.ops import quant_matmul as JQ
from scalellm_tpu.quantization import formats as JF
from scalellm_tpu_torch.config import QuantArgs
from scalellm_tpu_torch.ops import quant_matmul as TQ
from scalellm_tpu_torch.quantization import formats as TF
from scalellm_tpu_torch.quantization.linear import (
    build_quant_rules,
    gptq_qweight_to_kernel_layout,
)
from tests.torch_port_util import AWQ_ORDER, _pack_nibbles, quantize_checkpoint, tiny_llama


def _same_bits(t: torch.Tensor, a: np.ndarray):
    """Equal shapes and equal bytes (bf16 compared through its bit pattern)."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        t, a = t.view(torch.int16), a.view(np.int16)
    assert tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------------------ packing


@pytest.mark.parametrize("shape", [(2, 1), (16, 8), (64, 24)])
def test_pack_and_unpack_int4_match_jax(shape):
    u = np.random.default_rng(0).integers(0, 16, shape).astype(np.uint8)
    packed = TQ.pack_int4(torch.from_numpy(u))
    _same_bits(packed, JQ.pack_int4(u))
    _same_bits(TQ.unpack_int4(packed), JQ.unpack_int4(JQ.pack_int4(u)))
    assert torch.equal(TQ.unpack_int4(packed), torch.from_numpy(u))


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantizers_match_jax(bits, group):
    rng = np.random.default_rng(bits + group)
    w = (rng.standard_normal((256, 48)) * rng.uniform(0.01, 2.0, (1, 48))).astype(np.float32)
    w[:group, 0] = 0.0  # an all-zero group: the scale's floor
    want = (JQ.quantize_int4 if bits == 4 else JQ.quantize_int8)(w, group)
    got = (TQ.quantize_int4 if bits == 4 else TQ.quantize_int8)(torch.from_numpy(w), group)
    for g, wnt in zip(got, want):
        _same_bits(g, wnt)
    assert got[1].dtype == torch.bfloat16


def test_quantizer_takes_a_transposed_weight():
    """A dense torch weight is [out, in]: its transpose is not contiguous."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((48, 256)).astype(np.float32))
    qw, sc = TQ.quantize_linear(w, 4, 128)
    want_qw, want_sc, _ = JQ.quantize_int4(np.ascontiguousarray(w.numpy().T), 128)
    _same_bits(TQ.to_kernel_layout(qw), want_qw)
    _same_bits(sc, want_sc)
    assert qw.shape == (48, 128) and qw.is_contiguous()


@pytest.mark.parametrize("bits", [4, 8])
def test_kernel_layout_round_trip(bits):
    rng = np.random.default_rng(2)
    rows = 64 // (2 if bits == 4 else 1)
    canonical = torch.from_numpy(rng.integers(-128, 128, (rows, 24), dtype=np.int8))
    kernel = TQ.to_kernel_layout(canonical)
    assert kernel.shape == (24, rows) and kernel.is_contiguous()
    assert torch.equal(TQ.to_kernel_layout(kernel), canonical)
    # Byte j of row n holds K = 2j (low nibble) and 2j + 1 (high nibble).
    if bits == 4:
        signed = TQ.unpack_signed(kernel, 4)  # [N, K]
        want = JQ.unpack_int4(canonical.numpy()).astype(np.int32) - 8  # [K, N]
        np.testing.assert_array_equal(signed.numpy().T, want)
    else:
        assert TQ.unpack_signed(kernel, 8) is kernel


@pytest.mark.parametrize("lead", [(), (3,)])
def test_untile_matches_jax(lead):
    arr = np.random.default_rng(3).integers(-128, 128, lead + (16, 300), dtype=np.int8)
    tiled = JQ.tile_quant_layout(arr, 128)  # pads N to 384
    got = TQ.untile_quant_layout(torch.from_numpy(tiled))
    _same_bits(got, JQ.untile_quant_layout(tiled))
    assert torch.equal(got[..., :300], torch.from_numpy(arr))


# ------------------------------------------------------------ formats


def test_awq_unpackers_match_jax():
    rng = np.random.default_rng(4)
    qweight = rng.integers(-2**31, 2**31, (32, 6), dtype=np.int64).astype(np.int32)
    qzeros = rng.integers(-2**31, 2**31, (2, 6), dtype=np.int64).astype(np.int32)
    _same_bits(TF.unpack_awq_tensor(torch.from_numpy(qweight)), JF.unpack_awq_tensor(qweight))
    _same_bits(TF.unpack_awq_zeros(torch.from_numpy(qzeros)), JF.unpack_awq_zeros(qzeros))
    u = rng.integers(0, 16, (32, 48)).astype(np.uint8)
    packed = _pack_nibbles(u, 1, AWQ_ORDER)
    assert torch.equal(TF.unpack_awq_tensor(torch.from_numpy(packed)), torch.from_numpy(u))


@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_unpackers_match_jax(bits):
    rng = np.random.default_rng(5)
    qweight = rng.integers(-2**31, 2**31, (8, 24), dtype=np.int64).astype(np.int32)
    qzeros = rng.integers(-2**31, 2**31, (2, 3), dtype=np.int64).astype(np.int32)
    _same_bits(TF.unpack_gptq_tensor(torch.from_numpy(qweight), bits),
               JF.unpack_gptq_tensor(qweight, bits))
    _same_bits(TF.unpack_gptq_zeros(torch.from_numpy(qzeros), bits),
               JF.unpack_gptq_zeros(qzeros, bits))


def test_gptq_fast_repack_equals_unpack_then_pack():
    rng = np.random.default_rng(6)
    qweight = rng.integers(-2**31, 2**31, (16, 24), dtype=np.int64).astype(np.int32)
    want = JQ.pack_int4(JF.unpack_gptq_tensor(qweight))  # canonical [K/2, N]
    got = gptq_qweight_to_kernel_layout(torch.from_numpy(qweight))
    _same_bits(TQ.to_kernel_layout(got), want)


@pytest.mark.parametrize("method", ["awq", "gptq", "exllamav2"])
def test_quant_rules_match_jax(method):
    from scalellm_tpu.config import QuantArgs as JaxQuantArgs
    from scalellm_tpu.quantization.linear import build_quant_rules as jax_rules

    desc_act = method != "awq"
    base = [(r"model\.layers\.(\d+)\.self_attn\.q_proj\.weight", "layers.{}.q_proj"),
            (r"model\.norm\.weight", "final_norm")]
    got = build_quant_rules(base, QuantArgs(quant_method=method, bits=4, group_size=32,
                                            desc_act=desc_act))
    want = jax_rules([(base[0][0], "layers.q_proj", True), (base[1][0], "final_norm", False)],
                     JaxQuantArgs(quant_method=method, bits=4, group_size=32, desc_act=desc_act))
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[1].replace("{}.", "") for r in got] == [r[1] for r in want]
    rng = np.random.default_rng(7)
    words = rng.integers(-2**31, 2**31, (16, 8), dtype=np.int64).astype(np.int32)
    by_leaf = {r[1].rsplit(".", 1)[-1]: r for r in got}
    jax_by_leaf = {r[1].rsplit(".", 1)[-1]: r for r in want}
    qw = by_leaf["qweight"][2](torch.from_numpy(words))
    _same_bits(TQ.to_kernel_layout(qw), jax_by_leaf["qweight"][3](words))
    _same_bits(by_leaf["zeros"][2](torch.from_numpy(words)), jax_by_leaf["zeros"][3](words))
    scales = rng.uniform(0.001, 0.1, (2, 8)).astype(np.float16)
    assert torch.equal(by_leaf["scales"][2](torch.from_numpy(scales)),
                       torch.from_numpy(scales.astype(np.float32)))  # exact upcast
    assert by_leaf["final_norm"][2] is None


def test_quant_rules_refuse_other_formats():
    with pytest.raises(ValueError):
        build_quant_rules([], QuantArgs(quant_method="fp8", bits=4))
    with pytest.raises(ValueError):
        build_quant_rules([], QuantArgs(quant_method="gptq", bits=8))


# ------------------------------------------------------------ loader, convert_params


def _jax_params(path, quantize="", lm_head=False):
    import scalellm_tpu.models  # noqa: F401  (registers the JAX models)
    from scalellm_tpu.config import QuantArgs as JaxQuantArgs
    from scalellm_tpu.model_loader.loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig
    from scalellm_tpu.quantization.runtime import quantize_model_params

    jl = JaxLoader(path)
    factory = JaxRegistry.get_causal_lm_factory("llama")
    jm = factory(jl.model_args, ParallelConfig())
    params = jl.load_params(jm)
    if lm_head and jl.model_args.quant_args:
        # The JAX loader cannot fill a quantized lm_head from a checkpoint
        # (its buffers take no dict-shaped leaf), so quantize the loaded
        # dense one as DecoderModel.fuse_params would.
        jl.model_args.quant_args.quantize_lm_head = True
        jm = factory(jl.model_args, ParallelConfig())
        qw, sc, zp = JQ.quantize_int8(np.asarray(params["lm_head"], dtype=np.float32), 128)
        params["lm_head"] = {"qweight": qw, "scales": sc, "zeros": zp}
        jm.tile_quant_params(params)
    if quantize:
        qargs = JaxQuantArgs(quant_method="internal", bits=4 if quantize == "int4" else 8,
                             group_size=128, quantize_lm_head=lm_head)
        jm, params = quantize_model_params(jm, params, qargs)
    return jm, params


def _torch_state(path, quantize="", lm_head=False):
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine

    engine = LLMEngine(EngineOptions(model_path=path, device="cpu", num_blocks=16, block_size=4,
                                     quantize=quantize, quantize_lm_head=lm_head))
    return engine.model, engine.model.state_dict()


CHECKPOINTS = {
    # name: (hidden size, format, group, desc_act, quantize_lm_head)
    "gptq_g32": (64, "gptq", 32, False, False),
    "awq_g32": (64, "awq", 32, False, False),
    "gptq_desc_act": (64, "gptq", 32, True, False),
    "gptq_g128_lm_head": (128, "gptq", 128, False, True),
    "awq_g128": (128, "awq", 128, False, False),
}


@pytest.fixture(scope="module")
def dense_dirs():
    return {h: tiny_llama(h) for h in (64, 128)}


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_loader_and_convert_params_agree_on_a_checkpoint(name, dense_dirs, tmp_path):
    """The port's loader, reading the checkpoint itself, fills the same
    state_dict as convert_params makes from the JAX loader's (tiled) tree."""
    from scalellm_tpu_torch.models.common import convert_params

    hidden, fmt, group, desc_act, lm_head = CHECKPOINTS[name]
    path = quantize_checkpoint(dense_dirs[hidden], str(tmp_path / name), fmt, group=group,
                               desc_act=desc_act)
    jm, params = _jax_params(path, lm_head=lm_head)
    want = convert_params(params, jm.args)
    model, got = _torch_state(path, lm_head=lm_head)
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype and torch.equal(t, want[key]), key
    assert ("layers.0.q_proj.perm" in got) == desc_act
    assert ("layers.0.qkv_proj.zeros" in got) == (fmt == "awq")
    assert ("lm_head.qweight" in got) == lm_head
    if fmt == "awq":
        assert got["layers.0.qkv_proj.zeros"].unique().numel() > 4  # real zero points
    assert got["layers.0.o_proj.scales"].dtype == torch.float32


@pytest.mark.parametrize("quantize,lm_head", [("int4", False), ("int8", True), ("int4", "int4")])
def test_runtime_quantization_matches_jax(quantize, lm_head, dense_dirs):
    from scalellm_tpu_torch.models.common import convert_params

    jm, params = _jax_params(dense_dirs[128], quantize=quantize, lm_head=lm_head)
    want = convert_params(params, jm.args)
    model, got = _torch_state(dense_dirs[128], quantize=quantize, lm_head=lm_head)
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype and torch.equal(t, want[key]), key
    assert got["layers.0.qkv_proj.scales"].dtype == torch.bfloat16
    assert "layers.0.qkv_proj.zeros" not in got  # symmetric: never read
    pack = 2 if quantize == "int4" else 1
    assert got["layers.1.down_proj.qweight"].shape == (128, 256 // pack)
    if lm_head:
        assert model.lm_head.bits == (4 if lm_head == "int4" else 8)
        assert got["lm_head.qweight"].shape == (256, 128 // (2 if lm_head == "int4" else 1))
    else:
        assert got["lm_head"].shape == (256, 128)


def test_quantize_lm_head_alone_changes_nothing(dense_dirs):
    """As in the reference: without a quantized model the option is inert."""
    _, sd = _torch_state(dense_dirs[64], lm_head=True)
    assert "lm_head" in sd and not any(k.endswith("qweight") for k in sd)


def test_engine_refuses_an_unknown_quantize(dense_dirs):
    from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine

    with pytest.raises(ValueError):
        LLMEngine(EngineOptions(model_path=dense_dirs[64], device="cpu", num_blocks=16,
                                quantize="fp8"))
