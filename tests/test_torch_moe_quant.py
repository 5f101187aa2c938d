"""The port's quantized routed-expert matmuls (ops/moe_quant.py) against the
JAX package's scalellm_tpu/ops/moe_quant.py on the CPU, on numpy-seeded
inputs:

- the torch expert quantizers equal quantize_experts_int8/int4 bit for bit;
- the plain K7/K8 against the Pallas kernels in interpret mode and against
  the float reference, for int8 and int4, on a decode-sized step of 16
  tokens (8 of them padding rows that share one input and one pair of
  experts, so those experts own 9+ rows), with two experts that get no
  rows, and on the explicit T=1 layout; gate/up at K = 256 (8 groups of 32,
  the reference streams their scales) and down at K = 352 (11 groups, not
  a power of two). Inputs are bf16 values, so every product is exact in f32
  on both sides and only the order of the f32 sums differs: tolerance 1e-5
  of the output's largest magnitude;
- the plain K7/K8's fold (fold_span: f32 dots over 128- or 32-K spans,
  int4 times the span's group scale, added in span order; int8's sum times
  the channel scale) against a numpy emulation of that order and against
  the float reference, at G = 128, 256, 96 and 32 and at a K that is no
  multiple of the kernels' 128-K chunk (tolerance 1e-6 of the output's
  largest magnitude against the emulation, 1e-5 against the reference);
- the dispatcher's decision (fits_decode_kernel) at 96, 192 and 384 rows at
  DeepSeek-V2-Lite's expert shapes, equal to the reference's;
- the >256-row path against the JAX package's CPU grouped_quant_matmul,
  which computes the float reference: the port's int4 path rounds each
  dequantized weight to bf16 (as the reference's TPU path does), which moves
  it by at most 2^-9 of itself, so each output may move by 2^-9 times the
  sum of |x| |w| over its row (plus f32 slack); int8 is cast exactly and
  holds 1e-5."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from scalellm_tpu.ops import moe_quant as JQ
from scalellm_tpu_torch.ops import moe_quant as TQ

E, TOP_K = 8, 2
GATE_K, GATE_N = 256, 96  # hidden -> expert FFN width
DOWN_K, DOWN_N = 352, 256  # expert FFN width (11 groups of 32) -> hidden
GROUP = 32
EMPTY = (3, 6)  # experts no token routes to
PAD_EXPERTS = (1, 4)  # where the padding rows go


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bf16_values(a):
    """f32 values that bf16 holds exactly."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _quantized(rng, K, N, bits):
    """Reference-layout weights [E, K, N] quantized by the JAX package, and
    the same in the port's layout."""
    w = (rng.standard_normal((E, K, N)) * 0.05).astype(np.float32)
    qw, sc = JQ.quantize_experts_int4(w, GROUP) if bits == 4 else JQ.quantize_experts_int8(w)
    return (qw, sc), (_t(qw).transpose(1, 2).contiguous(), _t(sc))


def _decode_step(rng):
    """16 tokens (8 real, 8 padding rows sharing one input), top-2 of E with
    EMPTY never picked: rows sorted by expert, group sizes, and the input of
    each row."""
    allowed = [e for e in range(E) if e not in EMPTY]
    picks = [rng.choice(allowed, TOP_K, replace=False) for _ in range(8)]
    picks[0] = np.array([PAD_EXPERTS[0], 0])  # a real token joins the padding rows' expert
    picks += [np.array(PAD_EXPERTS)] * 8
    flat = np.concatenate(picks)
    order = np.argsort(flat, kind="stable")
    tokens = _bf16_values(rng.standard_normal((16, GATE_K)))
    tokens[8:] = tokens[8]
    sizes = np.bincount(flat, minlength=E).astype(np.int32)
    assert sizes[PAD_EXPERTS[0]] >= 9 and all(sizes[e] == 0 for e in EMPTY)
    return tokens[order // TOP_K], sizes


def _layouts(rng):
    """(name, xs, group sizes, active, starts, max_active): the sorted decode
    step, and the T=1 layout (one token broadcast over 8 rows, row j the
    expert of top-k slot j, starts explicit, rows unsorted)."""
    xs, sizes = _decode_step(rng)
    yield "sorted_decode_step", xs, sizes, None, None, 0
    e_sel = np.array([5, 2], np.int32)  # slot 0 -> expert 5: rows not in expert order
    sizes1 = np.zeros(E, np.int32)
    sizes1[e_sel] = 1
    starts1 = np.zeros(E, np.int32)
    starts1[e_sel] = np.arange(TOP_K)
    x1 = np.broadcast_to(_bf16_values(rng.standard_normal((1, GATE_K))), (8, GATE_K)).copy()
    yield "t1_layout", x1, sizes1, e_sel, starts1, TOP_K


def _close(got, want, rel=1e-5):
    top = float(np.abs(want).max())
    assert top > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * top)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_match_jax_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    for K, N in ((GATE_K, GATE_N), (DOWN_K, DOWN_N)):
        w = (rng.standard_normal((E, K, N)) * 0.05).astype(np.float32)
        w[1, :, 3] = 0.0  # an all-zero channel: the scale's floor
        port_w = _t(w).transpose(1, 2)  # [E, N, K]
        if bits == 4:
            want_q, want_s = JQ.quantize_experts_int4(w, GROUP)
            got_q, got_s = TQ.quantize_experts_int4(port_w, GROUP)
            assert got_s.dtype == torch.bfloat16 and got_q.shape == (E, N, K // 2)
        else:
            want_q, want_s = JQ.quantize_experts_int8(w)
            got_q, got_s = TQ.quantize_experts_int8(port_w)
            assert got_s.dtype == torch.float32 and got_q.shape == (E, N, K)
        assert torch.equal(got_q, _t(want_q).transpose(1, 2))
        assert torch.equal(got_s, _t(want_s))
        # The port's own dequantization is the reference's.
        deq = TQ.dequantize_experts(got_q, got_s, K)
        if bits == 4:
            want = np.stack([np.asarray(JQ._dequant_int4(want_q[e], want_s[e], GROUP)) for e in range(E)])
        else:
            want = want_q.astype(np.float32) * want_s[:, None, :]
        np.testing.assert_array_equal(deq.transpose(1, 2).numpy(), want)
        if bits == 4:  # the grouped GEMM's bf16 weights: q * s rounded once, in natural K order
            assert torch.equal(TQ.dequantize_experts_bf16(got_q, got_s, K), deq.to(torch.bfloat16))


@pytest.mark.parametrize("K", [1408, 2048])
@pytest.mark.parametrize("G", [32, 128])
def test_plain_bf16_dequant_is_jax_dequant_rounded_to_bf16(K, G):
    """The weights the grouped GEMM takes past 256 rows (what the expert
    dequantization kernel computes): JAX's _dequant_int4 rounded to bf16,
    bit for bit, in natural K order, at DeepSeek-V2-Lite's two K."""
    rng = np.random.default_rng(K + G)
    n_e, n = 2, 24
    w = (rng.standard_normal((n_e, K, n)) * 0.05).astype(np.float32)
    jq, js = JQ.quantize_experts_int4(w, G)
    want = np.stack([np.asarray(JQ._dequant_int4(jq[e], js[e], G)) for e in range(n_e)])  # [E, K, N] f32
    want = torch.from_numpy(want.astype(ml_dtypes.bfloat16).view(np.int16)).view(torch.bfloat16)
    got = TQ.plain_dequantize_experts_bf16(_t(jq).transpose(1, 2).contiguous(), _t(js), K)
    assert got.shape == (n_e, n, K)
    assert torch.equal(got.view(torch.int16), want.transpose(1, 2).view(torch.int16))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout", ["sorted_decode_step", "t1_layout"])
def test_plain_decode_kernels_match_pallas_interpret_and_reference(bits, layout):
    rng = np.random.default_rng(10 + bits)
    (jg, pg), (ju, pu), (jd, pd) = (_quantized(rng, K, N, bits) for K, N in
                                    ((GATE_K, GATE_N), (GATE_K, GATE_N), (DOWN_K, DOWN_N)))
    name, xs, sizes, active, starts, cap = next(c for c in _layouts(rng) if c[0] == layout)
    hidden = _bf16_values(rng.standard_normal((xs.shape[0], DOWN_K)))
    kw = dict(active=None if active is None else jnp.asarray(active),
              starts=None if starts is None else jnp.asarray(starts))
    t_active = None if active is None else _t(active)
    t_starts = TQ.expert_starts(_t(sizes)) if starts is None else _t(starts)
    if t_active is None:
        t_active = TQ.active_experts(_t(sizes), cap)

    # K8: gate and up in one walk.
    want_g, want_u = JQ._decode_grouped_quant_matmul_pair(
        jnp.asarray(xs), *map(jnp.asarray, (*jg, *ju)), jnp.asarray(sizes), interpret=True,
        max_active=cap, **kw)
    got_g, got_u = TQ.plain_grouped_quant_matmul_pair(
        _t(xs), *pg, *pu, _t(sizes), t_active, t_starts)
    _close(got_g.numpy(), np.asarray(want_g))
    _close(got_u.numpy(), np.asarray(want_u))
    # K7: down, over its 11 groups.
    want_d = JQ._decode_grouped_quant_matmul(
        jnp.asarray(hidden), *map(jnp.asarray, jd), jnp.asarray(sizes), interpret=True,
        max_active=cap, **kw)
    got_d = TQ.plain_grouped_quant_matmul(_t(hidden), *pd, _t(sizes), t_active, t_starts)
    _close(got_d.numpy(), np.asarray(want_d))
    # Rows outside every group are zeros, as the kernel writes them.
    covered = np.zeros(xs.shape[0], bool)
    st = np.cumsum(sizes) - sizes if starts is None else starts
    for e in range(E):
        covered[st[e]:st[e] + sizes[e]] = True
    assert not covered.all() or layout == "sorted_decode_step"
    assert (got_d.numpy()[~covered] == 0).all() and (got_g.numpy()[~covered] == 0).all()
    # Against the float reference the JAX package computes on the CPU.
    for got, x, (q, s), port_w in ((got_g, xs, jg, pg), (got_d, hidden, jd, pd)):
        ref = JQ._ref_grouped_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                           jnp.asarray(sizes), starts=kw["starts"])
        _close(got.numpy(), np.asarray(ref))
        port_ref = TQ.ref_grouped_quant_matmul(_t(x), *port_w, _t(sizes),
                                               None if starts is None else _t(starts))
        _close(port_ref.numpy(), np.asarray(ref))


# (bits, K, G): one span a group (int4 at G = 128), two spans a group (G =
# 256), spans of 32 (G = 96 at K = 288, G = 32 at K = 352: K no multiple of
# 128), int8 whole-K sums with a last span of 64 (K = 192) and without.
FOLD_CASES = [(4, 256, 128), (4, 512, 256), (4, 288, 96), (4, 352, 32), (8, 192, 0), (8, 256, 0)]


def _span_fold(x, q, s, bits, G):
    """The kernels' order in numpy: each span's dot (exact products, summed
    in float64 and rounded to f32 once), int4 times its group's scale, added
    in f32 in span order; int8's sum times the channel scale in f32."""
    K = x.shape[1]
    span = TQ.fold_span(bits, G)
    y = np.zeros((x.shape[0], q.shape[0]), np.float32)
    for k0 in range(0, K, span):
        d = (x[:, k0:k0 + span].astype(np.float64) @ q[:, k0:k0 + span].T.astype(np.float64)).astype(np.float32)
        y = y + (d * s[k0 // G] if bits == 4 else d)
    return y if bits == 4 else y * s


@pytest.mark.parametrize("bits,K,G", FOLD_CASES)
def test_plain_kernels_follow_the_span_fold(bits, K, G):
    rng = np.random.default_rng(60 + K + bits)
    N = 24
    w = (rng.standard_normal((E, K, N)) * 0.05).astype(np.float32)
    jq, js = JQ.quantize_experts_int4(w, G) if bits == 4 else JQ.quantize_experts_int8(w)
    pq, ps = _t(jq).transpose(1, 2).contiguous(), _t(js)
    sizes = np.array([2, 0, 3, 1, 0, 0, 2, 0], np.int32)
    xs = _bf16_values(rng.standard_normal((9, K)))  # the last row in no group
    got = TQ.plain_grouped_quant_matmul(_t(xs), pq, ps, _t(sizes)).numpy()
    q = (TQ.unpack_experts(pq) if bits == 4 else pq).float().numpy()  # [E, N, K]
    s = ps.float().numpy()  # int4 [E, K/G, N]; int8 [E, N]
    want = np.zeros_like(got)
    for e, lo in enumerate(np.cumsum(sizes) - sizes):
        if sizes[e]:
            want[lo:lo + sizes[e]] = _span_fold(xs[lo:lo + sizes[e]], q[e], s[e], bits, G)
    _close(got, want, 1e-6)
    assert (got[8] == 0).all()
    ref = JQ._ref_grouped_quant_matmul(jnp.asarray(xs), jnp.asarray(jq), jnp.asarray(js), jnp.asarray(sizes))
    _close(got, np.asarray(ref))


def test_active_list_and_starts_on_the_device():
    sizes = torch.tensor([0, 3, 0, 0, 5, 1, 0, 2], dtype=torch.int32)
    assert TQ.active_experts(sizes).tolist() == [1, 4, 5, 7, -1, -1, -1, -1]
    assert TQ.active_experts(sizes, max_active=5).tolist() == [1, 4, 5, 7, -1]
    assert TQ.active_experts(sizes, max_active=2).tolist() == [1, 4]
    assert TQ.expert_starts(sizes).tolist() == [0, 0, 3, 3, 3, 8, 9, 9]
    assert TQ.active_experts(torch.zeros(4, dtype=torch.int32), 3).tolist() == [-1, -1, -1]


# DeepSeek-V2-Lite: 64 experts, hidden 2048, expert FFN 1408, int4 at G = 128.
V2_LITE = {"gate_up": (2048, 1408), "down": (1408, 2048)}


@pytest.mark.parametrize("bits", [4, 8])
def test_decode_kernel_decision_matches_jax(bits):
    for proj, (K, N) in V2_LITE.items():
        if bits == 4:
            q_shape, s_shape, s_dtype = (64, K // 2, N), (64, K // 128, N), ml_dtypes.bfloat16
        else:
            q_shape, s_shape, s_dtype = (64, K, N), (64, N), np.float32
        w = {"qweight": jax.ShapeDtypeStruct(q_shape, np.int8), "scales": jax.ShapeDtypeStruct(s_shape, s_dtype)}
        port_q = (64, N, q_shape[1])
        for rows, want in ((96, True), (192, True), (384, False)):
            assert JQ.fits_decode_kernel(rows, K, w) is want, (proj, rows)
            assert TQ.fits_decode_kernel(rows, K, port_q, s_shape, np.dtype(s_dtype).itemsize) is want


def _prefill_step(rng, rows=320):
    sizes = np.zeros(E, np.int32)
    sizes[[0, 2, 5, 7]] = (100, 60, 90, 70)
    assert sizes.sum() == rows
    return _bf16_values(rng.standard_normal((rows, GATE_K))), sizes


@pytest.mark.parametrize("bits", [8, 4])
def test_more_than_256_rows_against_jax(bits, monkeypatch):
    rng = np.random.default_rng(30 + bits)
    (jq, js), (pq, ps) = _quantized(rng, GATE_K, GATE_N, bits)
    xs, sizes = _prefill_step(rng)
    want = np.asarray(JQ.grouped_quant_matmul(
        jnp.asarray(xs), {"qweight": jnp.asarray(jq), "scales": jnp.asarray(js)}, jnp.asarray(sizes)))
    # The port takes the dequant + grouped GEMM path here, not the decode kernel.
    monkeypatch.setattr(TQ, "plain_grouped_quant_matmul",
                        lambda *a, **k: pytest.fail("the decode kernel took 320 rows"))
    got = TQ.grouped_quant_matmul(_t(xs), pq, ps, _t(sizes)).numpy()
    if bits == 8:
        _close(got, want)
        return
    w = TQ.dequantize_experts(pq, ps, GATE_K).numpy()  # [E, N, K]
    e_of_row = np.repeat(np.arange(E), sizes)
    slack = 2.0 ** -9 * np.einsum("rk,rnk->rn", np.abs(xs), np.abs(w[e_of_row])) + 1e-5
    assert (np.abs(got - want) <= slack).all(), np.abs(got - want).max()
    assert not np.array_equal(got, want)  # the bf16 rounding is there


def test_dispatch_picks_the_kernels_as_the_reference_does(monkeypatch):
    rng = np.random.default_rng(40)
    _, (pg, sg) = _quantized(rng, GATE_K, GATE_N, 4)
    _, (pu, su) = _quantized(rng, GATE_K, GATE_N, 4)
    xs, sizes = _decode_step(rng)
    calls = []
    real_single, real_pair = TQ.plain_grouped_quant_matmul, TQ.plain_grouped_quant_matmul_pair
    monkeypatch.setattr(TQ, "plain_grouped_quant_matmul",
                        lambda *a: calls.append("K7") or real_single(*a))
    # (The plain pair computes K7's values twice; record it as one K8 call.)
    monkeypatch.setattr(TQ, "plain_grouped_quant_matmul_pair",
                        lambda xs, qg, sg, qu, su, *rest: calls.append("K8") or
                        (real_single(xs, qg, sg, *rest), real_single(xs, qu, su, *rest)))
    g, u = TQ.grouped_quant_matmul_pair(_t(xs), pg, sg, pu, su, _t(sizes), max_active=32)
    assert calls == ["K8"]
    want = real_pair(_t(xs), pg, sg, pu, su, _t(sizes), TQ.active_experts(_t(sizes)),
                     TQ.expert_starts(_t(sizes)))
    assert torch.equal(g, want[0]) and torch.equal(u, want[1])
    # Gate and up of other shapes: two single calls.
    _, (pu2, su2) = _quantized(rng, GATE_K, GATE_N * 2, 4)
    calls.clear()
    TQ.grouped_quant_matmul_pair(_t(xs), pg, sg, pu2, su2, _t(sizes))
    assert calls == ["K7", "K7"]
    # An explicit layout on more rows than the decode kernel takes.
    big, big_sizes = _prefill_step(rng)
    with pytest.raises(ValueError, match="active/starts"):
        TQ.grouped_quant_matmul(_t(big), pg, sg, _t(big_sizes), starts=TQ.expert_starts(_t(big_sizes)))
    with pytest.raises(ValueError, match="CPU tensors only"):
        TQ.grouped_quant_matmul(_t(xs).to("meta"), pg, sg, _t(sizes), variant="ref")


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(50)
    _, (pq, ps) = _quantized(rng, GATE_K, GATE_N, 4)
    xs, sizes = _decode_step(rng)
    s = _t(sizes)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.grouped_quant_matmul_cuda(_t(xs).to(torch.bfloat16), pq, ps, s, TQ.active_experts(s),
                                     TQ.expert_starts(s))
    with pytest.raises(ValueError, match="CUDA"):
        TQ.grouped_quant_matmul_pair_cuda(_t(xs).to(torch.bfloat16), pq, ps, pq, ps, s,
                                          TQ.active_experts(s), TQ.expert_starts(s))
