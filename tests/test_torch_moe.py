"""The port's MoE pieces against the JAX package on the CPU, from
numpy-seeded inputs handed to both: the plain grouped GEMM (K6's plain
version) against the stock megablox `gmm` Pallas kernel in interpret mode
and against layers/moe.py:_grouped_matmul's CPU path; moe_mlp; both
DeepSeek routers (greedy, group-limited greedy); and the combine.

Tolerances: the grouped products are f32 sums of bf16-exact or f32 inputs
in another order: 1e-5 relative to the output magnitude (about 1). The
routers' top-k picks must be equal and their weights within 1e-6 (the same
f32 softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.layers import moe as JM
from scalellm_tpu_torch.layers import moe as TM
from scalellm_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_cuda, plain_grouped_matmul

TOL = 1e-5


def _gmm_case(rng, R, K, N, sizes):
    xs = rng.standard_normal((R, K)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(np.float32)  # JAX [E, K, N]
    return xs, w, np.asarray(sizes, np.int32)


def _port_weights(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))  # [E, N, K]


def test_plain_grouped_matmul_matches_megablox_gmm():
    from jax.experimental.pallas.ops.tpu.megablox import gmm

    rng = np.random.default_rng(0)
    # Expert 1 and 4 have no rows; rows 200..255 are uncovered.
    xs, w, sizes = _gmm_case(rng, 256, 128, 128, [100, 0, 60, 40, 0])
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = np.asarray(gmm(bf(xs), bf(w), jnp.asarray(sizes), preferred_element_type=jnp.float32,
                          interpret=True))
    to_bf = lambda a: torch.from_numpy(np.array(bf(a).astype(jnp.float32))).to(torch.bfloat16)
    got = plain_grouped_matmul(to_bf(xs), to_bf(w).transpose(1, 2).contiguous(), torch.from_numpy(sizes))
    covered = int(sizes.sum())
    np.testing.assert_allclose(got[:covered].numpy(), want[:covered], rtol=TOL, atol=TOL)
    assert torch.all(got[covered:] == 0)


def test_plain_grouped_matmul_matches_the_jax_cpu_path():
    rng = np.random.default_rng(1)
    xs, w, sizes = _gmm_case(rng, 24, 64, 40, [5, 0, 9, 1, 0, 6])  # 3 rows uncovered
    want = np.asarray(JM._grouped_matmul(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(sizes)))
    got = grouped_matmul(torch.from_numpy(xs), _port_weights(w), torch.from_numpy(sizes))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):  # the CUDA wrapper refuses CPU tensors
        grouped_matmul_cuda(torch.from_numpy(xs).bfloat16(), _port_weights(w).bfloat16(),
                            torch.from_numpy(sizes))


@pytest.mark.parametrize("norm_topk_prob", [False, True])
def test_moe_mlp_matches_jax(norm_topk_prob):
    rng = np.random.default_rng(2)
    T, D, F, E, k = 11, 32, 48, 8, 2
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    gate, up = (rng.standard_normal((2, E, D, F)) / np.sqrt(D)).astype(np.float32)
    down = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    want = np.asarray(JM.moe_mlp(jnp.asarray(x), jnp.asarray(router), jnp.asarray(gate),
                                 jnp.asarray(up), jnp.asarray(down), k, norm_topk_prob))
    got = TM.moe_mlp(torch.from_numpy(x), torch.from_numpy(router.T.copy()), _port_weights(gate),
                     _port_weights(up), _port_weights(down), k, norm_topk_prob)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_dispatch_sorts_stably_and_counts_each_expert():
    topk_e = torch.tensor([[3, 0], [0, 2], [3, 1]])
    order, token_of, sizes = TM.dispatch(topk_e, 5)
    assert order.tolist() == [1, 2, 5, 3, 0, 4]  # ties keep their order, as jnp.argsort
    assert token_of.tolist() == [0, 1, 2, 1, 0, 2]
    assert sizes.tolist() == [2, 1, 1, 2, 0] and sizes.dtype == torch.int32


@pytest.mark.parametrize("method", ["greedy", "group_limited_greedy"])
def test_deepseek_routers_match_jax(method):
    from scalellm_tpu.config import ModelArgs as JaxModelArgs
    from scalellm_tpu.models.deepseek import MLADecoderModel as JaxMLA
    from scalellm_tpu_torch.config import ModelArgs
    from scalellm_tpu_torch.models.deepseek import MLADecoderModel

    kw = dict(model_type="deepseek_v2", dtype="float32", hidden_size=32, n_layers=2, n_heads=2,
              kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
              first_k_dense_replace=1, n_experts=8, n_experts_per_token=3,
              moe_intermediate_size=16, topk_method=method, n_group=4, topk_group=2,
              routed_scaling_factor=1.5 if method == "greedy" else 1.0,
              norm_topk_prob=method != "greedy", vocab_size=64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((9, 32)).astype(np.float32)
    router = rng.standard_normal((32, 8)).astype(np.float32)
    want_w, want_e = JaxMLA(JaxModelArgs(**kw))._router(jnp.asarray(x), jnp.asarray(router))
    got_w, got_e = MLADecoderModel(ModelArgs(**kw), device="meta")._router(
        torch.from_numpy(x), torch.from_numpy(router.T.copy()))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,E,k,D,spread", [(16, 64, 6, 256, False), (300, 16, 2, 8, True)])
def test_combine_matches_a_float64_scatter_add_and_the_reference(T, E, k, D, spread):
    """combine against a float64 scatter-add of the same weighted rows and
    against the reference's f32 `.at[token_of].add` of them (the same sums
    in another f32 order: 1e-6 relative, one rounding per add). spread:
    every token routes to the first and the last expert, so its two rows
    lie about T rows apart in sorted order."""
    rng = np.random.default_rng(5)
    if spread:
        topk_e = torch.tensor([[0, E - 1]] * T)
        topk_w = torch.from_numpy(rng.uniform(0.1, 1.0, (T, k)).astype(np.float32))
    else:
        probs = torch.softmax(torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)), -1)
        topk_w, topk_e = torch.topk(probs, k)
    order, token_of, _ = TM.dispatch(topk_e, E)
    y = torch.from_numpy(rng.standard_normal((T * k, D)).astype(np.float32))
    got = TM.combine(y, topk_w, order, token_of, T)
    assert got.dtype == torch.float32 and got.shape == (T, D)
    yw = y * topk_w.reshape(-1)[order][:, None]
    want = torch.zeros(T, D, dtype=torch.float64).index_add_(0, token_of, yw.double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    ref = jnp.zeros((T, D), jnp.float32).at[jnp.asarray(token_of.numpy())].add(jnp.asarray(yw.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
