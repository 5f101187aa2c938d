"""The port's all-to-all expert-parallel MoE (layers/moe.moe_mlp_a2a) over
gloo processes (tests/torch_tp_worker.py, one a rank), mirroring
tests/test_moe_a2a.py: tokens sharded over the ranks, experts sharded over
the same ranks, uneven all_to_all splits. Each rank's output rows against
the port's single-rank moe_mlp on all tokens and experts, and against the
JAX package's moe_mlp_a2a under shard_map over the same number of CPU
devices, within the reference test's tolerance (rtol 2e-4, atol 2e-5: f32
sums in another order)."""

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import run_world
from tests.torch_tp_worker import a2a_inputs

D, F, E = 16, 32, 8
# name -> (world, seed, T, top_k, norm, skew)
CASES = {
    "top2": (2, 0, 24, 2, False, False),
    "top1": (2, 0, 24, 1, False, False),
    "top2_norm": (2, 0, 24, 2, True, False),
    "skewed": (2, 1, 32, 2, False, True),  # every token's top-2 on the experts of rank 0
    "four_ranks": (4, 2, 16, 2, False, False),
}


def _case(name):
    world, seed, T, k, norm, skew = CASES[name]
    return dict(kind="a2a", name=name, seed=seed, T=T, D=D, F=F, E=E, top_k=k, norm=norm, skew=skew)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("a2a")
    out = {}
    for world in (2, 4):
        got = run_world(tmp, f"a2a{world}", world, [_case(n) for n, c in CASES.items() if c[0] == world])
        for name, c in CASES.items():
            if c[0] == world:
                out[name] = [r[name] for r in got]
    return out


def _jax_a2a(x, router, gate, up, down, top_k, ep, norm):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from scalellm_tpu.layers.moe import moe_mlp_a2a

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))
    fn = jax.jit(shard_map(
        lambda xx, r, g, u, d: moe_mlp_a2a(xx, r, g, u, d, top_k=top_k, ep_axis="ep", norm_topk_prob=norm),
        mesh=mesh, in_specs=(P("ep"), P(), P("ep"), P("ep"), P("ep")), out_specs=P("ep")))
    with mesh:
        return np.asarray(fn(x, router, gate, up, down))


@pytest.mark.parametrize("name", sorted(CASES))
def test_a2a_matches_single_rank_and_reference(ranks, name):
    from scalellm_tpu_torch.layers.moe import moe_mlp

    world, seed, T, k, norm, skew = CASES[name]
    x, router, gate, up, down = a2a_inputs(seed, T, D, F, E, skew)
    got = np.concatenate(ranks[name])
    t = torch.from_numpy
    single = moe_mlp(t(x), t(router.T.copy()), t(gate.transpose(0, 2, 1).copy()), t(up.transpose(0, 2, 1).copy()),
                     t(down.transpose(0, 2, 1).copy()), k, norm).numpy()
    np.testing.assert_allclose(got, single, rtol=2e-4, atol=2e-5)
    want = _jax_a2a(x, router, gate, up, down, k, world, norm)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if skew:  # the worst-case receive: one rank gets every pair
        assert np.abs(got).sum() > 0


def test_a2a_on_one_rank_is_moe_mlp():
    """With no mesh (one rank holding every expert) the exchange is the
    identity and the result is moe_mlp's."""
    from scalellm_tpu_torch.layers.moe import moe_mlp, moe_mlp_a2a

    x, router, gate, up, down = (torch.from_numpy(a) for a in a2a_inputs(0, 12, D, F, E))
    w = [w.transpose(1, 2).contiguous() for w in (gate, up, down)]
    got = moe_mlp_a2a(x, router.T.contiguous(), *w, 2)
    np.testing.assert_allclose(got.numpy(), moe_mlp(x, router.T.contiguous(), *w, 2).numpy(), rtol=1e-6,
                               atol=1e-6)
