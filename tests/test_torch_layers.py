"""The port's norms, gated activation and rope against the JAX package's
(scalellm_tpu/layers/), in float32. Tolerance 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalellm_tpu.config import ModelArgs as JaxModelArgs
from scalellm_tpu.layers import activations as jax_act
from scalellm_tpu.layers import norms as jax_norms
from scalellm_tpu.layers import rope as jax_rope
from scalellm_tpu_torch.config import ModelArgs
from scalellm_tpu_torch.layers import activations, norms, rope

TOL = 1e-6


@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_jax(zero_centered):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, zero_centered))
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, zero_centered)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_silu_gated_mlp_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w_gu = rng.standard_normal((32, 2 * 48)).astype(np.float32) * 0.2
    w_down = rng.standard_normal((48, 32)).astype(np.float32) * 0.2

    gu = x @ w_gu
    want = np.asarray(
        jax_act.act_with_mul("silu", jnp.asarray(gu[:, :48]), jnp.asarray(gu[:, 48:]))
    ) @ w_down
    tgu = torch.from_numpy(x) @ torch.from_numpy(w_gu)
    g, u = tgu.chunk(2, dim=-1)
    got = activations.act_with_mul("silu", g, u) @ torch.from_numpy(w_down)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=1e-5)


ROPE_CASES = {
    "default": {},
    "interleaved": dict(interleaved_rope=True),
    "partial": dict(rotary_pct=0.5),
    "linear": dict(rope_scaling_rope_type="linear", rope_scaling_factor=4.0),
    "llama3": dict(
        rope_scaling_rope_type="llama3", rope_scaling_factor=8.0,
        rope_scaling_low_freq_factor=1.0, rope_scaling_high_freq_factor=4.0,
        rope_scaling_original_max_position_embeddings=64, rope_theta=500000.0,
    ),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_rope_matches_jax(case):
    kw = dict(hidden_size=256, n_heads=4, n_kv_heads=2, **ROPE_CASES[case])
    jargs, targs = JaxModelArgs(**kw), ModelArgs(**kw)
    np.testing.assert_array_equal(
        rope.compute_inv_freq(targs), jax_rope.compute_inv_freq(jargs)
    )
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 512, 9).astype(np.int32)
    x = rng.standard_normal((9, 4, 64)).astype(np.float32)
    jc, js = jax_rope.compute_cos_sin(jargs, jnp.asarray(pos))
    want = np.asarray(jax_rope.apply_rope(jnp.asarray(x), jc, js, jargs.interleaved_rope))
    tc, ts = rope.compute_cos_sin(targs, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL, rtol=TOL)
    got = rope.apply_rope(torch.from_numpy(x), tc, ts, targs.interleaved_rope)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
