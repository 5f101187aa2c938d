"""The CUDA ragged paged attention kernel against its plain version, in
bf16 on the card. Each test skips when no CUDA device is present: the
kernel has no CPU or interpret mode. Run them on the card with
`python -m pytest tests/test_torch_kernels.py -q`.

Tolerance 2e-2 absolute: both sum in f32, the kernel with an online
softmax; the outputs are rounded to bf16 (8 bits of mantissa) from values
of magnitude <= ~3."""

import numpy as np
import pytest
import torch

# Imported by its own name (pytest puts tests/ on sys.path), so that an
# installed top-level package named `tests` cannot shadow this directory.
from torch_port_util import ragged_batch

TOL = 2e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(inputs, device):
    out = {}
    for k, v in inputs.items():
        t = torch.from_numpy(v).to(device)
        out[k] = t.to(torch.bfloat16) if t.is_floating_point() else t
    return out


# (q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim, window, soft_cap, page)
SHAPES = {
    "decode_gqa8_d64": ([1] * 8, [17, 40, 64, 100, 250, 513, 800, 1024], 8, 16, 32, 4, 64, None, None, 16),
    "mixed_padded": ([37, 64, 1, 1, 1, 1, 1, 1], [37, 200, 17, 90, 301, 5, 77, 1000], 16, 256, 32, 4, 64, None, None, 16),
    "gqa4_d128": ([5, 1, 1], [60, 33, 129], 4, 16, 32, 8, 128, None, None, 16),
    "window_softcap": ([9, 1, 1], [40, 70, 3], 4, 16, 8, 2, 64, 16, 30.0, 4),
    "no_padding_seq": ([3, 1], [3, 6], 2, 8, 8, 1, 64, None, None, 4),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_matches_plain_version(cuda, shape):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention_cuda as kernel
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention

    q_lens, kv_lens, S, T, H, Hkv, D, window, cap, page = SHAPES[shape]
    rng = np.random.default_rng(0)
    inputs = _on(ragged_batch(
        rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=H,
        n_kv_heads=Hkv, head_dim=D, page_size=page,
        num_pages=1 + sum(-(-k // page) for k in kv_lens),
    ), cuda)
    kw = dict(sm_scale=D ** -0.5, sliding_window=window, logit_soft_cap=cap)
    before = kernel.launches
    got = ragged_paged_attention(**inputs, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref_ragged_paged_attention(**inputs, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL, rtol=0)
    assert torch.all(got[sum(q_lens):] == 0)


def test_kernel_refuses_what_it_does_not_cover(cuda):
    from scalellm_tpu_torch.ops.attention import ragged_paged_attention

    rng = np.random.default_rng(1)
    inputs = _on(ragged_batch(rng, q_lens=[1], kv_lens=[5], S=1, T=1, n_heads=4,
                              n_kv_heads=2, head_dim=64), cuda)
    with pytest.raises(NotImplementedError):
        ragged_paged_attention(**inputs, k_scale=0.5, v_scale=0.5)
    with pytest.raises(NotImplementedError):
        ragged_paged_attention(**inputs, alibi_slopes=torch.ones(4, device=cuda))
    with pytest.raises(NotImplementedError):
        ragged_paged_attention(**{**inputs, "q": inputs["q"].float()})
