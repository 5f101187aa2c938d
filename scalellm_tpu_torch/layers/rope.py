"""Rotary position embeddings (counterpart of scalellm_tpu/layers/rope.py).

Rotated (HF llama) and interleaved (GPT-J) layouts, partial rotary dims,
linear and llama3 frequency scaling. Other scalings are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scalellm_tpu_torch.config import ModelArgs


def compute_inv_freq(args: ModelArgs) -> np.ndarray:
    """Per-frequency inverse wavelengths, with optional scaling applied."""
    rot_dim = args.effective_rotary_dim
    inv_freq = 1.0 / (
        args.rope_theta ** (np.arange(0, rot_dim, 2, dtype=np.float64) / rot_dim)
    )
    rope_type = args.rope_scaling_rope_type
    factor = args.rope_scaling_factor
    if rope_type == "llama3" and factor > 0:
        low_freq_factor = args.rope_scaling_low_freq_factor
        high_freq_factor = args.rope_scaling_high_freq_factor
        orig_ctx = args.rope_scaling_original_max_position_embeddings
        low_freq_wavelen = orig_ctx / low_freq_factor
        high_freq_wavelen = orig_ctx / high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
        smooth = (orig_ctx / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    elif rope_type == "linear" and factor > 0:
        inv_freq = inv_freq / factor
    elif rope_type not in ("", "default") and factor > 0:
        raise NotImplementedError(f"rope scaling {rope_type!r} is not ported")
    return inv_freq.astype(np.float32)


def inv_freq_buffer(inv_freq: np.ndarray, device) -> torch.Tensor:
    """A model's inverse-frequency table as a tensor: on `device`, or on the
    CPU for a model built on the meta device (the loader moves it to the
    weights' device). Models register it as a buffer, so that no step copies
    it from the host."""
    return torch.from_numpy(inv_freq).to("cpu" if torch.device(device).type == "meta" else device)


def cos_sin(inv_freq: torch.Tensor, positions: torch.Tensor):
    """cos/sin tables for the given positions from an inv_freq tensor on
    their device: each [T, rot_dim // 2] f32."""
    freqs = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def compute_cos_sin(args: ModelArgs, positions: torch.Tensor):
    """cos/sin tables for the given positions: each [T, rot_dim // 2] f32."""
    return cos_sin(torch.from_numpy(compute_inv_freq(args)).to(positions.device), positions)


def apply_rope(
    x: torch.Tensor,  # [T, n_heads, head_dim]
    cos: torch.Tensor,  # [T, rot_dim // 2]
    sin: torch.Tensor,  # [T, rot_dim // 2]
    interleaved: bool = False,
) -> torch.Tensor:
    """Apply the rotary embedding to the first rot_dim dims of each head."""
    rot_dim = cos.shape[-1] * 2
    xr = x[..., :rot_dim].float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)
    else:
        x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2 :]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    out = out.to(x.dtype)
    if x.shape[-1] > rot_dim:
        out = torch.cat([out, x[..., rot_dim:]], dim=-1)
    return out
