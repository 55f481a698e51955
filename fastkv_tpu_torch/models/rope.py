"""Rotary position embeddings (HF rotate-half convention, llama3 and YaRN
scaling).

Port of ``fastkv_tpu.models.rope``. cos/sin come from explicit position-id
tensors, never an implicit arange, because token-selective propagation keeps
the *original* positions of surviving tokens. Everything is float32 until
application.
"""

from __future__ import annotations

import numpy as np
import torch

from fastkv_tpu_torch.core.config import ModelConfig

_inv_freq_tables = {}  # (config, device) -> inv_freq_on's tensor


def inv_freq_on(cfg: ModelConfig, device) -> torch.Tensor:
    """``compute_inv_freq(cfg)`` as a float32 tensor on ``device``, made once
    a (config, device), outside inference mode, and kept: a captured decode
    step reads it at one address, and no later call copies it from the
    host. Callers never write it."""
    key = (cfg, torch.device(device))
    if key not in _inv_freq_tables:
        with torch.inference_mode(False):
            _inv_freq_tables.setdefault(key, torch.from_numpy(compute_inv_freq(cfg)).to(key[1]))
    return _inv_freq_tables[key]


def compute_inv_freq(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies [rope_dim//2], with optional llama3 wavelength
    scaling (low frequencies divided by ``factor``, high ones kept, smooth in
    between) or YaRN's (``yarn_inv_freq``)."""
    d = cfg.rope_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    rs = cfg.rope_scaling
    if rs is not None and rs.rope_type == "yarn":
        return yarn_inv_freq(inv_freq, d, cfg.rope_theta, rs).astype(np.float32)
    if rs is not None and rs.rope_type == "llama3":
        low_freq_wavelen = rs.original_max_position_embeddings / rs.low_freq_factor
        high_freq_wavelen = rs.original_max_position_embeddings / rs.high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = np.where(wavelen > low_freq_wavelen, inv_freq / rs.factor, inv_freq)
        smooth = (rs.original_max_position_embeddings / wavelen - rs.low_freq_factor) / (
            rs.high_freq_factor - rs.low_freq_factor
        )
        interp = (1 - smooth) / rs.factor * inv_freq + smooth * inv_freq
        is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
        inv_freq = np.where(is_mid, interp, scaled)
    return inv_freq.astype(np.float32)


def yarn_inv_freq(inv_freq: np.ndarray, d: int, base: float, rs) -> np.ndarray:
    """YaRN's blend of the extrapolated (``inv_freq``) and interpolated
    (``inv_freq / factor``) frequencies, as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``: frequency i is interpolated below
    the correction dim of ``beta_slow`` rotations over the original
    context, extrapolated above that of ``beta_fast``, linear between."""

    def correction_dim(rotations):
        return (d * np.log(rs.original_max_position_embeddings / (rotations * 2 * np.pi))
                / (2 * np.log(base)))

    low = max(int(np.floor(correction_dim(rs.beta_fast))), 0)
    high = min(int(np.ceil(correction_dim(rs.beta_slow))), d - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(d // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
    extra = 1.0 - ramp  # the share of the extrapolated frequency
    return inv_freq / rs.factor * (1.0 - extra) + inv_freq * extra


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [..., s] int -> (cos, sin) each [..., s, head_dim//2] float32."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in the HF rotate-half layout.

    x: [b, heads, s, d]; cos/sin: [b, s, d/2] (broadcast over heads).
    """
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].to(torch.float32)
    xf2 = x[..., d2:].to(torch.float32)
    c = cos[:, None]
    s = sin[:, None]
    out1 = xf1 * c - xf2 * s
    out2 = xf2 * c + xf1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def apply_rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF DeepSeek-V2's RoPE of x [b, heads, s, r]: each interleaved pair
    regrouped (dims 0, 2, 4, ... then 1, 3, 5, ...), then rotate-half."""
    b, h, s, r = x.shape
    x = x.reshape(b, h, s, r // 2, 2).transpose(-1, -2).reshape(b, h, s, r)
    return apply_rope(x, cos, sin)
