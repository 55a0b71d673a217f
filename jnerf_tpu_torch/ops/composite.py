"""Differentiable volume rendering over fixed [R, S] sample batches.

Same function as `jnerf_tpu/ops/composite.py` (the reference's
`compute_rgbs`, `calc_rgb.h:11-74`): masked cumulative products, with the
backward left to autograd.  Activations are the reference defaults:
rgb = sigmoid, density = exp, saturated at ``RAW_DENSITY_CAP``.
"""

from __future__ import annotations

import torch

# exp(15) ~ 3.3e6 saturates alpha at any dt the marcher produces, so the
# clamp changes no rendering but keeps exp from overflowing f32 where raw
# density grows without bound in unsupervised regions.
RAW_DENSITY_CAP = 15.0


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zeros.
    The backward is torch's own for such an input, reversed_cumsum(out *
    g) / x, without its test for zeros: that test reads the device
    (``.item()``), which a CUDA graph cannot capture."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def transmittance(alpha):
    """Inclusive transmittance along the last axis: cumprod(1 - alpha +
    1e-10), whose factors are never zero."""
    return _Cumprod.apply(1.0 - alpha + 1e-10)


def network_to_density(raw):
    """Exponential density activation, saturated at RAW_DENSITY_CAP."""
    return torch.exp(torch.clamp(raw, max=RAW_DENSITY_CAP))


def raw_to_alpha(raw_sigma, dts, valid):
    """sigma = exp(raw); alpha = 1 - exp(-sigma*dt), masked."""
    sigma = network_to_density(raw_sigma)
    return torch.where(valid, 1.0 - torch.exp(-sigma * dts),
                       torch.zeros_like(dts))


def render_rays(raw, dts, valid, truncated=None, background=None):
    """Composite network outputs to per-ray RGB.

    Args:
      raw: [R, S, 4] raw network outputs (rgb logits, log-sigma).
      dts: [R, S] step sizes (world units).
      valid: [R, S] bool sample mask.
      truncated: [R] bool; rays whose sample list was cut short skip the
        background term, like `calc_rgb.h:68-71`.
      background: [R, 3] or [3] background color; None skips it.
    Returns:
      rgb [R, 3], opacity [R] (= 1 - final transmittance).
    """
    rgb = torch.sigmoid(raw[..., :3])
    alpha = raw_to_alpha(raw[..., 3], dts, valid)
    # Exclusive cumprod: T_i = prod_{j<i} (1 - alpha_j).
    trans = transmittance(alpha)
    t_excl = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * t_excl  # [R, S]
    rgb_ray = torch.sum(weights[..., None] * rgb, dim=-2)  # [R, 3]
    t_final = trans[..., -1]
    if background is not None:
        bg_weight = t_final
        if truncated is not None:
            bg_weight = torch.where(truncated, torch.zeros_like(bg_weight),
                                    bg_weight)
        rgb_ray = rgb_ray + bg_weight[..., None] * background
    return rgb_ray, 1.0 - t_final


def density_l1_reg(raw_sigma, valid, grid_mean, coef, min_optical_thickness=0.01):
    """Early-training L1 push on negative raw densities.

    Mirrors `calc_rgb.h:112,141`: active only while the density-grid mean is
    below NERF_MIN_OPTICAL_THICKNESS; gradient is -coef for raw < 0.
    """
    active = (grid_mean < min_optical_thickness).to(torch.float32)
    neg = torch.where(valid, torch.relu(-raw_sigma), torch.zeros_like(raw_sigma))
    return active * coef * torch.sum(neg)
