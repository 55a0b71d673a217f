"""Mip-NeRF math: cone casting, integrated positional encoding, resampling.

Counterpart of `jnerf_tpu/ops/mip.py`, function by function, in f32.  The
random draws are optional arguments: ``sample_along_rays`` takes the
uniform jitter ``u`` [R, S+1] in [0, 1) and ``sorted_piecewise_constant_pdf``
the draw ``u`` [R, num_samples] in [0, 1/num_samples - eps), the arrays
``jax.random.uniform`` returns in the JAX package; without them they come
from ``generator``.  Evenly spaced values use the JAX package's linspace
rounding (`ops/linspace.py`).

The inverse-CDF pick of ``sorted_piecewise_constant_pdf`` is a
``searchsorted`` where the JAX code builds an [R, B+1, S] comparison mask
and reduces it: the CDF is non-decreasing, so the mask ``u >= cdf[b]`` is
true on a prefix of the bins, and the max over that prefix of a
non-decreasing array (the min over the rest) is its value at the last
index of the prefix (the first index after it).  ``searchsorted(cdf, u,
right=True)`` counts that prefix, with the same ``>=`` at a CDF step
(`tests/test_torch_mipnerf.py` holds the two against each other there).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .linspace import linspace

F32_EPS = float(np.finfo(np.float32).eps)


def _scales(min_deg, max_deg, device):
    return 2.0 ** torch.arange(min_deg, max_deg, dtype=torch.float32,
                               device=device)


def _ipow(x, k: int):
    """x ** k by square-and-multiply, as ``lax.integer_pow`` rounds it
    (``torch.pow`` rounds x ** 4 and x ** 5 otherwise)."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def pos_enc(x, min_deg, max_deg, append_identity=True):
    """Classic positional encoding over degrees [min_deg, max_deg)."""
    scales = _scales(min_deg, max_deg, x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four_feat = torch.sin(torch.cat([xb, xb + 0.5 * math.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat


def expected_sin(x, x_var):
    """E[sin(z)], Var[sin(z)] for z ~ N(x, x_var)."""
    y = torch.exp(-0.5 * x_var) * torch.sin(x)
    y_var = 0.5 * (1.0 - torch.exp(-2.0 * x_var) * torch.cos(2.0 * x)) - y ** 2
    return y, torch.clamp(y_var, min=0.0)


def lift_gaussian(d, t_mean, t_var, r_var, diag=True):
    """1-D ray Gaussian -> 3-D world Gaussian (diagonal covariance)."""
    if not diag:
        raise ValueError("only the diagonal covariance is implemented")
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
    d_outer_diag = d ** 2
    null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
    t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
    xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
    return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag=True, stable=True):
    """Moments (t_mean, t_var, r_var) of a conical frustum over [t0, t1]."""
    p = _ipow
    if stable:
        mu = (t0 + t1) / 2.0
        hw = (t1 - t0) / 2.0
        common = 3.0 * p(mu, 2) + p(hw, 2)
        t_mean = mu + (2.0 * mu * p(hw, 2)) / common
        t_var = p(hw, 2) / 3.0 - (4.0 / 15.0) * (
            (p(hw, 4) * (12.0 * p(mu, 2) - p(hw, 2))) / p(common, 2)
        )
        r_var = p(base_radius, 2) * (
            p(mu, 2) / 4.0 + (5.0 / 12.0) * p(hw, 2)
            - (4.0 / 15.0) * p(hw, 4) / common
        )
    else:
        t_mean = (3.0 * (p(t1, 4) - p(t0, 4))) / (4.0 * (p(t1, 3) - p(t0, 3)))
        r_var = p(base_radius, 2) * (
            3.0 / 20.0 * (p(t1, 5) - p(t0, 5)) / (p(t1, 3) - p(t0, 3))
        )
        t_mosq = 3.0 / 5.0 * (p(t1, 5) - p(t0, 5)) / (p(t1, 3) - p(t0, 3))
        t_var = t_mosq - p(t_mean, 2)
    return t_mean, t_var, r_var


def cylinder_to_gaussian(d, t0, t1, radius, diag=True):
    t_mean = (t0 + t1) / 2.0
    r_var = radius ** 2 / 4.0
    t_var = (t1 - t0) ** 2 / 12.0
    return t_mean, t_var, r_var


def cast_rays(t_vals, origins, directions, radii, ray_shape="cone", diag=True):
    """Bin edges [R, S+1] -> per-bin Gaussians (means [R, S, 3], covs)."""
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        t_mean, t_var, r_var = conical_frustum_to_gaussian(
            directions, t0, t1, radii, diag)
    elif ray_shape == "cylinder":
        t_mean, t_var, r_var = cylinder_to_gaussian(directions, t0, t1, radii,
                                                    diag)
    else:
        raise ValueError(ray_shape)
    means, covs = lift_gaussian(directions, t_mean, t_var, r_var, diag)
    return means + origins[..., None, :], covs


def integrated_pos_enc(x_coord, min_deg, max_deg, diag=True):
    """IPE of Gaussians: sin/cos features attenuated by their variance."""
    x, x_cov_diag = x_coord
    scales = _scales(min_deg, max_deg, x.device)
    shape = x.shape[:-1] + (-1,)
    y = (x[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (x_cov_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], dim=-1),
                        torch.cat([y_var, y_var], dim=-1))[0]


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd=False):
    """Composite per-bin rgb/density to per-ray outputs.

    Returns (comp_rgb [R, 3], distance [R], acc [R], weights [R, S]).
    """
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density[..., 0] * delta
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]),
         torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)
    distance = torch.nan_to_num(
        torch.sum(weights * t_mids, dim=-1) / torch.clamp(acc, min=1e-10),
        nan=math.inf)
    distance = torch.clamp(distance, min=t_vals[..., 0], max=t_vals[..., -1])
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc, weights


def sample_along_rays(origins, directions, radii, num_samples, near, far,
                      randomized, lindisp, ray_shape="cone", u=None,
                      generator=None):
    """Stratified initial bins + cast to Gaussians; ``u`` [R, S+1] is the
    jitter (drawn from ``generator`` when randomized and not given)."""
    batch = origins.shape[0]
    t_vals = linspace(0.0, 1.0, num_samples + 1, device=origins.device)
    if lindisp:
        t_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        t_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], -1)
        lower = torch.cat([t_vals[..., :1], mids], -1)
        if u is None:
            u = torch.rand((batch, num_samples + 1), generator=generator,
                           device=origins.device)
        t_vals = lower + (upper - lower) * u
    else:
        t_vals = torch.broadcast_to(t_vals, (batch, num_samples + 1))
    means, covs = cast_rays(t_vals, origins, directions, radii, ray_shape)
    return t_vals, (means, covs)


def sorted_piecewise_constant_pdf(bins, weights, num_samples, randomized,
                                  u=None, generator=None):
    """Inverse-CDF sampling over sorted bins; ``u`` [R, num_samples] is
    the draw in [0, 1/num_samples - eps) (from ``generator`` when
    randomized and not given)."""
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)

    shape = cdf.shape[:-1] + (num_samples,)
    if randomized:
        s = 1.0 / num_samples
        steps = torch.arange(num_samples, dtype=torch.float32,
                             device=cdf.device) * s
        if u is None:
            u = torch.rand(shape, generator=generator, device=cdf.device) \
                * (s - F32_EPS)
        u = torch.clamp(steps + u, max=1.0 - F32_EPS)
    else:
        u = torch.broadcast_to(
            linspace(0.0, 1.0 - F32_EPS, num_samples, device=cdf.device), shape)

    # The last bin edge with cdf <= u and the first with cdf > u.
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(above - 1, min=0)
    above = torch.clamp(above, max=cdf.shape[-1] - 1)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    cdf_g0, cdf_g1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)

    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0), nan=0.0),
                    0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def resample_along_rays(origins, directions, radii, t_vals, weights,
                        randomized, stop_grad, resample_padding,
                        ray_shape="cone", u=None, generator=None):
    """Blurpooled resampling for the fine level; ``u`` as in
    `sorted_piecewise_constant_pdf` with num_samples = S+1."""
    w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], -1)
    w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
    w_blur = 0.5 * (w_max[..., :-1] + w_max[..., 1:])
    weights = w_blur + resample_padding

    new_t = sorted_piecewise_constant_pdf(t_vals, weights, t_vals.shape[-1],
                                          randomized, u=u, generator=generator)
    if stop_grad:
        new_t = new_t.detach()
    means, covs = cast_rays(new_t, origins, directions, radii, ray_shape)
    return new_t, (means, covs)


def convert_to_ndc(origins, directions, focal, w, h, near=1.0):
    """Shift rays into NDC space (forward-facing captures)."""
    t = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t[..., None] * directions
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]
    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    o0 = -((2 * focal) / w) * (ox / oz)
    o1 = -((2 * focal) / h) * (oy / oz)
    o2 = 1 + 2 * near / oz
    d0 = -((2 * focal) / w) * (dx / dz - ox / oz)
    d1 = -((2 * focal) / h) * (dy / dz - oy / oz)
    d2 = -2 * near / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
