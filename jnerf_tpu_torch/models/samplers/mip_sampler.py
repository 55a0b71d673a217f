"""Mip-NeRF sampler: per-level cone-cast sampling and volumetric rendering.

Counterpart of `jnerf_tpu/models/samplers/mip_sampler.py`: ``sample``
turns one level's rays into IPE-encoded Gaussians (the coarse level's
stratified bins, or the fine level's resampling of the previous level's
``t_vals`` and ``weights``), ``rays2rgb`` applies the activations and
composites.  The density activation is ``logaddexp(x + bias, 0)``, as
``jax.nn.softplus`` computes it (torch's ``softplus`` switches to the
identity above a threshold).  Random draws are optional arguments: ``u``,
the level's uniform draw (`ops/mip.py`), and ``noise``, the standard
normal draw of ``density_noise`` [R, S, 1]; without them they come from
``generator``.
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.ops.mip import (
    integrated_pos_enc,
    pos_enc,
    resample_along_rays,
    sample_along_rays,
    volumetric_rendering,
)
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import SAMPLERS


@SAMPLERS.register_module()
class MipSampler:
    def __init__(self):
        cfg = get_cfg()
        self.num_samples = cfg.num_samples or 128
        self.min_deg_point = cfg.min_deg_point or 0
        self.max_deg_point = cfg.max_deg_point or 8
        self.deg_view = cfg.deg_view or 4
        self.ray_shape = cfg.ray_shape or "cone"
        self.lindisp = bool(cfg.lindisp)
        self.randomized = bool(cfg.randomized)
        self.disable_integration = bool(cfg.disable_integration)
        self.stop_level_grad = bool(cfg.stop_level_grad)
        self.resample_padding = cfg.resample_padding or 0.01
        self.density_bias = (cfg.density_bias if cfg.density_bias is not None
                             else -1.0)
        self.density_noise = cfg.density_noise or 0.0
        self.rgb_padding = (cfg.rgb_padding if cfg.rgb_padding is not None
                            else 0.001)
        self.white_bkgd = bool(cfg.white_bkgd)

    def sample(self, rays, i_level, t_vals=None, weights=None, randomized=None,
               u=None, generator=None):
        """One level's samples: returns (samples_enc, viewdirs_enc, t_vals)."""
        randomized = self.randomized if randomized is None else randomized
        if i_level == 0:
            t_vals, (means, covs) = sample_along_rays(
                rays.origins, rays.directions, rays.radii, self.num_samples,
                rays.near, rays.far, randomized, self.lindisp, self.ray_shape,
                u=u, generator=generator)
        else:
            t_vals, (means, covs) = resample_along_rays(
                rays.origins, rays.directions, rays.radii, t_vals, weights,
                randomized, self.stop_level_grad, self.resample_padding,
                self.ray_shape, u=u, generator=generator)
        if self.disable_integration:
            covs = torch.zeros_like(covs)
        samples_enc = integrated_pos_enc((means, covs), self.min_deg_point,
                                         self.max_deg_point)
        viewdirs_enc = pos_enc(rays.viewdirs, 0, self.deg_view, True)
        return samples_enc, viewdirs_enc, t_vals

    def rays2rgb(self, rays, raw_rgb, raw_density, t_vals, randomized=None,
                 noise=None, generator=None):
        """Activations + compositing; returns (rgb, distance, acc, weights)."""
        randomized = self.randomized if randomized is None else randomized
        if randomized and self.density_noise > 0:
            if noise is None:
                noise = torch.randn(raw_density.shape, generator=generator,
                                    device=raw_density.device)
            raw_density = raw_density + self.density_noise * noise
        rgb = torch.sigmoid(raw_rgb)
        rgb = rgb * (1.0 + 2.0 * self.rgb_padding) - self.rgb_padding
        z = raw_density + self.density_bias
        density = torch.logaddexp(z, z.new_zeros(()))
        return volumetric_rendering(rgb, density, t_vals, rays.directions,
                                    self.white_bkgd)
