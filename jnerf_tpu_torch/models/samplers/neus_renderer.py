"""NeuS SDF volume renderer: sigmoid-CDF importance sampling and
s-density compositing.

Counterpart of `jnerf_tpu/models/samplers/neus_renderer.py` (the
reference's `renderer.py`: ``sample_pdf`` :40-70, ``render_core_outside``
:96-135, ``up_sample`` :137-181, ``cat_z_vals`` :183-197, ``render_core``
:199-292, ``render`` :294-393).  Shapes are static: the up-sample rounds
add fixed batches of samples.  The random draws (the inverse-CDF
positions, the depth jitter ``t_rand`` and the background jitter ``t_r``)
come from a ``torch.Generator`` unless passed in.  Linspaces round as
JAX's do (`ops/linspace.py`).
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.models.networks.neus_network import softplus
from jnerf_tpu_torch.ops.composite import _Cumprod
from jnerf_tpu_torch.ops.linspace import linspace
from jnerf_tpu_torch.utils.registry import SAMPLERS


def searchsorted_right(cdf, u):
    """Per row, the number of entries of ``cdf`` [R, B] that are <= each
    ``u`` [R, S]: ``jnp.searchsorted(c, u, side='right')`` under vmap, so
    that a ``u`` equal to a CDF step lands past it."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)


def sample_pdf(bins, weights, n_samples, det=False, u=None, generator=None):
    """Inverse-CDF sampling of ``n_samples`` positions per row from ``bins``
    [R, B] with ``weights`` [R, B - 1] (`renderer.py:40-70`).  ``u``
    [R, n_samples] in [0, 1) is drawn from ``generator`` unless given or
    ``det`` (then evenly spaced)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [R, B]
    if u is None:
        shape = (*cdf.shape[:-1], n_samples)
        if det:
            u = linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                         device=cdf.device).expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)

    inds = searchsorted_right(cdf, u)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_b = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_a = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def _cumprod_exclusive(alpha):
    """T_i = prod_{j<i} (1 - alpha_j + 1e-6); returns weights alpha * T.
    The factors are at least 1e-6 (alpha <= 1), so the product goes through
    `_Cumprod`, whose backward reads nothing back from the device."""
    t = _Cumprod.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-6], -1)
    )[..., :-1]
    return alpha * t


@SAMPLERS.register_module()
class NeuSRenderer:
    def __init__(self, n_samples, n_importance, n_outside, up_sample_steps,
                 perturb):
        self.network = None  # set by set_neus_network
        self.n_samples = n_samples
        self.n_importance = n_importance
        self.n_outside = n_outside
        self.up_sample_steps = up_sample_steps
        self.perturb = perturb

    def set_neus_network(self, neus_network):
        self.network = neus_network

    # ------------------------------------------------------------ pieces
    @torch.no_grad()
    def up_sample(self, rays_o, rays_d, z_vals, sdf, n_importance, inv_s):
        """New depths from the sigmoid-CDF alpha of the current ones
        (`renderer.py:137-181`); no gradient flows through them."""
        batch = z_vals.shape[0]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        radius = torch.linalg.norm(pts, dim=-1)
        inside = (radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)
        prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
        prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
        mid_sdf = (prev_sdf + next_sdf) * 0.5
        cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
        prev_cos = torch.cat([torch.zeros((batch, 1), device=z_vals.device),
                              cos_val[:, :-1]], -1)
        cos_val = torch.minimum(prev_cos, cos_val)
        cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside

        dist = next_z - prev_z
        prev_esti = mid_sdf - cos_val * dist * 0.5
        next_esti = mid_sdf + cos_val * dist * 0.5
        prev_cdf = torch.sigmoid(prev_esti * inv_s)
        next_cdf = torch.sigmoid(next_esti * inv_s)
        alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
        weights = _cumprod_exclusive(alpha)
        return sample_pdf(z_vals, weights, n_importance, det=True)

    @torch.no_grad()
    def cat_z_vals(self, rays_o, rays_d, z_vals, new_z_vals, sdf, last=False):
        """Merge new depths into the sorted ones, with their sdf unless
        ``last``."""
        batch = z_vals.shape[0]
        z_all, order = torch.sort(torch.cat([z_vals, new_z_vals], -1), dim=-1,
                                  stable=True)
        if not last:
            pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
            new_sdf = self.network.sdf_network.sdf(
                pts.reshape(-1, 3)).reshape(batch, -1)
            sdf = torch.gather(torch.cat([sdf, new_sdf], -1), -1, order)
        return z_all, sdf

    def render_core_outside(self, rays_o, rays_d, z_vals, sample_dist,
                            background_rgb=None):
        """The NeRF++ background over inverted-sphere coordinates
        (`renderer.py:96-135`)."""
        batch, n = z_vals.shape
        dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                           torch.full((batch, 1), sample_dist,
                                      device=z_vals.device)], -1)
        mid_z = z_vals + dists * 0.5
        pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
        dis = torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True),
                          1.0, 1e5)
        pts4 = torch.cat([pts / dis, 1.0 / dis], -1)
        dirs = rays_d[:, None, :].expand(pts.shape)

        density, color = self.network.nerf_outside(pts4.reshape(-1, 4),
                                                   dirs.reshape(-1, 3))
        color = torch.sigmoid(color).reshape(batch, n, 3)
        alpha = 1.0 - torch.exp(-softplus(density.reshape(batch, n)) * dists)
        weights = _cumprod_exclusive(alpha)
        out_color = torch.sum(weights[..., None] * color, dim=1)
        if background_rgb is not None:
            out_color = out_color + background_rgb * (
                1.0 - torch.sum(weights, -1, keepdim=True))
        return {"color": out_color, "sampled_color": color, "alpha": alpha}

    def render_core(self, rays_o, rays_d, z_vals, sample_dist,
                    background_alpha=None, background_sampled_color=None,
                    background_rgb=None, cos_anneal_ratio=0.0):
        """s-density compositing and the eikonal error (`renderer.py:199-292`)."""
        batch, n = z_vals.shape
        net = self.network
        dists = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                           torch.full((batch, 1), sample_dist,
                                      device=z_vals.device)], -1)
        mid_z = z_vals + dists * 0.5
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]
               ).reshape(-1, 3)
        dirs = rays_d[:, None, :].expand(batch, n, 3).reshape(-1, 3)

        sdf_out, gradients = net.sdf_network.sdf_and_gradient(pts)
        sdf = sdf_out[:, :1]
        feature = sdf_out[:, 1:]
        sampled_color = net.color_network(pts, gradients, dirs,
                                          feature).reshape(batch, n, 3)

        inv_s = torch.clamp(net.deviation_network.inv_s(), 1e-6, 1e6)
        true_cos = torch.sum(dirs * gradients, -1, keepdim=True)
        # The annealed non-positive cos estimator (`renderer.py:237-240`).
        iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                     + torch.relu(-true_cos) * cos_anneal_ratio)
        est_next = sdf + iter_cos * dists.reshape(-1, 1) * 0.5
        est_prev = sdf - iter_cos * dists.reshape(-1, 1) * 0.5
        prev_cdf = torch.sigmoid(est_prev * inv_s)
        next_cdf = torch.sigmoid(est_next * inv_s)
        alpha = torch.clamp(
            ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).reshape(batch, n),
            0.0, 1.0)

        pts_norm = torch.linalg.norm(pts.detach(), dim=-1).reshape(batch, n)
        inside = (pts_norm < 1.0).float()
        relax_inside = (pts_norm < 1.2).float()

        if background_alpha is not None:
            alpha = alpha * inside + background_alpha[:, :n] * (1.0 - inside)
            alpha = torch.cat([alpha, background_alpha[:, n:]], -1)
            sampled_color = (sampled_color * inside[..., None]
                             + background_sampled_color[:, :n]
                             * (1.0 - inside)[..., None])
            sampled_color = torch.cat(
                [sampled_color, background_sampled_color[:, n:]], dim=1)

        weights = _cumprod_exclusive(alpha)
        weights_sum = torch.sum(weights, -1, keepdim=True)
        color = torch.sum(sampled_color * weights[..., None], dim=1)
        if background_rgb is not None:
            color = color + background_rgb * (1.0 - weights_sum)

        grad_err = (torch.linalg.norm(gradients.reshape(batch, n, 3), dim=-1)
                    - 1.0) ** 2
        grad_err = (torch.sum(relax_inside * grad_err)
                    / (torch.sum(relax_inside) + 1e-5))
        return {
            "color": color,
            "sdf": sdf,
            "gradients": gradients.reshape(batch, n, 3),
            "s_val": 1.0 / inv_s,
            "alpha": alpha,
            "weights": weights,
            "cdf": prev_cdf.reshape(batch, n),
            "gradient_error": grad_err,
            "inside_sphere": inside,
        }

    # ------------------------------------------------------------ render
    def render(self, rays_o, rays_d, near, far, perturb_overwrite=-1,
               background_rgb=None, cos_anneal_ratio=0.0, generator=None,
               t_rand=None, t_r=None):
        """Render rays [B, 3] between near and far [B, 1].  With
        perturbation, ``t_rand`` [B, 1] (the depth jitter is t_rand - 0.5
        steps) and ``t_r`` [B, n_outside] (the background depths' place in
        their intervals), both uniform in [0, 1), are drawn from
        ``generator`` unless given."""
        batch = rays_o.shape[0]
        dev = rays_o.device
        sample_dist = 2.0 / self.n_samples
        z_vals = near + (far - near) * linspace(0.0, 1.0, self.n_samples,
                                                device=dev)[None, :]
        perturb = self.perturb if perturb_overwrite < 0 else perturb_overwrite
        z_vals_outside = None
        if self.n_outside > 0:
            z_vals_outside = linspace(1e-3, 1.0 - 1.0 / (self.n_outside + 1.0),
                                      self.n_outside, device=dev)
        if perturb > 0:
            if t_rand is None:
                t_rand = torch.rand((batch, 1), generator=generator, device=dev)
            z_vals = z_vals + (t_rand - 0.5) * 2.0 / self.n_samples
            if self.n_outside > 0:
                mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
                upper = torch.cat([mids, z_vals_outside[-1:]])
                lower = torch.cat([z_vals_outside[:1], mids])
                if t_r is None:
                    t_r = torch.rand((batch, self.n_outside),
                                     generator=generator, device=dev)
                z_vals_outside = lower[None, :] + (upper - lower)[None, :] * t_r
        if self.n_outside > 0:
            if z_vals_outside.dim() == 1:
                z_vals_outside = z_vals_outside[None, :].expand(
                    batch, self.n_outside)
            z_vals_outside = (far / torch.flip(z_vals_outside, [-1])
                              + 1.0 / self.n_samples)

        background_alpha = None
        background_sampled_color = None
        if self.n_importance > 0:
            with torch.no_grad():
                pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
                sdf = self.network.sdf_network.sdf(
                    pts.reshape(-1, 3)).reshape(batch, self.n_samples)
                for i in range(self.up_sample_steps):
                    new_z = self.up_sample(
                        rays_o, rays_d, z_vals, sdf,
                        self.n_importance // self.up_sample_steps, 64 * 2 ** i)
                    z_vals, sdf = self.cat_z_vals(
                        rays_o, rays_d, z_vals, new_z, sdf,
                        last=(i + 1 == self.up_sample_steps))
            z_vals = z_vals.detach()

        if self.n_outside > 0:
            z_feed, _ = torch.sort(torch.cat([z_vals, z_vals_outside], -1),
                                   dim=-1)
            ret_out = self.render_core_outside(rays_o, rays_d, z_feed,
                                               sample_dist)
            background_sampled_color = ret_out["sampled_color"]
            background_alpha = ret_out["alpha"]

        ret = self.render_core(
            rays_o, rays_d, z_vals, sample_dist,
            background_alpha=background_alpha,
            background_sampled_color=background_sampled_color,
            background_rgb=background_rgb,
            cos_anneal_ratio=cos_anneal_ratio)
        weights = ret["weights"]
        return {
            "color_fine": ret["color"],
            "s_val": torch.mean(ret["s_val"]) * torch.ones((batch, 1),
                                                           device=dev),
            "cdf_fine": ret["cdf"],
            "weight_sum": torch.sum(weights, -1, keepdim=True),
            "weight_max": torch.max(weights, -1, keepdim=True).values,
            "sdf": ret["sdf"],
            "gradients": ret["gradients"],
            "alpha": ret["alpha"],
            "z_vals": z_vals,
            "weights": weights,
            "gradient_error": ret["gradient_error"],
            "inside_sphere": ret["inside_sphere"],
        }

    # ---------------------------------------------------------- geometry
    @torch.no_grad()
    def extract_geometry(self, bound_min, bound_max, resolution, threshold=0.0):
        """The -sdf = ``threshold`` surface over the box as (vertices,
        triangles), the field evaluated on the network's device."""
        from jnerf_tpu_torch.ops.marching import extract_geometry

        sdf_net = self.network.sdf_network
        device = next(sdf_net.parameters()).device
        return extract_geometry(
            bound_min, bound_max, resolution, threshold,
            lambda pts: -sdf_net.sdf(pts)[:, 0], device=device)
