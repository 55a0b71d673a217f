"""Instant-NGP training sampler: occupancy grid + fixed-budget ray marching.

Counterpart of `jnerf_tpu/models/samplers/density_grid_sampler.py`: the
grid state is a dict of tensors on the sampler's device, the march is the
static-shape candidate selection of `ops.ray_march`, the refresh is the
dense alternating-half sweep, and ``update_batch_rays`` is the same
deadband controller on the host.  The reference-faithful ``probe`` refresh
mode is not ported yet.
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.ops.composite import network_to_density, render_rays
from jnerf_tpu_torch.ops.occupancy import (
    GridConfig,
    density_grid_mean,
    ema_grid_update,
    make_grid_config,
    mark_untrained_grid,
    update_bitfield,
)
from jnerf_tpu_torch.ops.ray_march import MarchConfig, RaySamples, sample_rays
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import SAMPLERS

# Density queries per chunk of the refresh sweep (the JAX package's chunk).
SWEEP_CHUNK = 1 << 17


@SAMPLERS.register_module()
class DensityGridSampler:
    NERF_GRIDSIZE = 128

    def __init__(self, update_den_freq=16, device=None):
        cfg = get_cfg()
        if (cfg.grid_update_mode or "sweep") != "sweep":
            raise NotImplementedError(
                f"grid_update_mode={cfg.grid_update_mode!r}: only the 'sweep' "
                "refresh is ported (ROADMAP.md, port queue: probe-mode refresh)")
        self.cfg = cfg
        self.model = cfg.model_obj
        self.dataset = cfg.dataset_obj
        self.device = torch.device(device) if device is not None else None
        self.update_den_freq = update_den_freq

        self.n_rays_per_batch = int(cfg.n_rays_per_batch or 4096)
        self.target_batch_size = int(cfg.target_batch_size or (1 << 18))
        self.n_training_steps = int(cfg.n_training_steps or 16)
        # march_budget_factor over-provisions the per-ray budget S; with
        # compaction the model runs only on the compacted M samples.
        self.march_budget_factor = int(cfg.march_budget_factor or 1)
        cb = cfg.compacted_batch
        self.compacted_batch = (
            None if not cb else
            (self.target_batch_size if cb is True else int(cb))
        )
        self.const_dt = bool(cfg.const_dt)

        self.grid_config: GridConfig = make_grid_config(
            self.dataset.aabb_range,
            grid_size=cfg.grid_size or self.NERF_GRIDSIZE,
            max_steps=cfg.nerf_steps or 1024,
        )
        self.march_config = MarchConfig(
            grid=self.grid_config,
            near_distance=float(cfg.near_distance or 0.05),
            cone_angle=0.0 if self.const_dt else float(cfg.cone_angle_constant),
            const_dt=self.const_dt,
        )
        self.max_samples_per_ray = min(256, self.march_config.n_candidates)
        # Const-dt marching never probes cascades past max_cascade + 1, so
        # the bitfield pooling chain stops there.
        self._pool_hi = (
            min(self.grid_config.n_cascades - 1,
                self.grid_config.max_cascade + 1)
            if self.const_dt else None
        )
        self.n_samples_per_ray = self._samples_for_rays(self.n_rays_per_batch)
        self.inference_samples_per_ray = min(256, self.march_config.n_candidates)
        # Cross-window EMA of the measured demand per ray (host float).
        self._demand_ema: float | None = None
        self.state = None  # set by init_state()

    # ----------------------------------------------------------------- state
    def _samples_for_rays(self, n_rays: int) -> int:
        s = max(1, (self.march_budget_factor * self.target_batch_size)
                // max(n_rays, 1))
        return min(s, self.max_samples_per_ray)

    def init_state(self):
        g = self.grid_config
        gs = g.grid_size
        dev = self.device
        self.state = {
            "density_grid": torch.zeros((g.n_cascades, gs, gs, gs), device=dev),
            "bitfield": torch.zeros((g.n_cascades, gs, gs, gs), dtype=torch.bool,
                                    device=dev),
            "mean": torch.zeros((), device=dev),
            "ema_step": 0,
            "measured_batch_size": torch.zeros((), dtype=torch.int64, device=dev),
        }
        return self.state

    # ------------------------------------------------------------- sampling
    def sample_fixed(self, state, rays_o, rays_d, generator, n_samples: int,
                     u=None) -> RaySamples:
        """March rays against the current bitfield; ``u`` [R] is the
        optional injected start jitter."""
        return sample_rays(self.march_config, state["bitfield"], rays_o, rays_d,
                           generator, n_samples, u=u)

    def composite(self, samples: RaySamples, network_outputs, background=None,
                  inference=False):
        """Alpha-composite [R*S, 4] or [R, S, 4] raw outputs.  Training
        returns rgb [R, 3] with the background over the leftover
        transmittance of every ray; inference returns (rgb, opacity [R])
        with no background term."""
        r, s = samples.dts.shape
        raw = network_outputs.reshape(r, s, 4)
        if inference:
            return render_rays(raw, samples.dts, samples.valid)
        rgb, _ = render_rays(raw, samples.dts, samples.valid, None, background)
        return rgb

    # ----------------------------------------------------------- grid update
    def update_density_grid_fn(self, state, first_step: bool, generator=None,
                               jitter=None):
        """Dense alternating-half sweep refresh (the JAX package's
        ``_sweep_refresh``): one jittered density sample in every cell of
        an alternating half of each active cascade (the whole grid on the
        step-0 refresh), then the decay-max EMA and the bitfield.

        ``jitter`` [n_casc, 3, n_sweep] in [0, 1), if given, replaces the
        draws from ``generator``.
        """
        g = self.grid_config
        gs = g.grid_size
        grid = state["density_grid"]
        dev = grid.device
        if first_step:
            grid = mark_untrained_grid(
                self.dataset.transforms_gpu,
                self.dataset.focal_lengths,
                self.dataset.resolution,
                g,
            )
        n_casc = g.max_cascade + 1
        n_sweep = g.n_cells if first_step else g.n_cells // 2
        base = 0 if first_step else (state["ema_step"] % 2) * (g.n_cells // 2)
        if jitter is None:
            jitter = torch.rand((n_casc, 3, n_sweep), generator=generator,
                                device=dev)

        lin = torch.arange(n_sweep, dtype=torch.int64, device=dev) + base
        comps = (lin // (gs * gs), (lin // gs) % gs, lin % gs)
        parts = []
        for c in range(n_casc):
            mip_scale = float(2.0 ** c)
            parts.append(torch.stack([
                ((comp.to(torch.float32) + jitter[c, d]) / gs - 0.5)
                * mip_scale + 0.5
                for d, comp in enumerate(comps)], dim=-1))
        world_pos = torch.cat(parts, dim=0)  # [n_casc * n_sweep, 3]
        warped = (world_pos - g.aabb_min) / g.aabb_diag

        raw = self._chunked_density(warped)
        thickness = network_to_density(raw) * g.stepsize

        flat_tmp = torch.zeros(grid.numel(), device=dev)
        for c in range(n_casc):
            lo = c * g.n_cells + base
            flat_tmp[lo:lo + n_sweep] = thickness[c * n_sweep:(c + 1) * n_sweep]
        grid = ema_grid_update(grid, flat_tmp.reshape(grid.shape), g)
        mean = density_grid_mean(grid, g)
        return {
            "density_grid": grid,
            "bitfield": update_bitfield(grid, mean, g, self._pool_hi),
            "mean": mean,
            "ema_step": state["ema_step"] + 1,
            "measured_batch_size": state["measured_batch_size"],
        }

    @torch.no_grad()
    def _chunked_density(self, warped):
        """Raw density [n] of warped positions [n, 3], in chunks of
        SWEEP_CHUNK queries so that peak memory stays bounded."""
        return torch.cat([
            self.model.density(warped[i:i + SWEEP_CHUNK])[:, 0]
            for i in range(0, warped.shape[0], SWEEP_CHUNK)
        ])

    def update_density_grid(self, training_step=0, generator=None, jitter=None):
        """Refresh ``self.state`` in place of the old one."""
        self.state = self.update_density_grid_fn(
            self.state, first_step=(training_step == 0), generator=generator,
            jitter=jitter)
        return self.state

    # ----------------------------------------------------- batch adaptation
    def update_batch_rays(self, measured, n_steps=None, rays_then=None):
        """Retune (n_rays, samples/ray) from a measured sample count.

        ``measured`` is the demand counted over ``n_steps`` steps run at
        ``rays_then`` rays each.  The demand per ray is smoothed across
        windows, and the ray count moves one octave toward the implied
        shape only when it is ~35% past the octave's sqrt(2) edge (ratio
        1.9): the JAX package's deadband controller, which keeps demand
        noise from flipping shapes every window.  Returns True if the
        shapes changed.
        """
        if rays_then is None:
            rays_then = self.n_rays_per_batch
        measured = max(measured / (n_steps or self.n_training_steps), 1.0)
        demand_per_ray = measured / max(rays_then, 1)
        if self._demand_ema is None:
            self._demand_ema = demand_per_ray
        else:
            self._demand_ema = 0.5 * self._demand_ema + 0.5 * demand_per_ray
        implied = self.target_batch_size / max(self._demand_ema, 1.0)
        # Floor S at 16 by capping rays at target/16.
        lo, hi = 128, max(128, self.target_batch_size // 16)
        implied = max(lo, min(hi, implied))
        ratio = implied / self.n_rays_per_batch
        if ratio >= 1.9:
            new_rays = min(self.n_rays_per_batch * 2, hi)
        elif ratio <= 1 / 1.9:
            new_rays = max(self.n_rays_per_batch // 2, lo)
        else:
            new_rays = self.n_rays_per_batch
        # Clamp so that a starting shape outside [lo, hi] converges.
        new_rays = max(lo, min(hi, new_rays))
        changed = new_rays != self.n_rays_per_batch
        self.n_rays_per_batch = new_rays
        self.n_samples_per_ray = self._samples_for_rays(new_rays)
        self.dataset.batch_size = new_rays
        return changed

    # ---------------------------------------------------------- persistence
    def state_dict(self):
        if self.state is None:
            raise RuntimeError("call init_state() first")
        return {
            "density_grid": self.state["density_grid"].cpu().numpy(),
            "bitfield": self.state["bitfield"].cpu().numpy(),
            "mean": self.state["mean"].cpu().numpy(),
            "ema_step": int(self.state["ema_step"]),
            "n_rays_per_batch": self.n_rays_per_batch,
            "demand_ema": self._demand_ema,
        }

    def load_state_dict(self, sd):
        dev = self.device
        self.state = {
            "density_grid": torch.tensor(sd["density_grid"], dtype=torch.float32,
                                         device=dev),
            "bitfield": torch.tensor(sd["bitfield"], dtype=torch.bool, device=dev),
            "mean": torch.tensor(sd["mean"], dtype=torch.float32, device=dev),
            "ema_step": int(sd["ema_step"]),
            "measured_batch_size": torch.zeros((), dtype=torch.int64, device=dev),
        }
        if "n_rays_per_batch" in sd:
            self.n_rays_per_batch = int(sd["n_rays_per_batch"])
            self.n_samples_per_ray = self._samples_for_rays(self.n_rays_per_batch)
        if sd.get("demand_ema") is not None:
            self._demand_ema = float(sd["demand_ema"])
        return self.state
