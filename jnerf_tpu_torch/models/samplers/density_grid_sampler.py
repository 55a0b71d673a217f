"""Instant-NGP training sampler: occupancy grid + fixed-budget ray marching.

Counterpart of `jnerf_tpu/models/samplers/density_grid_sampler.py`: the
grid state is a dict of tensors on the sampler's device, the march is the
static-shape candidate selection of `ops.ray_march`, the refresh is the
dense alternating-half sweep (``grid_update_mode='sweep'``, the default)
or the reference's sampled probe refresh (``'probe'``), and
``update_batch_rays`` is the same deadband controller on the host.
``sample`` and ``rays2rgb`` keep the reference's eager signatures.

Under a mesh (``self.mesh``, set by ``Runner.mesh``; `jnerf_tpu_torch.parallel`)
each rank runs the refresh's density queries on its slice of the query
axis and the results are gathered, so that every rank holds the same grid;
the refresh's random draws are made at their global shape on every rank.
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.ops.composite import network_to_density, render_rays
from jnerf_tpu_torch.ops.occupancy import (
    GridConfig,
    density_grid_mean,
    ema_grid_update,
    generate_grid_samples,
    make_grid_config,
    mark_untrained_grid,
    splat_density,
    update_bitfield,
)
from jnerf_tpu_torch.ops.ray_march import MarchConfig, RaySamples, sample_rays
from jnerf_tpu_torch.parallel import replicated, shard_rays
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import SAMPLERS

# Density queries per chunk of the refresh sweep (the JAX package's chunk).
SWEEP_CHUNK = 1 << 17


@SAMPLERS.register_module()
class DensityGridSampler:
    NERF_GRIDSIZE = 128
    NERF_MIN_OPTICAL_THICKNESS = 0.01

    def __init__(self, update_den_freq=16, device=None):
        cfg = get_cfg()
        self.grid_update_mode = cfg.grid_update_mode or "sweep"
        if self.grid_update_mode not in ("sweep", "probe"):
            raise ValueError(
                f"grid_update_mode={cfg.grid_update_mode!r}: 'sweep' or 'probe'")
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
        self.background_color = list(cfg.background_color or [0, 0, 0])

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
        self.mesh = None  # a parallel.Mesh, set by Runner.mesh
        self._last_samples: RaySamples | None = None  # kept by sample()

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

    # -------------------------------------------------- reference-shaped API
    def sample(self, img_ids, rays_o, rays_d, rgb_target=None,
               is_training=False, generator=None, u=None):
        """March rays [R, 3] at the training (``is_training``) or the
        inference budget, keep the samples for ``rays2rgb`` and return
        (positions, dirs) flattened to [R*S, 3], like the reference's
        compacted coordinate buffers.  A training march adds its demand to
        the measured batch size.  ``u`` [R] is the start jitter, drawn from
        ``generator`` unless given; ``img_ids`` and ``rgb_target`` are
        accepted for the reference's signature and not used."""
        del img_ids, rgb_target
        if self.state is None:
            raise RuntimeError("call init_state() first")
        n = (self.n_samples_per_ray if is_training
             else self.inference_samples_per_ray)
        samples = self.sample_fixed(self.state, rays_o, rays_d, generator, n,
                                    u=u)
        self._last_samples = samples
        if is_training:
            self.state["measured_batch_size"] = (
                self.state["measured_batch_size"] + samples.count.sum())
        r, s = samples.dts.shape
        return samples.positions.reshape(r * s, 3), samples.dirs.reshape(r * s, 3)

    def rays2rgb(self, network_outputs, training_background_color=None,
                 inference=False):
        """Composite the raw outputs [R*S, 4] of the last ``sample``'s
        positions: rgb [R, 3] over ``training_background_color`` (the
        config's background colour unless given), or with ``inference``
        (rgb, opacity) with no background term."""
        if self._last_samples is None:
            raise RuntimeError("call sample() first")
        if inference:
            return self.composite(self._last_samples, network_outputs,
                                  inference=True)
        bg = training_background_color
        if bg is None:
            bg = torch.tensor(self.background_color, dtype=torch.float32,
                              device=network_outputs.device)
        return self.composite(self._last_samples, network_outputs,
                              background=bg)

    # ----------------------------------------------------------- grid update
    def update_density_grid_fn(self, state, first_step: bool, generator=None,
                               jitter=None, n_uniform: int = 0,
                               n_nonuniform: int = 0):
        """One grid refresh: new density samples, the decay-max EMA and the
        bitfield (the JAX package's ``update_density_grid_fn``).

        'sweep': one jittered density sample in every cell of an
        alternating half of each active cascade (the whole grid on the
        step-0 refresh); ``jitter`` [n_casc, 3, n_sweep] in [0, 1), if
        given, replaces the draws from ``generator``.  'probe': the
        reference's sampled refresh, ``n_uniform`` cells probed at density
        > -0.01 and ``n_nonuniform`` at > 0.01 (`grid_update_counts`),
        max-splatted; ``jitter``, if given, is a list of (level [n],
        jitter [3, n]) draws, one for each nonzero count in that order.
        """
        g = self.grid_config
        grid = state["density_grid"]
        if first_step:
            grid = mark_untrained_grid(
                self.dataset.transforms_gpu,
                self.dataset.focal_lengths,
                self.dataset.resolution,
                g,
            )
        if self.grid_update_mode == "sweep":
            grid_tmp = self._sweep_samples(state, grid, first_step, generator,
                                           jitter)
        else:
            grid_tmp = self._probe_samples(state, grid, generator, jitter,
                                           n_uniform, n_nonuniform)
        grid = ema_grid_update(grid, grid_tmp, g)
        mean = density_grid_mean(grid, g)
        return {
            "density_grid": grid,
            "bitfield": update_bitfield(grid, mean, g, self._pool_hi),
            "mean": mean,
            "ema_step": state["ema_step"] + 1,
            "measured_batch_size": state["measured_batch_size"],
        }

    def _sweep_samples(self, state, grid, first_step, generator, jitter):
        """The sweep's new densities [C, G, G, G] (0 where not swept)."""
        g = self.grid_config
        gs = g.grid_size
        dev = grid.device
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
        return flat_tmp.reshape(grid.shape)

    def _probe_samples(self, state, grid, generator, draws, n_uniform,
                       n_nonuniform):
        """The probe refresh's max-splatted new densities [C, G, G, G]."""
        g = self.grid_config
        counts = [(n, thresh) for n, thresh in
                  ((n_uniform, -0.01),
                   (n_nonuniform, self.NERF_MIN_OPTICAL_THICKNESS)) if n]
        if draws is None:
            draws = [(None, None)] * len(counts)
        if len(draws) != len(counts):
            raise ValueError(f"{len(draws)} probe draws for {len(counts)} "
                             "sample sets")
        idx_parts, comp_parts = [], []
        for (n, thresh), (level, jit) in zip(counts, draws):
            idx, comps = generate_grid_samples(
                grid, state["ema_step"], n, thresh, g, generator=generator,
                level=level, jitter=jit)
            idx_parts.append(idx)
            comp_parts.append(comps)
        # Warp to aabb-relative coordinates, where the encoder is defined.
        warped = torch.stack([
            (torch.cat([c[d] for c in comp_parts]) - g.aabb_min) / g.aabb_diag
            for d in range(3)], dim=-1)
        raw = self._chunked_density(warped)
        return splat_density(torch.cat(idx_parts), raw, torch.zeros_like(grid),
                             g)

    @torch.no_grad()
    def _chunked_density(self, warped):
        """Raw density [n] of warped positions [n, 3], in chunks of
        SWEEP_CHUNK queries so that peak memory stays bounded; under a
        mesh, each rank queries its slice and the slices are gathered."""
        local = shard_rays(warped, self.mesh)
        raw = torch.cat([
            self.model.density(local[i:i + SWEEP_CHUNK])[:, 0]
            for i in range(0, local.shape[0], SWEEP_CHUNK)
        ])
        return replicated(raw, self.mesh, warped.shape[0])

    def grid_update_counts(self, training_step: int):
        """(n_uniform, n_nonuniform) cells a probe refresh samples
        (`update_density_grid`, :255-263): every active cell before step
        256, then a quarter of them each way."""
        n_cells = self.grid_config.n_cells * (self.grid_config.max_cascade + 1)
        if training_step < 256:
            return n_cells, 0
        return n_cells // 4, n_cells // 4

    def update_density_grid(self, training_step=0, generator=None, jitter=None):
        """Refresh ``self.state`` in place of the old one."""
        n_u, n_n = self.grid_update_counts(training_step)
        self.state = self.update_density_grid_fn(
            self.state, first_step=(training_step == 0), generator=generator,
            jitter=jitter, n_uniform=n_u, n_nonuniform=n_n)
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
