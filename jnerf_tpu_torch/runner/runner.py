"""NGP training runner.

Counterpart of the training half of `jnerf_tpu/runner/runner.py`: the
same components built from the same config, the same step (pixel sampling
-> ray march -> compaction -> model -> composite -> loss -> Adam -> EMA),
the same grid-refresh cadence and the same one-window-lagged batch
adaptation.  The JAX package chains a refresh window of steps in one
``lax.scan``; here the window is a Python loop of eager steps.  All random
draws come from one ``torch.Generator`` on the runner's device, and the
step takes injected draws so that a test can feed it the JAX package's.

Rendering, test/validation images and checkpoints are not ported yet.
"""

from __future__ import annotations

import torch

from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
from jnerf_tpu_torch.ops.compact import compact_indices, render_rays_compact
from jnerf_tpu_torch.ops.composite import density_l1_reg, render_rays
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import (
    DATASETS,
    LOSSES,
    NETWORKS,
    OPTIMS,
    SAMPLERS,
    build_from_cfg,
)

# Relative strength of the reference's early-training negative-density push
# (`calc_rgb.h:112,141`) in mean-loss units, as in the JAX package.
DENSITY_L1_COEF = 1e-4 / 384.0


class Runner:
    def __init__(self, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Runner(device={str(device)!r}): CUDA is not "
                               "available")
        self.device = device
        cfg = get_cfg()
        self.cfg = cfg
        seed = cfg.seed if cfg.seed is not None else 42
        self.generator = torch.Generator(device).manual_seed(seed)

        self.dataset = {"train": build_from_cfg(cfg.dataset.train, DATASETS,
                                                device=device)}
        cfg.dataset_obj = self.dataset["train"]
        self.model = build_from_cfg(cfg.model, NETWORKS, device=device,
                                    generator=self.generator)
        cfg.model_obj = self.model
        self.sampler = build_from_cfg(cfg.sampler, SAMPLERS, device=device)
        cfg.sampler_obj = self.sampler
        self.loss_func = build_from_cfg(cfg.loss, LOSSES)

        adam = build_from_cfg(cfg.optim, OPTIMS)
        self.expdecay = (build_from_cfg(cfg.expdecay, OPTIMS,
                                        nested_optimizer=adam)
                         if cfg.expdecay else adam)
        self.params = list(self.model.parameters())
        self.optimizer = self.expdecay.make(self.params)
        self.ema = build_from_cfg(cfg.ema, OPTIMS) if cfg.ema else None
        self.ema_state = self.ema.init(self.params) if self.ema else None

        self.tot_train_steps = cfg.tot_train_steps
        self.sampler.init_state()
        self.start = 0
        cfg.m_training_step = 0
        # (host counter, event, n_steps, n_rays_then) of the last finished
        # window, consumed by the lagged batch adaptation in train_range.
        self._pending_adapt = None

    # ------------------------------------------------------------------ step
    def forward_loss(self, n_rays: int, n_samples: int, idx=None, bg=None,
                     u=None):
        """Loss of one training batch, differentiable in the model's params.

        ``idx`` [R] (flat pixel indices), ``bg`` [R, 3] (random background)
        and ``u`` [R] (march start jitter) are drawn from the runner's
        generator unless given.  Returns (total, main, samples): total =
        main + the early-training density regularizer.
        """
        ds = self.dataset["train"]
        dev, gen = self.device, self.generator
        n_pixels = ds.n_images * ds.H * ds.W
        if idx is None:
            idx = torch.randint(0, n_pixels, (n_rays,), generator=gen, device=dev)
        _img_ids, rays_o, rays_d = rays_from_pixels(
            idx, ds.transforms_gpu, ds.focal_lengths, ds.principal_points,
            ds.W, ds.H)
        rgba = ds.image_data[idx]
        if bg is None:
            bg = torch.rand((n_rays, 3), generator=gen, device=dev)
        target = rgba[:, :3] * rgba[:, 3:] + bg * (1.0 - rgba[:, 3:])

        grid_state = self.sampler.state
        samples = self.sampler.sample_fixed(grid_state, rays_o, rays_d, gen,
                                            n_samples, u=u)
        m_compact = self.sampler.compacted_batch
        if m_compact is not None and n_rays * n_samples > m_compact:
            # Ragged compaction: the model runs on the M kept samples.
            info = compact_indices(samples.valid, m_compact)
            pos_c = samples.positions.reshape(-1, 3)[info.idx]
            dirs_c = samples.dirs.reshape(-1, 3)[info.idx]
            dts_c = torch.where(info.slot_valid,
                                samples.dts.reshape(-1)[info.idx],
                                torch.zeros((), device=dev))
            raw = self.model(pos_c, dirs_c)
            rgb, _ = render_rays_compact(raw, dts_c, info, background=bg)
            reg_sigma, reg_valid = raw[:, 3], info.slot_valid
        else:
            raw = self.model(samples.positions.reshape(-1, 3),
                             samples.dirs.reshape(-1, 3))
            rgb, _ = render_rays(raw.reshape(n_rays, n_samples, 4),
                                 samples.dts, samples.valid, None, bg)
            reg_sigma = raw[:, 3].reshape(n_rays, n_samples)
            reg_valid = samples.valid
        main = torch.mean(self.loss_func(rgb, target))
        reg = density_l1_reg(reg_sigma, reg_valid, grid_state["mean"],
                             DENSITY_L1_COEF)
        return main + reg, main, samples

    def train_step(self, idx=None, bg=None, u=None):
        """One optimizer step at the sampler's current shapes; returns the
        main loss (a 0-dim device tensor)."""
        total, main, samples = self.forward_loss(
            self.sampler.n_rays_per_batch, self.sampler.n_samples_per_ray,
            idx=idx, bg=bg, u=u)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        if self.ema is not None:
            self.ema.step(self.params, self.ema_state)
        state = self.sampler.state
        state["measured_batch_size"] = (state["measured_batch_size"]
                                        + samples.count.sum())
        return main.detach()

    # ------------------------------------------------------- window training
    def train_range(self, start: int, end: int):
        """Train steps [start, end) with grid refreshes and batch adaptation.

        A refresh runs when ``i % update_den_freq == 0``; the steps up to
        the next refresh form a window of one shape.  At each window's end
        the batch shape adapts to the PREVIOUS window's measured demand,
        whose device-to-host copy finished while this window ran, so the
        host never waits for the device there.  Returns the last step's
        main loss.
        """
        freq = self.sampler.update_den_freq
        loss = None
        i = start
        while i < end:
            n = min(freq - (i % freq), end - i)
            self.cfg.m_training_step = i
            if i % freq == 0:
                self._update_grid(i)
            # Each window counts its own demand into a fresh counter.
            self.sampler.state["measured_batch_size"] = torch.zeros(
                (), dtype=torch.int64, device=self.device)
            for _ in range(n):
                loss = self.train_step()
            i += n
            if i % freq == 0:
                if self._pending_adapt is not None:
                    host, event, n_then, rays_then = self._pending_adapt
                    if event is not None:
                        event.synchronize()
                    self.sampler.update_batch_rays(
                        measured=int(host), n_steps=n_then, rays_then=rays_then)
                self._pending_adapt = (*self._copy_to_host(
                    self.sampler.state["measured_batch_size"]), n,
                    self.sampler.n_rays_per_batch)
        return loss

    def _copy_to_host(self, t: torch.Tensor):
        """Start copying a 0-dim device tensor to the host; returns (host
        tensor, event to wait on, or None where the copy is already done)."""
        if t.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _update_grid(self, step: int):
        self.sampler.update_density_grid(training_step=step,
                                         generator=self.generator)

    def train(self):
        """Train to ``tot_train_steps``, printing one plain line every
        ``update_den_freq * 16`` steps (validation renders, checkpoints and
        the test pass are not ported yet)."""
        every = self.sampler.update_den_freq * 16
        i = self.start
        while i < self.tot_train_steps:
            seg_end = min(self.tot_train_steps, (i // every + 1) * every)
            loss = self.train_range(i, seg_end)
            i = seg_end
            print(f"STEP={i} | LOSS={float(loss):.5f} | "
                  f"RAYS={self.sampler.n_rays_per_batch} | "
                  f"SAMPLES/RAY={self.sampler.n_samples_per_ray}", flush=True)
