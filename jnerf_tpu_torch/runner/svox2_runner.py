"""Plenoxels runner: ray-pool training with TV regularizers, per-group
learning-rate schedules and grid upsampling.

Counterpart of `jnerf_tpu/runner/svox2_runner.py`.  As the JAX runner
chains up to 16 steps in a ``lax.scan`` window, cut at every
``upsamp_every`` steps and at the end, ``train`` runs each such window as
one CUDA graph replay on a card (`runner/windows.py`; a loop of
``train_step`` on the CPU or with ``graph=False``): the window's batches
are staged into one static [n, batch, 9] input with one copy, each step
reads its (lr_sigma, lr_sh) from a row of a table computed on the host,
and an upsample drops the grid's graphs (the JAX loop clears its
``window_cache``), so the next grid captures its own.  The grid's
gradient is kernel V (`ops/voxel_grid.py`), summed in a fixed order.  A
step is MSE +
``lambda_tv`` * TV(density) + ``lambda_tv_sh`` * TV(SH), SGD on density and
RMSprop on SH (`optims/svox2_optim.py`) at svox2's delayed exponential
learning rates, the grid upsampled at every ``upsamp_every`` steps along
``reso_list`` with the optimizer state made anew.  The sparse TV's row
draws come from the runner's generator unless passed in (the JAX runner
draws them from ``PRNGKey(step)``); the generator is registered with each
graph.  Renders go in chunks of 4096 rays,
the last padded with rays of ones.  As in the JAX runner, ``train`` writes
no file; ``save`` and ``load`` write and read the grid in svox2's
``.npz`` schema.  Config values are read as the JAX runner reads them,
``cfg.key or default``, so a 0 takes the default (ROADMAP.md §3).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
from jnerf_tpu_torch.optims.svox2_optim import PlenOptim, expon_lr
from jnerf_tpu_torch.runner.windows import (
    GraphWindows,
    graph_windows,
    window_length,
)
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import DATASETS, NETWORKS, build_from_cfg


class Svox2Runner:
    def __init__(self, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Svox2Runner(device={str(device)!r}): CUDA is "
                               "not available")
        self.device = device
        cfg = get_cfg()
        self.cfg = cfg
        self.exp_name = cfg.exp_name
        self.dataset = {
            split: build_from_cfg(getattr(cfg.dataset, split), DATASETS,
                                  device=device)
            for split in ("train", "test")
        }
        cfg.dataset_obj = self.dataset["train"]
        self.grid = build_from_cfg(cfg.model, NETWORKS, device=device)
        cfg.model_obj = self.grid

        self.batch_size = cfg.batch_size or 5000
        self.n_iters = cfg.n_iters or 128000
        self.reso_list = cfg.reso_list or [[256] * 3, [512] * 3]
        self.upsamp_every = cfg.upsamp_every or 38400
        self.lambda_tv = cfg.lambda_tv or 0.0
        self.lambda_tv_sh = cfg.lambda_tv_sh or 0.0
        self.step_size = cfg.step_size or 0.5
        self.background_brightness = cfg.background_brightness or 1.0
        self.sigma_thresh = cfg.sigma_thresh or 1e-8
        self.n_samples = cfg.render_n_samples  # None: the grid's diagonal

        self.lr_sigma_fn = lambda s: expon_lr(
            s, cfg.lr_sigma or 30.0, cfg.lr_sigma_final or 0.05,
            cfg.lr_sigma_delay_steps or 15000, cfg.lr_sigma_delay_mult or 1e-2,
            cfg.lr_sigma_decay_steps or 250000)
        self.lr_sh_fn = lambda s: expon_lr(
            s, cfg.lr_sh or 1e-2, cfg.lr_sh_final or 5e-6,
            cfg.lr_sh_delay_steps or 0, cfg.lr_sh_delay_mult or 1e-2,
            cfg.lr_sh_decay_steps or 250000)

        self.generator = torch.Generator(device).manual_seed(cfg.seed or 0)
        self.optim = PlenOptim(rms_beta=cfg.rms_beta or 0.95)
        self.opt_state = self.optim.init(self.grid.tables())
        self.gstep = 0
        self.windows = GraphWindows(device, self.generator)
        self.window_losses = None  # the [n] MSEs of the last window
        self.save_path = os.path.join(cfg.log_dir or "./logs", self.exp_name)
        os.makedirs(self.save_path, exist_ok=True)

    def render_kwargs(self):
        return dict(n_samples=self.n_samples, step_size=self.step_size,
                    background_brightness=self.background_brightness,
                    sigma_thresh=self.sigma_thresh)

    def train_step(self, rays_o, rays_d, rgb_gt, lr_sigma, lr_sh,
                   tv_rows=(None, None)):
        """One step at learning rates ``lr_sigma`` / ``lr_sh`` (floats, or
        0-dim f32 tensors on the device); ``tv_rows`` are the sparse TV's
        row draws (density, SH), or None each to draw them.  Returns the
        batch's MSE before the update, without waiting for the device."""
        tables = self.grid.tables()
        for p in tables.values():
            p.grad = None
        rgb = self.grid.volume_render(rays_o, rays_d, **self.render_kwargs())
        mse = torch.mean((rgb - rgb_gt) ** 2)
        loss = mse
        if self.lambda_tv > 0:
            loss = loss + self.lambda_tv * self.grid.tv(
                ridx=tv_rows[0], generator=self.generator)
        if self.lambda_tv_sh > 0:
            loss = loss + self.lambda_tv_sh * self.grid.tv_color(
                ridx=tv_rows[1], generator=self.generator)
        loss.backward()
        self.optim.step(tables, self.opt_state, lr_sigma, lr_sh)
        return mse.detach()

    def step_rows(self, n: int) -> np.ndarray:
        """[n, 2] f32: (lr_sigma, lr_sh) of steps gstep .. gstep + n - 1."""
        return np.array([[self.lr_sigma_fn(s), self.lr_sh_fn(s)]
                         for s in range(self.gstep, self.gstep + n)],
                        np.float32)

    def _window_body(self, table, batches):
        return torch.stack([
            self.train_step(b[:, 0:3], b[:, 3:6], b[:, 6:9], row[0], row[1])
            for row, b in zip(table, batches)])

    def train_window(self, n: int, graph=None):
        """Steps gstep .. gstep + n - 1 on the next ``n`` batches (not
        advancing gstep) as one graph replay where `graph_windows` allows
        (or ``graph`` says), else as a loop of ``train_step``; sets and
        returns ``window_losses``."""
        if graph is None:
            graph = graph_windows(self.device)
        ds = self.dataset["train"]
        batches = np.stack([ds.next_host(self.batch_size) for _ in range(n)])
        rows = self.step_rows(n)
        if graph:
            self.window_losses = self.windows.run(
                n, rows, self._window_body, inputs=batches,
                params=list(self.grid.tables().values()))
        else:
            self.window_losses = self.windows.eager(rows, self._window_body,
                                                    batches)
        return self.window_losses

    def upsample(self, reso):
        """Resize the grid to ``reso`` and make the optimizer state anew;
        the graphs, which read the old tables, are dropped."""
        print(f"upsampling grid -> {list(reso)}", flush=True)
        self.windows.clear()
        self.grid.upsample(tuple(reso))
        if self.grid.sparse:
            n_active = int((self.grid.cells >= 0).sum())
            print(f"sparse grid: {n_active} active cells "
                  f"(cap {self.grid.cells.shape[0]})", flush=True)
        self.opt_state = self.optim.init(self.grid.tables())

    def train(self, n_iters=None, graph=None):
        """``n_iters`` steps (the config's by default) in windows,
        upsampling at every multiple of ``upsamp_every`` while
        ``reso_list`` has a next size; returns the last step's MSE.
        ``graph=False`` runs every window as a loop of ``train_step``."""
        n_iters = n_iters or self.n_iters
        reso_idx = 0
        end = self.gstep + n_iters
        mse = None
        while self.gstep < end:
            if (self.gstep > 0 and self.gstep % self.upsamp_every == 0
                    and reso_idx + 1 < len(self.reso_list)):
                reso_idx += 1
                self.upsample(self.reso_list[reso_idx])
            n = window_length(self.gstep, end, (self.upsamp_every,))
            mse = self.train_window(n, graph)[-1]
            self.gstep += n
        return float(mse)

    @torch.no_grad()
    def render_image(self, dataset, img_idx, chunk=4096):
        """Image ``img_idx`` of ``dataset`` as numpy [H, W, 3]."""
        rays_o, rays_d = dataset.rays_for_image(img_idx)
        n = rays_o.shape[0]
        pad = torch.ones(((-n) % chunk, 3), dtype=rays_o.dtype,
                         device=rays_o.device)
        ro, rd = torch.cat([rays_o, pad]), torch.cat([rays_d, pad])
        out = [self.grid.volume_render(ro[s:s + chunk], rd[s:s + chunk],
                                       **self.render_kwargs())
               for s in range(0, ro.shape[0], chunk)]
        return torch.cat(out)[:n].reshape(dataset.H, dataset.W, 3).cpu().numpy()

    def eval_psnr(self, n_images=None):
        """Mean PSNR over the first ``n_images`` test images (all by
        default), the targets composited over the background."""
        ds = self.dataset["test"]
        n_images = n_images or ds.n_images
        bg = self.background_brightness
        mses = []
        for i in range(n_images):
            img = self.render_image(ds, i)
            tar = ds.image(i)
            if tar.shape[-1] == 4:
                tar = tar[..., :3] * tar[..., 3:] + bg * (1 - tar[..., 3:])
            mses.append(float(img2mse(torch.from_numpy(img),
                                      torch.from_numpy(tar))))
        return float(np.mean([float(mse2psnr(m)) for m in mses]))

    def save(self, path=None):
        path = path or os.path.join(self.save_path, "grid.npz")
        self.grid.save_npz(path)
        return path

    def load(self, path=None):
        path = path or os.path.join(self.save_path, "grid.npz")
        self.windows.clear()
        self.grid.load_npz(path)
        self.opt_state = self.optim.init(self.grid.tables())
