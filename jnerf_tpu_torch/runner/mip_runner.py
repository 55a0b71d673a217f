"""Mip-NeRF runner: the two-level loop with the coarse loss down-weighted.

Counterpart of `jnerf_tpu/runner/mip_runner.py`.  As the JAX runner
chains up to 16 steps in a ``lax.scan`` window, cut at every
``_VAL_FREQ`` steps (a random val image whose index comes from the
runner's generator) and at the end, ``train`` runs each such window as one
CUDA graph replay on a card (`runner/windows.py`; a loop of
``train_step`` on the CPU or with ``graph=False``).  The window's batches
are staged into one static [n, batch, C] input with one copy, and each
step reads its row of a table of Adam's scalars (``scalar_rows``).  A
step is both levels' sampling, MLP and compositing, the per-level masked
MSE with ``coarse_loss_mult`` on every level but the last, and Adam on
the `LinearLog` schedule.  Random draws come from the runner's generator,
registered with each graph, unless passed in (``draws``: one dict a level
with ``u``, the level's uniform draw, and ``noise``, its density noise).  Renders go in chunks of
``chunk`` (3072) rays, the last padded with rays of ones; images are
written through the port's PNG codec.

Checkpoints keep the JAX runner's pickle ``{global_step, model,
optimizer}`` with numpy leaves only: ``model`` is the JAX params tree and
``optimizer`` the Adam state ``{count, mu, nu}`` with the moments in the
same tree.  ``load_ckpt`` also reads the JAX runner's pickles, whose Adam
state is optax's (found by its field names).  ``global_step`` is the number
of steps taken, where ``train`` resumes (the JAX runner writes the first
step of its last window there).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from jnerf_tpu_torch.dataset.dataset_util import write_image
from jnerf_tpu_torch.dataset.mip_dataset import namedtuple_map
from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
from jnerf_tpu_torch.runner.runner import _adam_state
from jnerf_tpu_torch.runner.windows import (
    GraphWindows,
    graph_windows,
    window_length,
)
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from jnerf_tpu_torch.utils.registry import (
    DATASETS,
    NETWORKS,
    OPTIMS,
    SAMPLERS,
    build_from_cfg,
)


class MipRunner:
    _VAL_FREQ = 2000

    def __init__(self, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"MipRunner(device={str(device)!r}): CUDA is "
                               "not available")
        self.device = device
        cfg = get_cfg()
        self.cfg = cfg
        self.exp_name = cfg.exp_name
        seed = cfg.seed if cfg.seed is not None else 20200823
        self.generator = torch.Generator(device).manual_seed(seed)
        self.dataset = {
            split: build_from_cfg(getattr(cfg.dataset, split), DATASETS,
                                  device=device)
            for split in ("train", "val", "test")
        }
        cfg.dataset_obj = self.dataset["train"]
        self.model = build_from_cfg(cfg.model, NETWORKS, device=device,
                                    generator=self.generator)
        cfg.model_obj = self.model
        self.sampler = build_from_cfg(cfg.sampler, SAMPLERS)
        cfg.sampler_obj = self.sampler

        adam = build_from_cfg(cfg.optim, OPTIMS)
        self.schedule_wrap = build_from_cfg(cfg.linearlog, OPTIMS,
                                            nested_optimizer=adam)
        self.params = list(self.model.parameters())
        self.optimizer = self.schedule_wrap.make(self.params)

        self.tot_train_steps = cfg.tot_train_steps
        self.num_levels = cfg.num_levels or 2
        self.coarse_loss_mult = cfg.coarse_loss_mult or 0.1
        self.disable_multiscale_loss = bool(cfg.disable_multiscale_loss)
        self.chunk = 3072

        self.save_path = os.path.join(cfg.log_dir or "./logs", self.exp_name)
        os.makedirs(self.save_path, exist_ok=True)
        self.ckpt_path = cfg.ckpt_path or os.path.join(self.save_path,
                                                       "params.pkl")
        self.start = 0  # where train() begins: the steps taken so far
        self.windows = GraphWindows(device, self.generator)
        self.window_losses = None  # the [n] losses of the last window
        if cfg.load_ckpt:
            self.load_ckpt(self.ckpt_path)
        cfg.m_training_step = 0

    # ------------------------------------------------------------------ core
    def _levels_forward(self, rays, randomized, draws=None):
        """Run all levels; returns [(rgb, distance, acc), ...]."""
        ret = []
        t_vals, weights = None, None
        for lvl in range(self.num_levels):
            d = draws[lvl] if draws is not None else {}
            enc, vdirs, t_vals = self.sampler.sample(
                rays, lvl, t_vals, weights, randomized=randomized,
                u=d.get("u"), generator=self.generator)
            raw_rgb, raw_density = self.model(enc, vdirs)
            rgb, dist, acc, weights = self.sampler.rays2rgb(
                rays, raw_rgb, raw_density, t_vals, randomized=randomized,
                noise=d.get("noise"), generator=self.generator)
            ret.append((rgb, dist, acc))
        return ret

    def forward_loss(self, rays, rgb_target, draws=None):
        """(loss, the last level's masked MSE) of one training batch."""
        mask = (torch.ones_like(rays.lossmult) if self.disable_multiscale_loss
                else rays.lossmult)
        ret = self._levels_forward(rays, randomized=True, draws=draws)
        losses = [torch.sum(mask * (rgb - rgb_target[..., :3]) ** 2)
                  / torch.sum(mask) for (rgb, _, _) in ret]
        loss = self.coarse_loss_mult * sum(losses[:-1]) + losses[-1]
        return loss, losses[-1]

    def train_step(self, rays, rgb_target, draws=None, row=None):
        """One step: the loss, its backward and Adam (``row``: the step's
        row of ``scalar_rows`` on the device, made when None); returns the
        detached (loss, fine MSE) without waiting for the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, fine = self.forward_loss(rays, rgb_target, draws)
        loss.backward()
        self.optimizer.step(row=row)
        return loss.detach(), fine.detach()

    def _window_body(self, table, batches):
        ds = self.dataset["train"]
        return torch.stack([
            self.train_step(*ds.split_batch(batch), row=row)[0]
            for row, batch in zip(table, batches)])

    def train_window(self, n: int, graph=None):
        """The next ``n`` batches' steps (not advancing ``start``) as one
        graph replay where `graph_windows` allows (or ``graph`` says), else
        as a loop of ``train_step``; sets and returns ``window_losses``."""
        if graph is None:
            graph = graph_windows(self.device)
        ds = self.dataset["train"]
        batches = np.stack([ds.next_host() for _ in range(n)])
        rows = self.optimizer.scalar_rows(n)
        if graph:
            self.window_losses = self.windows.run(
                n, rows, self._window_body, inputs=batches,
                counters=[(self.optimizer, "count")], params=self.params)
        else:
            self.window_losses = self.windows.eager(rows, self._window_body,
                                                    batches)
        return self.window_losses

    def train(self, graph=None):
        """Train from ``start`` to ``tot_train_steps`` in windows, with a
        validation image every ``_VAL_FREQ`` steps, then save
        ``ckpt_path``; returns the last step's loss.  ``graph=False`` runs
        every window as a loop of ``train_step``."""
        i = self.start
        loss = None
        while i < self.tot_train_steps:
            n = window_length(i, self.tot_train_steps, (self._VAL_FREQ,))
            self.cfg.m_training_step = i
            loss = self.train_window(n, graph)[-1]
            i += n
            self.start = i
            if i < self.tot_train_steps and i % self._VAL_FREQ == 0:
                psnr = mse2psnr(self.val_img(i))
                print(f"STEP={i} | LOSS={float(loss):.5f} | "
                      f"VAL PSNR={float(psnr):.3f}", flush=True)
        self.save_ckpt(self.ckpt_path)
        return None if loss is None else float(loss)

    # ------------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, dataset, img_idx):
        """The fine level's rgb of image ``img_idx`` (not randomized) as
        numpy [H, W, 3]."""
        rays_img = dataset.rays_for_image(img_idx)
        flat = namedtuple_map(lambda r: r.reshape(-1, r.shape[-1]), rays_img)
        n = flat.origins.shape[0]
        pad = (-n) % self.chunk
        padded = namedtuple_map(
            lambda r: torch.cat([r, torch.ones((pad, r.shape[-1]),
                                               dtype=r.dtype,
                                               device=r.device)]), flat)
        chunks = []
        for s in range(0, n + pad, self.chunk):
            part = namedtuple_map(lambda r: r[s:s + self.chunk], padded)
            chunks.append(self._levels_forward(part, randomized=False)[-1][0])
        H, W = dataset.image(img_idx).shape[:2]
        return torch.cat(chunks)[:n].reshape(H, W, 3).cpu().numpy()

    @staticmethod
    def _target(ds, idx):
        tar = ds.image(idx)
        rgb = tar[..., :3]
        return rgb * tar[..., 3:] if tar.shape[-1] == 4 else rgb

    def val_img(self, it):
        """Render a random val image, write it as ``img{it}.png`` and
        return its MSE."""
        ds = self.dataset["val"]
        idx = int(torch.randint(ds.n_images, (1,), generator=self.generator,
                                device=self.device))
        img = self.render_image(ds, idx)
        write_image(os.path.join(self.save_path, f"img{it}.png"), img)
        return img2mse(torch.from_numpy(img),
                       torch.from_numpy(self._target(ds, idx)))

    def test(self, load_ckpt=False):
        """Render the test split (after loading ``ckpt_path`` if
        ``load_ckpt``); print and return its mean PSNR."""
        if load_ckpt:
            self.load_ckpt(self.ckpt_path)
        ds = self.dataset["test"]
        mse_list = []
        for i in range(ds.n_images):
            img = self.render_image(ds, i)
            mse_list.append(float(img2mse(
                torch.from_numpy(img), torch.from_numpy(self._target(ds, i)))))
        psnr = float(np.mean([float(mse2psnr(m)) for m in mse_list]))
        print(f"TOTAL TEST PSNR===={psnr}", flush=True)
        return psnr

    # ------------------------------------------------------------ checkpoint
    def _jax_tree(self, tensors):
        """Tensors in ``self.params`` order -> the JAX params tree (numpy)."""
        names = [name for name, _ in self.model.named_parameters()]
        return state_dict_to_jax_params(dict(zip(names, tensors)))

    def save_ckpt(self, path):
        adam = self.optimizer
        moments = {k: self._jax_tree([adam.state[p][k] if adam.state.get(p)
                                      else torch.zeros_like(p)
                                      for p in self.params])
                   for k in ("mu", "nu")}
        ckpt = {"global_step": self.start,
                "model": self._jax_tree(self.params),
                "optimizer": {"count": adam.count, **moments}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)

    def load_ckpt(self, path):
        """Restore the model, the Adam state and ``start`` from a
        checkpoint of this runner or of the JAX runner."""
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        self.model.load_state_dict(jax_params_to_state_dict(ckpt["model"]))
        adam = _adam_state(ckpt["optimizer"])
        if adam is None:
            raise ValueError(f"{path}: no Adam state (count, mu, nu) in "
                             "optimizer")
        self.optimizer.count = int(adam["count"])
        names = [name for name, _ in self.model.named_parameters()]
        mu, nu = (jax_params_to_state_dict(adam[k]) for k in ("mu", "nu"))
        for name, p in zip(names, self.params):
            self.optimizer.state[p] = {"mu": mu[name].to(self.device),
                                       "nu": nu[name].to(self.device)}
        self.start = int(ckpt["global_step"])
