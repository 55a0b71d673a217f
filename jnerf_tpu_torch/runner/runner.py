"""NGP training runner.

Counterpart of the training half of `jnerf_tpu/runner/runner.py`: the
same components built from the same config, the same step (pixel sampling
-> ray march -> compaction -> model -> composite -> loss -> Adam -> EMA),
the same grid-refresh cadence and the same one-window-lagged batch
adaptation.  The JAX package chains a refresh window of steps in one
``lax.scan``; here the window is a Python loop of eager steps.  All random
draws come from one ``torch.Generator`` on the runner's device, and the
step takes injected draws so that a test can feed it the JAX package's.

The rendering half is ported too: ``render_img``, ``render_img_with_pose``,
``render_test``, ``val_img`` and ``test`` march full images in chunks of
``render_chunk_rays`` rays at the sampler's inference budget, composite
without a background term and add the run's background colour after.  The
inference jitter is one [chunk] draw per image, used for every chunk (the
JAX package's one key per image), from the runner's generator unless
given.  Images are written by ``save_img`` through the port's own PNG
encoder (`dataset/dataset_util.py`), so ``train``, ``val_img`` and
``test`` need no imaging library.  ``render`` writes the spherical demo
path as an mp4 with cv2, imported when it is called, as in the JAX
package.

Checkpoints (``save_ckpt``, ``load_ckpt``, ``cfg.load_ckpt``, the
``params.pkl`` that ``train`` writes before ``test``) keep the JAX
runner's pickle and keys, with numpy leaves and Python scalars only, so
that a machine without JAX or optax reads them: ``model`` and the EMA
shadow are JAX params trees (`utils/convert.py`), and ``nested_optimizer``
is the Adam state as a plain dict ``{"count", "mu", "nu"}`` with the
moments in the same tree.  ``load_ckpt`` also reads the JAX runner's
checkpoints, whose Adam state is optax's (found by its field names; that
needs optax to unpickle).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from jnerf_tpu_torch.dataset import camera_path
from jnerf_tpu_torch.dataset.dataset import rays_from_pixels
from jnerf_tpu_torch.dataset.dataset_util import write_image
from jnerf_tpu_torch.models.losses import img2mse, mse2psnr
from jnerf_tpu_torch.ops.compact import compact_indices, render_rays_compact
from jnerf_tpu_torch.ops.composite import density_l1_reg, render_rays
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.convert import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
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
    # A validation render every val_freq steps of train(); rays per render
    # chunk.  Class attributes, so that a caller may lower them for a run.
    val_freq = 4096
    render_chunk_rays = 4096

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

        self.exp_name = cfg.exp_name
        self.dataset = {"train": build_from_cfg(cfg.dataset.train, DATASETS,
                                                device=device)}
        cfg.dataset_obj = self.dataset["train"]
        self.dataset["val"] = (
            build_from_cfg(cfg.dataset.val, DATASETS, device=device)
            if cfg.dataset.val else self.dataset["train"])
        self.dataset["test"] = None  # built by test() at first use
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

        self.background_color = torch.tensor(
            cfg.background_color or [0, 0, 0], dtype=torch.float32)
        self.alpha_image = bool(cfg.alpha_image)
        # Created when an image is first written, not here.
        self.save_path = os.path.join(cfg.log_dir or "./logs", self.exp_name)
        self.ckpt_path = cfg.ckpt_path or os.path.join(self.save_path,
                                                       "params.pkl")
        self.W, self.H = (int(v) for v in self.dataset["train"].resolution)
        # Picks the image of render_img(img_id=None).
        self._img_rng = np.random.default_rng(seed)

        self.tot_train_steps = cfg.tot_train_steps
        self.sampler.init_state()
        self.start = 0
        if cfg.load_ckpt:
            self.load_ckpt(self.ckpt_path)
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
    def train_range(self, start: int, end: int, tick=None):
        """Train steps [start, end) with grid refreshes and batch adaptation.

        A refresh runs when ``i % update_den_freq == 0``; the steps up to
        the next refresh form a window of one shape.  At each window's end
        the batch shape adapts to the PREVIOUS window's measured demand,
        whose device-to-host copy finished while this window ran, so the
        host never waits for the device there.  ``tick(n, n_rays,
        n_samples_per_ray)``, if given, is called after each window's
        steps are enqueued.  Returns the last step's main loss.
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
            if tick is not None:
                tick(n, self.sampler.n_rays_per_batch,
                     self.sampler.n_samples_per_ray)
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
        """Train from ``start`` to ``tot_train_steps``, printing one plain
        line every ``update_den_freq * 16`` steps, with the PSNR of a
        validation render every ``val_freq`` steps and the throughput over
        the last 256 steps (`utils.metrics.ThroughputMeter`, host clock);
        then save ``<save_path>/params.pkl`` and render and score the test
        set; returns ``test()``'s mean PSNR."""
        from jnerf_tpu_torch.utils.metrics import ThroughputMeter

        meter = ThroughputMeter(window=256)

        def tick(n, n_rays, n_samples_per_ray):
            for _ in range(n):
                meter.tick(n_rays=n_rays, n_samples=n_rays * n_samples_per_ray)

        every = self.sampler.update_den_freq * 16
        i = self.start
        while i < self.tot_train_steps:
            seg_end = min(self.tot_train_steps, (i // every + 1) * every,
                          (i // self.val_freq + 1) * self.val_freq)
            loss = self.train_range(i, seg_end, tick=tick)
            i = seg_end
            line = (f"STEP={i} | LOSS={float(loss):.5f} | "
                    f"RAYS={self.sampler.n_rays_per_batch} | "
                    f"SAMPLES/RAY={self.sampler.n_samples_per_ray}")
            if i % self.val_freq == 0 and i < self.tot_train_steps:
                line += f" | VAL PSNR={float(mse2psnr(self.val_img(i))):.3f}"
            print(f"{line} | {meter.summary()}", flush=True)
        self.save_ckpt(os.path.join(self.save_path, "params.pkl"))
        return self.test()

    # ------------------------------------------------------------------- test
    def test(self, load_ckpt=False):
        """Render the test set into ``<save_path>/test`` (after loading
        ``ckpt_path`` if ``load_ckpt``) and print and return its mean PSNR
        (None for a dataset without images)."""
        if load_ckpt:
            self.load_ckpt(self.ckpt_path)
        path = os.path.join(self.save_path, "test")
        os.makedirs(path, exist_ok=True)
        mse_list = self.render_test(save_path=path)
        if self.dataset["test"].have_img:
            tot_psnr = float(np.mean([float(mse2psnr(m)) for m in mse_list]))
            print(f"TOTAL TEST PSNR===={tot_psnr}", flush=True)
            return tot_psnr
        return None

    # ----------------------------------------------------------- checkpoints
    def _jax_tree(self, tensors):
        """Tensors in ``self.params`` order -> the JAX params tree (numpy)."""
        names = [name for name, _ in self.model.named_parameters()]
        return state_dict_to_jax_params(dict(zip(names, tensors)))

    def _from_jax_tree(self, tree):
        """A JAX params tree -> tensors on the runner's device, in
        ``self.params`` order."""
        sd = jax_params_to_state_dict(tree)
        return [sd[name].to(self.device)
                for name, _ in self.model.named_parameters()]

    def save_ckpt(self, path):
        """Write the run's state to ``path``, creating its directory.
        ``global_step`` is the number of steps taken, where ``train``
        resumes (the JAX runner writes the first step of its last window
        there)."""
        adam = self.optimizer
        moments = {k: self._jax_tree([adam.state[p][k] if adam.state.get(p)
                                      else torch.zeros_like(p)
                                      for p in self.params])
                   for k in ("mu", "nu")}
        ema = None
        if self.ema is not None:
            ema = {"shadow": self._jax_tree(self.ema_state["shadow"]),
                   "steps": int(self.ema_state["steps"])}
        ckpt = {
            "global_step": adam.count,
            "model": self._jax_tree(self.params),
            "sampler": self.sampler.state_dict(),
            "optimizer": {"steps": adam.count},
            "nested_optimizer": {"count": adam.count, **moments},
            "ema_optimizer": ema,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)

    def load_ckpt(self, path):
        """Restore a checkpoint of this runner or of the JAX runner: the
        model, the sampler, the EMA shadow, the Adam state and ``start``,
        the step that ``train`` resumes at."""
        print("Loading ckpt from:", path, flush=True)
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        self.model.load_state_dict(jax_params_to_state_dict(ckpt["model"]))
        self.sampler.load_state_dict(ckpt["sampler"])
        adam = _adam_state(ckpt["nested_optimizer"])
        if adam is None:
            raise ValueError(f"{path}: no Adam state (count, mu, nu) in "
                             "nested_optimizer")
        self.optimizer.count = int(adam["count"])
        for p, mu, nu in zip(self.params, self._from_jax_tree(adam["mu"]),
                             self._from_jax_tree(adam["nu"])):
            self.optimizer.state[p] = {"mu": mu, "nu": nu}
        if self.ema is not None and ckpt.get("ema_optimizer") is not None:
            self.ema_state = {
                "shadow": self._from_jax_tree(ckpt["ema_optimizer"]["shadow"]),
                "steps": int(ckpt["ema_optimizer"]["steps"])}
        self.start = int(ckpt["global_step"])

    # -------------------------------------------------------------- rendering
    @torch.no_grad()
    def _render_rays_chunked(self, rays_o, rays_d, H, W, u=None):
        """Render H*W rays in chunks of ``render_chunk_rays`` (the last one
        padded with rays of ones); returns numpy rgb [H, W, 3] and opacity
        [H, W, 1].  ``u`` [chunk] is the march jitter of every chunk."""
        n = H * W
        chunk = self.render_chunk_rays
        n_samples = self.sampler.inference_samples_per_ray
        dev = self.device
        if u is None:
            u = torch.rand((chunk,), generator=self.generator, device=dev)
        rgb_out = torch.empty((n, 3), dtype=torch.float32, device=dev)
        a_out = torch.empty((n,), dtype=torch.float32, device=dev)
        for px in range(0, n, chunk):
            end = min(px + chunk, n)
            ro, rd = rays_o[px:end], rays_d[px:end]
            if end - px < chunk:
                pad = torch.ones((chunk - (end - px), 3), dtype=ro.dtype,
                                 device=dev)
                ro, rd = torch.cat([ro, pad]), torch.cat([rd, pad])
            samples = self.sampler.sample_fixed(self.sampler.state, ro, rd,
                                                None, n_samples, u=u)
            raw = self.model(samples.positions.reshape(-1, 3),
                             samples.dirs.reshape(-1, 3))
            rgb, opacity = self.sampler.composite(samples, raw, inference=True)
            rgb_out[px:end] = rgb[:end - px]
            a_out[px:end] = opacity[:end - px]
        return (rgb_out.reshape(H, W, 3).cpu().numpy(),
                a_out.reshape(H, W, 1).cpu().numpy())

    def render_img(self, dataset_mode="train", img_id=None, u=None):
        """Render camera ``img_id`` of a dataset split (a random one when
        None); returns numpy (img [H, W, 3], alpha or None, target
        [H, W, 3]), the background composited in unless ``alpha_image``."""
        ds = self.dataset[dataset_mode]
        if img_id is None:
            img_id = int(self._img_rng.integers(0, ds.n_images))
        rays_o, rays_d = ds.generate_rays_total_test(img_id)
        img, alpha = self._render_rays_chunked(rays_o, rays_d, self.H, self.W,
                                               u=u)
        tar = ds.image(img_id)
        bg = self.background_color.numpy()
        img_tar = tar[..., :3] * tar[..., 3:] + bg * (1 - tar[..., 3:])
        if not self.alpha_image:
            return img + bg * (1 - alpha), None, img_tar
        return img, alpha, img_tar

    def render_img_with_pose(self, pose, u=None):
        """Render a NeRF-space [3, 4] camera pose with the training
        intrinsics; returns numpy [H, W, 3]."""
        rays_o, rays_d = self.dataset["train"].generate_rays_with_pose(pose)
        img, alpha = self._render_rays_chunked(rays_o, rays_d, self.H, self.W,
                                               u=u)
        if not self.alpha_image:
            img = img + self.background_color.numpy() * (1 - alpha)
        return img

    def render_test(self, save_img=True, save_path=None, u=None):
        """Render every test image (building the test split at first use);
        returns the list of their MSEs against the targets, writing renders
        and targets as PNGs if ``save_img``."""
        if save_path is None:
            save_path = self.save_path
        if self.dataset["test"] is None:
            self.dataset["test"] = build_from_cfg(self.cfg.dataset.test,
                                                  DATASETS, device=self.device)
        ds = self.dataset["test"]
        mse_list = []
        for i in range(ds.n_images):
            img, alpha, img_tar = self.render_img("test", img_id=i, u=u)
            if save_img:
                os.makedirs(save_path, exist_ok=True)
                self.save_img(os.path.join(
                    save_path, f"{self.exp_name}_r_{i}.png"), img, alpha)
                if ds.have_img:
                    self.save_img(os.path.join(
                        save_path, f"{self.exp_name}_gt_{i}.png"), img_tar)
            mse_list.append(float(img2mse(torch.from_numpy(img),
                                          torch.from_numpy(img_tar))))
        return mse_list

    def val_img(self, it):
        """Render a random validation image, save it and its target, and
        return its MSE."""
        img, _alpha, img_tar = self.render_img(dataset_mode="val")
        os.makedirs(self.save_path, exist_ok=True)
        self.save_img(os.path.join(self.save_path, f"img{it}.png"), img)
        self.save_img(os.path.join(self.save_path, f"target{it}.png"), img_tar)
        return img2mse(torch.from_numpy(img), torch.from_numpy(img_tar))

    def render(self, load_ckpt=True, save_path=None):
        """Render the spherical demo path (`dataset/camera_path.py`) into
        an mp4 at 28 fps (``<save_path>/demo.mp4`` unless given), after
        loading ``ckpt_path`` if ``load_ckpt``; returns the file's path.
        Imports cv2, which the card's machine lacks (ROADMAP)."""
        if load_ckpt:
            assert os.path.exists(self.ckpt_path), self.ckpt_path
            self.load_ckpt(self.ckpt_path)
        if not save_path:
            save_path = os.path.join(self.save_path, "demo.mp4")
        assert save_path.endswith(".mp4")
        import cv2

        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fps = 28
        writer = cv2.VideoWriter(
            save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (self.W, self.H)
        )
        for pose in camera_path.path_spherical():
            img = self.render_img_with_pose(pose)
            frame = (img * 255 + 0.5).clip(0, 255).astype("uint8")
            writer.write(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        writer.release()
        return save_path

    @staticmethod
    def save_img(path, img, alpha=None):
        """Write an [H, W, 3] image (with alpha, RGBA) in [0, 1] as PNG."""
        if alpha is not None:
            img = np.concatenate([img, alpha], axis=-1)
        write_image(path, img)


def _adam_state(state):
    """The Adam state {count, mu, nu} in a checkpoint's nested_optimizer:
    the port's dict, or inside the optax state tree that the JAX runner
    pickles, the ScaleByAdamState found by its field names; None if absent."""
    if isinstance(state, dict) and {"count", "mu", "nu"} <= set(state):
        return state
    if {"count", "mu", "nu"} <= set(getattr(state, "_fields", ())):
        return state._asdict()
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None
