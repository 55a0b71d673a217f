"""NeuS training runner: per-image ray batches, the colour, eikonal and mask
losses, a cosine learning rate with warm-up, image and mesh validation,
checkpoints and resuming.

Counterpart of `jnerf_tpu/runner/neus_runner.py`.  As the JAX runner
chains up to 16 steps in a ``lax.scan`` window, cut at every report,
checkpoint, validation and mesh boundary, at the end of a pass over the
images and at ``end_iter``, ``train`` runs each such window as one CUDA
graph replay on a card (`runner/windows.py`; a loop of ``train_step``
on the CPU, or through ``train_eager``).  Each step reads its row of a
table computed on the host as the JAX loop computes its per-step inputs:
Adam's learning rate (the schedule at the step) and bias corrections, the
cos anneal ratio (f32) and the image index.  Adam is
``optax.scale_by_adam`` scaled by ``-lr``.  Random draws (the image order,
the pixels of each batch and the renderer's jitter) come from the runner's
generators; the device generator is registered with each graph.
Checkpoints keep the JAX runner's pickle, ``{"neus": params tree, "iter_step"}``
with numpy leaves, so each package reads the other's.  Images are written
through the port's PNG codec, in the channel order ``cv.imwrite`` gives
the JAX runner's arrays, with a JET colour map computed here.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from jnerf_tpu_torch.dataset.dataset_util import encode_png
from jnerf_tpu_torch.optims import AdamOptimizer
from jnerf_tpu_torch.runner.windows import (
    GraphWindows,
    graph_windows,
    host_to_device,
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


def jet_lut() -> np.ndarray:
    """OpenCV's COLORMAP_JET as uint8 [256, 3] in BGR order.

    OpenCV tabulates the Octave jet (each channel a clipped triangle over
    x = i / 255) in f32, interpolates the table at its own f32 breakpoints
    (``interp1``, which rounds some entries off by an ulp) and scales by
    255 with round-half-even; this repeats those f32 steps.
    """
    f = np.float32
    i = np.arange(256, dtype=np.float64)
    # Each value is a multiple of 1/510 exactly; the table holds it in f32.
    y = np.stack([np.clip(np.minimum(4 * i - (c - 1.5) * 255,
                                     -4 * i + (c + 1.5) * 255), 0, 255)
                  for c in (3, 2, 1)], -1) / 255.0
    y = y.astype(f)  # [256, 3], RGB
    step = f(1) / f(255)
    x = (f(0) + np.arange(256, dtype=f) * step).astype(f)
    out = y.copy()
    dx = (x[1:] - x[:-1]).astype(f)
    out[1:] = (y[:-1] + ((dx[:, None] * (y[1:] - y[:-1])).astype(f)
                         / dx[:, None]).astype(f)).astype(f)
    return np.rint(out * f(255)).astype(np.uint8)[:, ::-1].copy()


def imwrite_bgr(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] BGR array as ``cv.imwrite`` would: a PNG
    whose red channel is the array's last."""
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(img[..., ::-1])))


class NeuSRunner:
    def __init__(self, mode="train", is_continue=False, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"NeuSRunner(device={str(device)!r}): CUDA is "
                               "not available")
        self.device = device
        cfg = get_cfg()
        self.cfg = cfg
        self.base_exp_dir = cfg.base_exp_dir
        os.makedirs(self.base_exp_dir, exist_ok=True)
        self.iter_step = 0

        self.end_iter = cfg.end_iter
        self.save_freq = cfg.save_freq
        self.report_freq = cfg.report_freq
        self.val_freq = cfg.val_freq
        self.val_mesh_freq = cfg.val_mesh_freq
        self.batch_size = cfg.batch_size
        self.validate_resolution_level = cfg.validate_resolution_level
        self.learning_rate = cfg.optim.lr
        self.learning_rate_alpha = cfg.learning_rate_alpha
        self.use_white_bkgd = cfg.use_white_bkgd
        self.warm_up_end = cfg.warm_up_end
        self.anneal_end = cfg.anneal_end
        self.igr_weight = cfg.igr_weight
        self.mask_weight = cfg.mask_weight
        self.mode = mode

        seed = cfg.seed if cfg.seed is not None else 0
        self.generator = torch.Generator(device).manual_seed(seed)
        # Image order and validation views, on the host.
        self._rng = np.random.default_rng(seed)
        self.dataset = build_from_cfg(cfg.dataset, DATASETS, device=device)
        self.neus_network = build_from_cfg(cfg.model, NETWORKS, device=device,
                                           generator=self.generator)
        self.renderer = build_from_cfg(cfg.render, SAMPLERS)
        self.renderer.set_neus_network(self.neus_network)
        self._image_perm = self._rng.permutation(self.dataset.n_images)

        adam = build_from_cfg(cfg.optim, OPTIMS)
        self.params = list(self.neus_network.parameters())
        # The learning rate is the schedule's at the step: Adam's count
        # ``c`` is step iter_step + c - count.
        self.optimizer = AdamOptimizer(
            self.params, adam.lr, adam.betas, adam.eps,
            lr_schedule=lambda c: self.current_lr(
                self.iter_step + c - self.optimizer.count))
        self.windows = GraphWindows(device, self.generator)
        # The [n, 4] (total, colour loss, eikonal term, mean s) of the last
        # window's steps.
        self.window_losses = None

        if is_continue:
            ckpt_dir = os.path.join(self.base_exp_dir, "checkpoints")
            names = [n for n in (os.listdir(ckpt_dir)
                                 if os.path.isdir(ckpt_dir) else [])
                     if n.endswith(".pkl") and int(n[5:-4]) <= self.end_iter]
            if names:
                latest = sorted(names)[-1]
                print(f"Find checkpoint: {latest}", flush=True)
                self.load_checkpoint(latest)

    # ---------------------------------------------------------------- sched
    def get_cos_anneal_ratio(self, step=None):
        step = self.iter_step if step is None else step
        if self.anneal_end == 0.0:
            return 1.0
        return min(1.0, step / self.anneal_end)

    def current_lr(self, step=None):
        step = self.iter_step if step is None else step
        if step < self.warm_up_end:
            factor = step / self.warm_up_end
        else:
            a = self.learning_rate_alpha
            progress = ((step - self.warm_up_end)
                        / (self.end_iter - self.warm_up_end))
            factor = (np.cos(np.pi * progress) + 1.0) * 0.5 * (1 - a) + a
        return self.learning_rate * factor

    def step_rows(self, n: int) -> np.ndarray:
        """[n, width] f32: the scalars of steps iter_step .. + n - 1, as the
        JAX loop computes its per-step inputs: Adam's columns (the
        learning rate of the step's schedule, the bias corrections), then
        the cos anneal ratio and the image index (of the current order)."""
        steps = self.iter_step + np.arange(n)
        perm = self._image_perm
        extra = np.stack([
            np.array([self.get_cos_anneal_ratio(int(t)) for t in steps],
                     np.float32),
            perm[steps % len(perm)].astype(np.float32)], axis=1)
        return np.concatenate([self.optimizer.scalar_rows(n), extra], axis=1)

    def window_length(self) -> int:
        """Steps in the window from iter_step: the JAX loop's rule."""
        return window_length(
            self.iter_step, self.end_iter,
            (self.report_freq, self.save_freq, self.val_freq,
             self.val_mesh_freq, len(self._image_perm)))

    # ---------------------------------------------------------------- train
    def forward_loss(self, data, t_rand=None, t_r=None, anneal=None):
        """The step's loss on a ray batch ``data`` [B, 10] (o, v, rgb,
        mask), at the cos anneal ``anneal`` (an f32 0-dim tensor or float;
        the current step's when None): (total, (colour loss, eikonal term,
        mean s)), differentiable in the network's parameters.  ``t_rand``,
        ``t_r``: the renderer's draws, if given."""
        rays_o, rays_d = data[:, :3], data[:, 3:6]
        true_rgb, mask = data[:, 6:9], data[:, 9:10]
        near, far = self.dataset.near_far_from_sphere(rays_o, rays_d)
        bg = (torch.ones((1, 3), device=self.device) if self.use_white_bkgd
              else None)
        if self.mask_weight > 0.0:
            mask = (mask > 0.5).float()
        else:
            mask = torch.ones_like(mask)
        mask_sum = torch.sum(mask) + 1e-5
        if anneal is None:
            # The JAX step takes the anneal ratio as an f32 scalar.
            anneal = float(np.float32(self.get_cos_anneal_ratio()))
        out = self.renderer.render(rays_o, rays_d, near, far,
                                   background_rgb=bg, cos_anneal_ratio=anneal,
                                   generator=self.generator, t_rand=t_rand,
                                   t_r=t_r)
        color_err = (out["color_fine"] - true_rgb) * mask
        color_loss = torch.sum(torch.abs(color_err)) / mask_sum
        eik = out["gradient_error"]
        w_sum = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
        mask_loss = torch.mean(-(mask * torch.log(w_sum)
                                 + (1 - mask) * torch.log(1 - w_sum)))
        total = color_loss + eik * self.igr_weight + mask_loss * self.mask_weight
        return total, (color_loss, eik, out["s_val"].mean())

    def train_step(self, row=None):
        """One Adam step on a random batch of the step's image; ``row`` is
        its row of ``step_rows`` on the device (made here when None).
        Returns the detached (total, colour loss, eikonal term, mean s) on
        the device."""
        if row is None:
            row = host_to_device(self.step_rows(1), self.device)[0]
        k = self.optimizer.row_width
        data = self.dataset.gen_random_rays_at(
            row[k + 1].to(torch.int64), self.batch_size,
            generator=self.generator)
        total, aux = self.forward_loss(data, anneal=row[k])
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step(row=row[:k])
        return torch.stack([total.detach(), *(a.detach() for a in aux)])

    def _window_body(self, table, _inputs=None):
        return torch.stack([self.train_step(row=row) for row in table])

    def train_window(self, n: int, graph=None):
        """Steps iter_step .. + n - 1 (not advancing iter_step) as one
        graph replay where `graph_windows` allows (or ``graph`` says), else
        as a loop of ``train_step``; sets and returns ``window_losses``."""
        if graph is None:
            graph = graph_windows(self.device)
        rows = self.step_rows(n)
        if graph:
            self.window_losses = self.windows.run(
                n, rows, self._window_body,
                counters=[(self.optimizer, "count")], params=self.params)
        else:
            self.window_losses = self.windows.eager(rows, self._window_body)
        return self.window_losses

    def train(self, graph=None):
        """Train to ``end_iter`` in windows (`window_length`): a report
        line every ``report_freq`` steps, a checkpoint every
        ``save_freq``, a validation image every ``val_freq`` and a mesh
        every ``val_mesh_freq``; a new image order after each pass over the
        images.  ``graph=False`` runs every window as a loop of
        ``train_step``."""
        while self.iter_step < self.end_iter:
            n = self.window_length()
            losses = self.train_window(n, graph)
            self.iter_step += n
            if self.iter_step % self.report_freq == 0:
                print(f"iter:{self.iter_step:8d} loss = {float(losses[-1, 0]):.5f} "
                      f"lr={self.current_lr():.6f}", flush=True)
            if self.iter_step % self.save_freq == 0:
                self.save_checkpoint()
            if self.iter_step % self.val_freq == 0:
                self.validate_image()
            if self.iter_step % self.val_mesh_freq == 0:
                self.validate_mesh()
            if self.iter_step % len(self._image_perm) == 0:
                self._image_perm = self._rng.permutation(
                    self.dataset.n_images)

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self):
        """Write ``checkpoints/ckpt_<iter_step>.pkl`` (the JAX runner's
        pickle); returns its path."""
        os.makedirs(os.path.join(self.base_exp_dir, "checkpoints"),
                    exist_ok=True)
        ckpt = {"neus": state_dict_to_jax_params(self.neus_network.state_dict()),
                "iter_step": self.iter_step}
        path = os.path.join(self.base_exp_dir, "checkpoints",
                            f"ckpt_{self.iter_step:06d}.pkl")
        with open(path, "wb") as f:
            pickle.dump(ckpt, f)
        return path

    def load_checkpoint(self, checkpoint_name):
        """Load ``checkpoints/<checkpoint_name>``, of this runner or the JAX
        runner: the network's parameters and ``iter_step``."""
        path = os.path.join(self.base_exp_dir, "checkpoints", checkpoint_name)
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        sd = jax_params_to_state_dict(ckpt["neus"])
        self.neus_network.load_state_dict({k: v.to(self.device)
                                           for k, v in sd.items()})
        self.iter_step = int(ckpt["iter_step"])

    # ------------------------------------------------------------- validate
    @torch.no_grad()
    def _render_rays_batched(self, rays_o, rays_d, want_aux=False):
        """Render rays [N, 3] in batches of ``batch_size`` without
        perturbation; returns numpy rgb [N, 3] and, with ``want_aux``, the
        weighted normals and depths inside the unit sphere."""
        outs_rgb, outs_n, outs_d = [], [], []
        bg = (torch.ones((1, 3), device=self.device) if self.use_white_bkgd
              else None)
        n_total = self.renderer.n_samples + self.renderer.n_importance
        anneal = float(np.float32(self.get_cos_anneal_ratio()))
        for i in range(0, rays_o.shape[0], self.batch_size):
            ro = rays_o[i:i + self.batch_size]
            rd = rays_d[i:i + self.batch_size]
            near, far = self.dataset.near_far_from_sphere(ro, rd)
            out = self.renderer.render(ro, rd, near, far, perturb_overwrite=0,
                                       background_rgb=bg,
                                       cos_anneal_ratio=anneal)
            outs_rgb.append(out["color_fine"])
            if want_aux:
                w = out["weights"][:, :n_total] * out["inside_sphere"]
                outs_n.append((out["gradients"] * w[..., None]).sum(1))
                outs_d.append((out["z_vals"] * w).sum(1))
        rgb = torch.cat(outs_rgb).cpu().numpy()
        if not want_aux:
            return rgb, None, None
        return (rgb, torch.cat(outs_n).cpu().numpy(),
                torch.cat(outs_d).cpu().numpy())

    def validate_image(self, idx=-1, resolution_level=-1):
        """Render camera ``idx`` (a random one if negative) at
        ``resolution_level`` and write the render over its target, the
        camera-space normals and the JET-coloured depth; returns the
        render as uint8 RGB."""
        if idx < 0:
            idx = int(self._rng.integers(self.dataset.n_images))
        if resolution_level < 0:
            resolution_level = self.validate_resolution_level
        print(f"Validate: iter: {self.iter_step}, camera: {idx}", flush=True)
        rays_o, rays_d = self.dataset.gen_rays_at(idx, resolution_level)
        H, W, _ = rays_o.shape
        rgb, normals, depths = self._render_rays_batched(
            rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), want_aux=True)
        for sub in ("validations_fine", "normals", "depths"):
            os.makedirs(os.path.join(self.base_exp_dir, sub), exist_ok=True)
        name = f"{self.iter_step:08d}_0_{idx}.png"
        img = (rgb.reshape(H, W, 3) * 256).clip(0, 255).astype(np.uint8)
        gt = self.dataset.image_at(idx, resolution_level)
        imwrite_bgr(os.path.join(self.base_exp_dir, "validations_fine", name),
                    np.concatenate([img[..., ::-1], gt[..., ::-1]]))
        rot = np.linalg.inv(self.dataset.pose_all[idx][:3, :3].cpu().numpy())
        nimg = (np.matmul(rot[None], normals[:, :, None]).reshape(H, W, 3)
                * 128 + 128).clip(0, 255).astype(np.uint8)
        imwrite_bgr(os.path.join(self.base_exp_dir, "normals", name), nimg)
        depth_u8 = (depths.reshape(H, W) * 255).clip(0, 255).astype(np.uint8)
        imwrite_bgr(os.path.join(self.base_exp_dir, "depths", name),
                    jet_lut()[depth_u8])
        return img

    def render_novel_image(self, idx_0, idx_1, ratio, resolution_level):
        """Render a pose interpolated between two cameras; uint8 RGB."""
        rays_o, rays_d = self.dataset.gen_rays_between(idx_0, idx_1, ratio,
                                                       resolution_level)
        H, W, _ = rays_o.shape
        rgb, _, _ = self._render_rays_batched(rays_o.reshape(-1, 3),
                                              rays_d.reshape(-1, 3))
        return (rgb.reshape(H, W, 3) * 256).clip(0, 255).astype(np.uint8)

    def validate_mesh(self, world_space=False, resolution=64, threshold=0.0):
        """Extract the zero level set over the object's box at
        ``resolution`` into ``meshes_<resolution>/<iter_step>.ply`` (in
        world space by ``scale_mats_np[0]`` if ``world_space``); returns
        the path."""
        from jnerf_tpu_torch.ops.marching import write_ply

        vertices, triangles = self.renderer.extract_geometry(
            self.dataset.object_bbox_min, self.dataset.object_bbox_max,
            resolution=resolution, threshold=threshold)
        out_dir = os.path.join(self.base_exp_dir, f"meshes_{resolution}")
        os.makedirs(out_dir, exist_ok=True)
        if world_space:
            scale_mat = self.dataset.scale_mats_np[0]
            vertices = vertices * scale_mat[0, 0] + scale_mat[:3, 3][None]
        path = os.path.join(out_dir, f"{self.iter_step:08d}.ply")
        write_ply(path, vertices, triangles)
        return path
