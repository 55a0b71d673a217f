"""pixelNeRF mini-project: train an image-conditioned NeRF from few views.

    python -m jnerf_tpu_torch.projects.pixelnerf.main --synthetic \\
        [--epochs 10] [--device cuda|cpu]

Counterpart of `projects/pixelnerf/main.py`, with its flags plus
``--device`` (``cuda``, the default, refuses to run without a card): 3
reference views, batches of 2048 rays, Adam at 1e-4, bound (2, 6) and 64
samples.  The encoder trains with the network: each step encodes the
reference images again under autograd.  ``--data`` reads the tiny-nerf
``.npz``; without it the in-repo analytic scene is rendered.  Batch rows
are drawn on the host with ``np.random.default_rng(0)``, as the JAX script
draws them; the stratified jitter comes from a ``draws`` iterator, which a
test fills with the JAX keys' draws.  Each epoch prints ``epoch {ep}:
loss=...``, and the parameters are saved as ``pixelnerf.pkl`` in the JAX
tree's layout (`utils/convert.py`).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch
from torch import nn

from jnerf_tpu_torch.models.networks.pixelnerf import (
    ImageEncoder, PixelNeRF, bilinear_sample, render_rays_pixelnerf,
)
from jnerf_tpu_torch.optims import AdamOptimizer
from jnerf_tpu_torch.utils.convert import state_dict_to_jax_params

BOUND = (2.0, 6.0)
N_SAMPLES = 64
LR = 1e-4
SEED = 999  # the JAX script's PRNGKey


def require_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device


def load_tiny_nerf(path):
    z = np.load(path)
    return z["images"], z["poses"], float(z["focal"])


def make_synthetic(n_images=24, H=100, W=100):
    """The analytic scene from a ring of cameras at radius 4, on a black
    background: (images [n, H, W, 3], poses [n, 4, 4], focal)."""
    from jnerf_tpu_torch.dataset.synthetic import (
        _look_at_pose, render_analytic,
    )

    cax = 0.6911112070083618
    rng = np.random.default_rng(0)
    images, poses = [], []
    for i in range(n_images):
        th = 2 * np.pi * i / n_images
        ph = np.radians(rng.uniform(-5, 40))
        eye = 4.0 * np.array([np.cos(th) * np.cos(ph), np.sin(th) * np.cos(ph),
                              np.sin(ph)])
        pose = _look_at_pose(eye)
        img = render_analytic(pose, H, W, cax).numpy()
        images.append(img[..., :3] * img[..., 3:])  # black background
        poses.append(np.concatenate([pose, [[0, 0, 0, 1]]], 0))
    focal = 0.5 * W / np.tan(0.5 * cax)
    return (np.stack(images).astype(np.float32),
            np.stack(poses).astype(np.float32), focal)


def camera_rays(images, poses, focal):
    """Every pixel's ray of every image: (rays_o, rays_d, rgbs), each
    [n * H * W, 3] numpy f32, image-major."""
    H, W = images.shape[1:3]
    ys, xs = np.mgrid[0:H, 0:W]
    cam_dirs = np.stack(
        [(xs - W * 0.5 + 0.5) / focal, -(ys - H * 0.5 + 0.5) / focal,
         -np.ones_like(xs, np.float32)], -1,
    ).astype(np.float32)
    rays_o, rays_d, rgbs = [], [], []
    for img, pose in zip(images, poses):
        d = (cam_dirs @ pose[:3, :3].T).reshape(-1, 3)
        rays_d.append(d)
        rays_o.append(np.broadcast_to(pose[:3, 3], d.shape))
        rgbs.append(img.reshape(-1, 3))
    return tuple(map(np.concatenate, (rays_o, rays_d, rgbs)))


class ReferenceProjector:
    """Project world points into the reference views and sample their conv
    features."""

    def __init__(self, encoder, ref_images, ref_poses, focal):
        self.feats = encoder(ref_images)  # [n, h, w, C]
        self.w2c = torch.as_tensor(np.linalg.inv(ref_poses),
                                   device=ref_images.device)  # [n, 4, 4]
        self.focal = float(focal)
        self.H, self.W = ref_images.shape[1:3]

    def __call__(self, pts):
        R, S, _ = pts.shape
        flat = pts.reshape(-1, 3)
        outs = []
        fh, fw = self.feats.shape[1:3]
        sx, sy = fw / self.W, fh / self.H
        for i in range(self.feats.shape[0]):
            cam = flat @ self.w2c[i, :3, :3].T + self.w2c[i, :3, 3]
            # OpenGL camera: looks down -z.
            z = torch.clamp(-cam[:, 2], min=1e-6)
            u = (cam[:, 0] / z) * self.focal + self.W / 2
            v = (-cam[:, 1] / z) * self.focal + self.H / 2
            outs.append(bilinear_sample(self.feats[i],
                                        torch.stack([u * sx, v * sy], -1)))
        return torch.stack(outs).reshape(len(outs), R, S, -1)


def build_model(device="cuda", net_width=512, seed=SEED) -> nn.ModuleDict:
    """``ModuleDict(enc=ImageEncoder, net=PixelNeRF)`` initialised from a
    CPU generator seeded ``seed``, then moved to ``device``."""
    device = require_device(device)
    gen = torch.Generator().manual_seed(seed)
    encoder = ImageEncoder(generator=gen)
    net = PixelNeRF(img_f_ch=encoder.out_channels, net_width=net_width,
                    generator=gen)
    return nn.ModuleDict({"enc": encoder, "net": net}).to(device)


def uniform_draws(n, device, seed=SEED):
    """Endless [n] U[0, 1) draws from a CPU generator, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield torch.rand((n,), generator=gen).to(device)


def loss_fn(model, ref_images, ref_poses, focal, ro, rd, target, u,
            n_samples=N_SAMPLES):
    """MSE of the rendered rays; the references are encoded inside, so the
    gradient reaches the encoder."""
    proj = ReferenceProjector(model["enc"], ref_images, ref_poses, focal)
    rgb, _, _ = render_rays_pixelnerf(model["net"], ro, rd, BOUND, n_samples,
                                      proj, u=u)
    return torch.mean((rgb - target) ** 2)


def train(model, images, poses, focal, n_ref=3, epochs=10, batch=2048,
          n_samples=N_SAMPLES, draws=None, lr=LR):
    """Train ``model`` on the views after the first ``n_ref``, which are the
    references.  Prints one line an epoch and returns ``{"epoch_loss",
    "step_loss", "seconds"}`` (the loop's host time; each step reads its
    loss back, which waits for the device).  The steps run with cuDNN's
    deterministic convolution algorithms (and TF32 off), so that a seed
    repeats."""
    device = next(model.parameters()).device
    rays = [torch.as_tensor(a, device=device)
            for a in camera_rays(images[n_ref:], poses[n_ref:], focal)]
    n_rays = rays[0].shape[0]
    ref_images = torch.as_tensor(images[:n_ref], device=device)
    ref_poses = poses[:n_ref]
    opt = AdamOptimizer(model.parameters(), lr)
    draws = uniform_draws(n_samples, device) if draws is None else draws

    rng = np.random.default_rng(0)
    steps_per_epoch = max(1, n_rays // batch)
    epoch_loss, step_loss = [], []
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for ep in range(epochs):
            losses = []
            for _ in range(steps_per_epoch):
                sel = torch.as_tensor(rng.integers(0, n_rays, batch),
                                      device=device)
                ro, rd, target = (r[sel] for r in rays)
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, ref_images, ref_poses, focal, ro, rd,
                               target, next(draws).to(device), n_samples)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
            step_loss += losses
            epoch_loss.append(float(np.mean(losses)))
            print(f"epoch {ep}: loss={np.mean(losses):.5f}", flush=True)
    return {"epoch_loss": epoch_loss, "step_loss": step_loss,
            "seconds": time.perf_counter() - t0}


def save(model, out) -> str:
    """Write ``pixelnerf.pkl`` (the JAX tree, numpy leaves) into ``out``."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "pixelnerf.pkl")
    with open(path, "wb") as f:
        pickle.dump(state_dict_to_jax_params(model.state_dict()), f)
    print("saved", path)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="", help="tiny_nerf_data.npz path")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--n-ref", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch", type=int, default=2048)
    parser.add_argument("--out", default="./logs/pixelnerf")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    model = build_model(args.device)
    if args.data:
        images, poses, focal = load_tiny_nerf(args.data)
    else:
        images, poses, focal = make_synthetic()
    hist = train(model, images, poses, focal, n_ref=args.n_ref,
                 epochs=args.epochs, batch=args.batch)
    save(model, args.out)
    return model, hist


if __name__ == "__main__":
    main()
