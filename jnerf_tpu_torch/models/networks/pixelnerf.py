"""pixelNeRF: image-conditioned NeRF from few reference views.

Counterpart of `jnerf_tpu/models/networks/pixelnerf.py`: PE(L=6, w=1.5),
a 512-wide trunk, 3 ResMLP blocks with the image features injected, a
mean over the references, 2 plain blocks and a head of 4; the image
encoder is a conv pyramid of stages of [64, 64, 128, 256] channels,
bilinearly upsampled to the first stage's resolution and concatenated.

Layouts: the encoder takes and returns NHWC, as the JAX function does,
and runs NCHW inside; its conv weights are OIHW (the JAX tree's are HWIO,
`utils/convert.py` maps them).  JAX's "SAME" padding of a stride-2 conv
is asymmetric (the odd pixel goes on the high side), which
``F.conv2d(padding=...)`` cannot express, so every conv pads with
``F.pad`` first.  ``jax.image.resize(..., "bilinear")`` upsamples with
half-pixel centres and renormalises the edge weights onto the border
pixel, which is what ``F.interpolate(mode="bilinear",
align_corners=False)`` computes by clamping.

The upsample's backward is the separable product ``A_h^T G A_w`` with
the interpolation matrices (`resize_bilinear`), two f32 matmuls with TF32
off that sum in one order on every run, where ``F.interpolate``'s own
backward adds with float atomics in no fixed order.

Everything is f32, as the JAX functions compute on the CPU.  cuDNN rounds
f32 convolution operands to TF32 unless ``torch.backends.cudnn.allow_tf32``
is off, so building an `ImageEncoder` turns it off for the process; the
matmuls keep PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 =
False``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jnerf_tpu_torch.ops.linspace import linspace
from .mlp import Linear, init_linear_


def positional_encoding(x: torch.Tensor, L: int, w: float = 1.5):
    """[x, sin(2^i w x), cos(2^i w x), ...], sin and cos interleaved per
    octave."""
    outs = [x]
    for i in range(L):
        outs.append(torch.sin(2.0 ** i * x * w))
        outs.append(torch.cos(2.0 ** i * x * w))
    return torch.cat(outs, dim=-1)


def _same_pad(size: int, k: int, stride: int):
    """(low, high) padding of JAX's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1):
    """x [B, C, H, W], w [O, I, k, k] -> "SAME" conv, as
    lax.conv_general_dilated."""
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


@functools.lru_cache(maxsize=32)
def interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] f32: the weights of ``F.interpolate``'s bilinear
    resize along one axis (half-pixel centres, align_corners=False, the
    source clamped at 0 and the upper neighbour at the border), computed
    in f32 as it computes them."""
    f = np.float32
    scale = f(n_in) / f(n_out)
    src = np.maximum(scale * (np.arange(n_out, dtype=f) + f(0.5)) - f(0.5),
                     f(0))
    i0 = src.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    lam1 = (src - i0.astype(f)).astype(f)
    a = np.zeros((n_out, n_in), f)
    rows = np.arange(n_out)
    np.add.at(a, (rows, i0), f(1) - lam1)
    np.add.at(a, (rows, i1), lam1)
    return torch.from_numpy(a).to(device)


class _ResizeBilinear(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear", align_corners=False)``
    forward; backward A_h^T g A_w, in a fixed order."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[2:])
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners=False, antialias=False)

    @staticmethod
    def backward(ctx, g):
        (h_in, w_in), (h_out, w_out) = ctx.in_hw, tuple(g.shape[2:])
        a_h = interp_matrix(h_in, h_out, g.device)
        a_w = interp_matrix(w_in, w_out, g.device)
        return a_h.t() @ (g @ a_w), None


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """x [B, C, H, W] -> [B, C, *size], bilinear with half-pixel centres
    (``jax.image.resize``'s "bilinear" upsampling), its gradient summed in
    a fixed order."""
    return _ResizeBilinear.apply(x, tuple(size))


class ImageEncoder(nn.Module):
    """Multi-scale conv features: images [B, H, W, 3] in [0, 1] ->
    [B, H/2, W/2, 512]."""

    STAGES = (64, 64, 128, 256)

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        torch.backends.cudnn.allow_tf32 = False
        self.out_channels = sum(self.STAGES)  # 512
        shapes = {"stem": (self.STAGES[0], 3, 7, 7)}
        cin = self.STAGES[0]
        for i, cout in enumerate(self.STAGES):
            shapes[f"conv{i}a"] = (cout, cin, 3, 3)
            shapes[f"conv{i}b"] = (cout, cout, 3, 3)
            cin = cout
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """U(+-sqrt(6 / fan_in)), fan_in = k * k * cin, as the JAX init."""
        for w in self.parameters():
            bound = math.sqrt(6.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
            with torch.no_grad():
                w.copy_(torch.rand(w.shape, generator=generator,
                                   device=w.device) * (2 * bound) - bound)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = (images * 2.0 - 1.0).permute(0, 3, 1, 2)
        x = torch.relu(_conv(x, self.stem, stride=2))
        target_hw = tuple(x.shape[2:])
        feats = []
        for i in range(len(self.STAGES)):
            stride = 1 if i == 0 else 2
            y = torch.relu(_conv(x, getattr(self, f"conv{i}a"), stride))
            y = torch.relu(_conv(y, getattr(self, f"conv{i}b")))
            x = y
            feats.append(resize_bilinear(y, target_hw))
        return torch.cat(feats, dim=1).permute(0, 2, 3, 1)


def bilinear_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """feat [H, W, C]; uv [N, 2] in pixel coords of feat -> [N, C]."""
    H, W, _ = feat.shape
    u = torch.clamp(uv[:, 0], 0.0, W - 1.001)
    v = torch.clamp(uv[:, 1], 0.0, H - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    flat = feat.reshape(H * W, -1)

    def at(vv, uu):
        return flat[vv * W + uu]

    return (at(v0, u0) * (1 - fu) * (1 - fv)
            + at(v0, u0 + 1) * fu * (1 - fv)
            + at(v0 + 1, u0) * (1 - fu) * fv
            + at(v0 + 1, u0 + 1) * fu * fv)


class _ResMLP(nn.Module):
    def __init__(self, width: int, img_f_ch: int | None):
        super().__init__()
        if img_f_ch is not None:
            self.img = Linear(img_f_ch, width)
        self.a = Linear(width, width)
        self.b = Linear(width, width)

    def forward(self, x, img_f=None):
        if img_f is not None:
            x = x + torch.relu(self.img(img_f))
        h = torch.relu(self.a(x))
        h = torch.relu(self.b(h))
        return h + x


class PixelNeRF(nn.Module):
    """PE -> trunk; 3 ResMLP blocks with image-feature injection; mean over
    references; 2 plain ResMLP blocks; (rgb, sigma) head.  Layer names are
    the JAX tree's keys (``stem``, ``f1_<i>.{img,a,b}``, ``f2_<i>.{a,b}``,
    ``final``)."""

    def __init__(self, img_f_ch=512, net_width=512, L_pos=6, L_dir=0, w=1.5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.img_f_ch = img_f_ch
        self.net_width = net_width
        self.L_pos, self.L_dir, self.w = L_pos, L_dir, w
        self.in_ch = (3 + 6 * L_pos) + (3 + 6 * L_dir)
        W = net_width
        self.stem = Linear(self.in_ch, W)
        for i in range(3):
            setattr(self, f"f1_{i}", _ResMLP(W, img_f_ch))
        for i in range(2):
            setattr(self, f"f2_{i}", _ResMLP(W, None))
        self.final = Linear(W, 4)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """w ~ U(+-sqrt(6 / in)), b = 0, as the JAX init."""
        for m in self.modules():
            if isinstance(m, Linear):
                init_linear_(m.w, generator)
                nn.init.zeros_(m.b)

    def forward(self, img_feature, x, d):
        """img_feature [n_ref, R, S, C]; x [R, S, 3]; d [R, 3] ->
        (rgb [R, S, 3], sigma [R, S])."""
        n_ref = img_feature.shape[0]
        x_enc = positional_encoding(x, self.L_pos, self.w)
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
        d_enc = positional_encoding(d, self.L_dir, self.w)
        d_enc = d_enc[:, None, :].expand(x.shape[:2] + (d_enc.shape[-1],))
        xd = torch.cat([x_enc, d_enc], dim=-1)[None]
        f = torch.relu(self.stem(xd))
        f = f.expand((n_ref,) + f.shape[1:])
        for i in range(3):
            f = getattr(self, f"f1_{i}")(f, img_feature)
        f = f.mean(dim=0)
        for i in range(2):
            f = getattr(self, f"f2_{i}")(f)
        out = self.final(f)
        return torch.sigmoid(out[..., 1:]), torch.relu(out[..., 0])


def render_rays_pixelnerf(net: PixelNeRF, rays_o, rays_d, bound, n_samples,
                          feature_fn, u: torch.Tensor | None = None):
    """Coarse-only stratified rendering.

    feature_fn(pts [R, S, 3]) -> [n_ref, R, S, C] projected features.
    ``u`` [S] is the stratified jitter's uniform draw (the JAX function's
    ``jax.random.uniform(key, (S,))``); without it every sample sits at the
    middle of its bin.
    """
    near, far = bound
    dev = rays_o.device
    k = 0.5 / n_samples if u is None else u / n_samples
    base = linspace(0.0, 1.0, n_samples + 1, device=dev)[:-1]
    z_vals = near + (far - near) * (base + k)  # [S]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[None, :, None]

    feats = feature_fn(pts)
    rgb, sigma = net(feats, pts, rays_d)

    delta = torch.diff(z_vals)
    delta = torch.cat([delta, delta.new_full((1,), 1e10)])
    delta = delta[None, :] * torch.sqrt(
        (rays_d * rays_d).sum(-1, keepdim=True))
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1 - alpha + 1e-7], -1), -1)[:, :-1]
    w = alpha * trans
    rgb_map = torch.sum(w[..., None] * rgb, dim=-2)
    depth_map = torch.sum(w * z_vals[None, :], -1)
    acc_map = torch.sum(w, -1)
    return rgb_map, depth_map, acc_map
