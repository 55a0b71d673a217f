"""Plain PyTorch reference of the NeRF training step and of rendering.

It imports nothing of the program.  From the configuration, the scene on
disk, the weights the benchmark made and the seed of the draws, it works
out again what the program computes: the occupancy grid's first refresh
(cameras' frustums, one jittered density query a cell, the decay-max
update, the threshold at the mean), the march (candidates at the constant
step from a jittered start, occupancy probed once a segment of
``stride`` candidates, the first S occupied kept), the field
(`configs/<name>.py`), compositing, the Huber loss with the early density
push, Adam and the EMA.  Rendering marches 4096-ray chunks at the
inference budget on a given occupancy bitfield (`solid_bitfield`: the
cells that the scene's solids meet) and composites without a background
term.

Precision follows the configuration: with ``fp16`` the field's products
take operands rounded to ``Quant.dtype`` (bfloat16), summed in float32,
and every rounding's gradient is rounded too; the hash table's rounding
passes its gradient through unrounded.  The control runs the same code
with float8 (e4m3) in place of bfloat16.  TF32 is off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import scene as scene_mod

NERF_SCALE = 0.33
NERF_OFFSET = (0.5, 0.5, 0.5)
DENSITY_CAP = 15.0
MIN_OPTICAL_THICKNESS = 0.01
L1_COEF = 1e-4 / 384.0
RENDER_CHUNK = 4096


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- precision
class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype, grad_too):
        ctx.dtype, ctx.grad_too = dtype, grad_too
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return (g.to(ctx.dtype).float() if ctx.grad_too else g), None, None


@dataclass(frozen=True)
class Quant:
    """Rounding to ``dtype`` (None: float32 throughout)."""

    dtype: torch.dtype | None

    def cast(self, x):
        """A cast: the value and its gradient are rounded."""
        return x.float() if self.dtype is None else _Round.apply(x.float(),
                                                                 self.dtype,
                                                                 True)

    def value(self, x):
        """The value rounded; the gradient passes unrounded."""
        return x.float() if self.dtype is None else _Round.apply(x.float(),
                                                                 self.dtype,
                                                                 False)

    def linear(self, x, w, b=None):
        y = self.cast(x) @ self.cast(w)
        return y if b is None else y + b


def quant_for(cfg: dict, control: bool) -> Quant:
    if not cfg.get("fp16", True):
        return Quant(torch.bfloat16 if control else None)
    return Quant(torch.float8_e4m3fn if control else torch.bfloat16)


# ---------------------------------------------------------------- scene
def nerf_to_ngp(pose: np.ndarray) -> np.ndarray:
    """A Blender [3, 4] camera-to-world in the NGP unit cube: y and z
    axes flipped, translation scaled by 0.33 and offset to the cube's
    centre, rows cycled (x, y, z) -> (y, z, x)."""
    m = np.array(pose, np.float32, copy=True)
    m[:, 1] *= -1
    m[:, 2] *= -1
    m[:, 3] = m[:, 3] * np.float32(NERF_SCALE) + np.asarray(NERF_OFFSET,
                                                            np.float32)
    return m[[1, 2, 0]]


def focal_of(width: int, camera_angle_x: float) -> float:
    return 0.5 * width / math.tan(0.5 * math.radians(
        camera_angle_x * 180 / math.pi))


class Scene:
    """The training split on ``device``: pixels [N*H*W, 4] f32 from the
    PNGs, NGP-space poses [N, 3, 4], focal length."""

    def __init__(self, root: str, device):
        angle, poses, files = scene_mod.load_split(root, "train")
        imgs = np.stack([scene_mod.read_png(f) for f in files])
        self.n, self.H, self.W = imgs.shape[:3]
        self.pixels = torch.from_numpy(
            imgs.reshape(-1, 4).astype(np.float32) / 255.0).to(device)
        self.poses = torch.from_numpy(
            np.stack([nerf_to_ngp(p) for p in poses])).to(device)
        self.focal = focal_of(self.W, angle)


def pixel_rays(scene: Scene, idx):
    """Rays (o, d) [B, 3] through the centres of flat pixel indices."""
    hw = scene.H * scene.W
    img, off = idx // hw, idx % hw
    x = ((off % scene.W).float() + 0.5) / scene.W
    y = ((off // scene.W).float() + 0.5) / scene.H
    d_cam = torch.stack([(x - 0.5) * scene.W / scene.focal,
                         (y - 0.5) * scene.H / scene.focal,
                         torch.ones_like(x)], dim=-1)
    pose = scene.poses[img]
    d = torch.einsum("bij,bj->bi", pose[:, :, :3], d_cam)
    return pose[:, :, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)


def image_rays(pose_ngp, H, W, focal):
    """Rays of every pixel of a view, row-major."""
    dev = pose_ngp.device
    y, x = torch.meshgrid((torch.arange(H, device=dev).float() + 0.5) / H,
                          (torch.arange(W, device=dev).float() + 0.5) / W,
                          indexing="ij")
    d_cam = torch.stack([(x.reshape(-1) - 0.5) * W / focal,
                         (y.reshape(-1) - 0.5) * H / focal,
                         torch.ones(H * W, device=dev)], dim=-1)
    d = d_cam @ pose_ngp[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return pose_ngp[:, 3].expand(H * W, 3), d


# ------------------------------------------------------- occupancy, march
@dataclass(frozen=True)
class Geom:
    """The occupancy grid and march of a unit aabb (aabb_scale 1: one
    cascade marched, the next one pooled)."""

    grid: int = 128
    max_steps: int = 1024
    near: float = 0.2
    cascades: int = 5

    @property
    def stepsize(self):
        return math.sqrt(3.0) / self.max_steps

    @property
    def dt(self):
        return 0.5 * self.stepsize

    @property
    def n_candidates(self):
        k = min(int(math.ceil(math.sqrt(3.0) / self.dt)), 4 * self.max_steps)
        return max(-(-k // 128) * 128, 128)

    @property
    def stride(self):
        s = max(1, int(round((1.0 / self.grid) / self.dt)))
        return min(1 << (s.bit_length() - 1), 8)


def geom_of(cfg: dict) -> Geom:
    if not cfg.get("const_dt"):
        raise ValueError("the reference marches at a constant step only")
    return Geom(grid=int(cfg.get("grid_size") or 128),
                max_steps=int(cfg.get("nerf_steps") or 1024),
                near=float(cfg.get("near_distance") or 0.05))


def mip_of(x, y, z, geom: Geom):
    """Finest cascade holding the point (frexp exponent of its largest
    offset from the centre, plus one)."""
    m = torch.maximum(torch.abs(x - 0.5),
                      torch.maximum(torch.abs(y - 0.5), torch.abs(z - 0.5)))
    e = torch.frexp(torch.clamp(m, min=1e-10)).exponent.to(torch.int64)
    return torch.clamp(e + 1, 0, geom.cascades - 1)


def occupied(bits, x, y, z, geom: Geom):
    """bits [C, G, G, G] bool at points (x, y, z)."""
    g = geom.grid
    mip = mip_of(x, y, z, geom)
    scale = torch.exp2(-mip.float())

    def cell(p):
        return torch.clamp(torch.floor(((p - 0.5) * scale + 0.5) * g).long(),
                           0, g - 1)

    return bits[mip, cell(x), cell(y), cell(z)]


def march(geom: Geom, bits, rays_o, rays_d, u, n_samples: int):
    """[R, S] samples: (warped positions [R, S, 3], dirs [R, S, 3],
    dts [R, S], valid [R, S], demand [R])."""
    inv = 1.0 / rays_d
    t0 = (0.0 - rays_o) * inv
    t1 = (1.0 - rays_o) * inv
    tmin = torch.clamp(torch.amax(torch.minimum(t0, t1), dim=-1), min=0.0)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    tmax = torch.where(tmax >= tmin, tmax, tmin)
    tmin = torch.clamp(tmin, min=geom.near)
    start = tmin + geom.dt * u

    stride = geom.stride
    while stride > 1 and n_samples % stride:
        stride //= 2
    dev = rays_o.device
    k = torch.arange(0, geom.n_candidates, stride, device=dev).float()[None]

    def t_at(kk):
        return start[:, None] + kk * geom.dt

    tp = 0.5 * (t_at(k) + t_at(k + (stride - 1)))
    q = [rays_o[:, None, i] + tp * rays_d[:, None, i] for i in range(3)]
    inside = tp <= tmax[:, None]
    for c in q:
        inside &= (c >= 0.0) & (c <= 1.0)
    occ = inside & occupied(bits, *q, geom)

    n_seg = n_samples // stride
    cum = torch.cumsum(occ.long(), dim=1)
    seg = torch.searchsorted(cum, torch.arange(1, n_seg + 1, device=dev)
                             .expand(occ.shape[0], n_seg).contiguous())
    seg = torch.clamp(seg, max=occ.shape[1] - 1)
    cand = (seg[:, :, None] * stride
            + torch.arange(stride, device=dev)).reshape(-1, n_samples)
    demand = cum[:, -1] * stride
    t = t_at(cand.float())
    valid = (torch.arange(n_samples, device=dev)[None] < demand[:, None]) \
        & (t <= tmax[:, None])
    w = [rays_o[:, None, i] + t * rays_d[:, None, i] for i in range(3)]
    for c in w:
        valid &= (c >= 0.0) & (c <= 1.0)
    pos = torch.stack([torch.where(valid, torch.clamp(c, 0.0, 1.0),
                                   torch.full_like(c, 0.5)) for c in w], -1)
    dirs = (rays_d * 0.5 + 0.5)[:, None, :].expand(pos.shape)
    dts = torch.where(valid, torch.full_like(t, geom.dt), torch.zeros_like(t))
    return pos, dirs, dts, valid, torch.clamp(demand, max=geom.max_steps)


def first_refresh(geom: Geom, field, params, q: Quant, scene: Scene, jitter):
    """The grid's refresh before the first step: (bitfield [C, G, G, G],
    mean thickness).  Cells that no training camera's frustum holds are
    untrained (-1); every other cell takes the thickness of one density
    query at ``jitter`` [1, 3, G^3] inside it."""
    g, dev = geom.grid, scene.pixels.device
    lin = torch.arange(g ** 3, device=dev)
    ijk = (lin // (g * g), (lin // g) % g, lin % g)
    centre = [(c.float() + 0.5) / g for c in ijk]
    radius = 0.5 * math.sqrt(3.0) / g
    seen = torch.zeros(g ** 3, dtype=torch.bool, device=dev)
    for pose in scene.poses:
        rel = [centre[i] - pose[i, 3] for i in range(3)]
        x, y, z = (rel[0] * pose[0, j] + rel[1] * pose[1, j]
                   + rel[2] * pose[2, j] for j in range(3))
        seen |= ((z > 0)
                 & (torch.abs(x) - radius < z / scene.focal * (0.5 * scene.W))
                 & (torch.abs(y) - radius < z / scene.focal * (0.5 * scene.H)))
    pts = torch.stack([((ijk[d].float() + jitter[0, d]) / g - 0.5) + 0.5
                       for d in range(3)], dim=-1)
    with torch.no_grad():
        raw = torch.cat([field.density(params, pts[i:i + (1 << 17)], q)
                         for i in range(0, pts.shape[0], 1 << 17)])
    thick = torch.exp(torch.clamp(raw, max=DENSITY_CAP)) * geom.stepsize
    grid0 = torch.where(seen, torch.maximum(torch.zeros_like(thick), thick),
                        torch.full_like(thick, -1.0))
    mean = torch.mean(torch.relu(grid0))
    bits0 = (grid0 > torch.clamp(mean, max=MIN_OPTICAL_THICKNESS)).reshape(
        g, g, g)
    return cascades_of(geom, bits0), mean


def cascades_of(geom: Geom, bits0):
    """The bitfield [C, G, G, G] of the marched cascade's ``bits0``, the
    next cascade pooled from it (2^3 cells into one, at its centre)."""
    g = geom.grid
    bits = torch.zeros((geom.cascades, g, g, g), dtype=torch.bool,
                       device=bits0.device)
    bits[0] = bits0
    pooled = bits0.reshape(g // 2, 2, g // 2, 2, g // 2, 2).any(5).any(3).any(1)
    a, b = g // 4, 3 * g // 4
    bits[1, a:b, a:b, a:b] = pooled
    return bits


def ngp_points(p):
    """Blender-space points [..., 3] in the NGP unit cube (the map that
    `nerf_to_ngp` applies to a camera's position)."""
    q = p * NERF_SCALE + torch.as_tensor(NERF_OFFSET, dtype=p.dtype,
                                          device=p.device)
    return q[..., [1, 2, 0]]


def solid_bitfield(geom: Geom, centers, radii, device):
    """The occupancy bitfield of solid spheres (Blender-space ``centers``
    [K, 3] and ``radii`` [K]): a cell is occupied when its cube meets a
    sphere."""
    g = geom.grid
    f64 = torch.float64
    c = ngp_points(torch.as_tensor(centers, dtype=f64, device=device))
    r = torch.as_tensor(radii, dtype=f64, device=device) * NERF_SCALE
    lo = torch.arange(g, dtype=f64, device=device) / g
    bits0 = torch.zeros((g, g, g), dtype=torch.bool, device=device)
    for k in range(c.shape[0]):
        # Squared distance from the centre to each cell's cube, by axis.
        d2 = [(torch.clamp(c[k, i], lo, lo + 1.0 / g) - c[k, i]) ** 2
              for i in range(3)]
        bits0 |= (d2[0][:, None, None] + d2[1][None, :, None]
                  + d2[2][None, None, :]) <= r[k] ** 2
    return cascades_of(geom, bits0)


# ------------------------------------------------------------ compositing
def composite(raw_rgb, raw_sigma, dts, valid):
    """(rgb [R, 3], final transmittance [R]) of [R, S] samples."""
    sigma = torch.exp(torch.clamp(raw_sigma, max=DENSITY_CAP))
    alpha = torch.where(valid, 1.0 - torch.exp(-sigma * dts),
                        torch.zeros_like(dts))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    rgb = torch.sum((alpha * before)[..., None] * torch.sigmoid(raw_rgb), 1)
    return rgb, trans[:, -1]


def run_field(field, params, q, pos, dirs, valid):
    """The field on the valid samples only; (raw rgb [R, S, 3], raw sigma
    [R, S]) with zeros elsewhere (an empty sample adds nothing)."""
    r, s = valid.shape
    flat = valid.reshape(-1)
    out = field.forward(params, pos.reshape(-1, 3)[flat],
                        dirs.reshape(-1, 3)[flat], q)
    full = out.new_zeros((r * s, 4)).index_put((flat.nonzero()[:, 0],), out)
    full = full.reshape(r, s, 4)
    return full[..., :3], full[..., 3]


def huber(x, y, delta):
    d = torch.abs(x - y)
    return torch.where(d > delta, d - 0.5 * delta, 0.5 / delta * d * d)


# --------------------------------------------------------------- training
def train_steps(cfg, field, params0, scene: Scene, draw_seed: int,
                n_steps: int, q: Quant, n_rays: int):
    """``n_steps`` optimizer steps from ``params0`` (a dict of tensors),
    drawing as the program's runner draws from a generator seeded with
    ``draw_seed``.  Returns (main losses [n], first gradients {name:
    tensor}, parameters after the last step {name: tensor})."""
    geom = geom_of(cfg)
    dev = scene.pixels.device
    gen = torch.Generator(dev).manual_seed(draw_seed)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = cfg["optim"]
    b1, b2 = opt["betas"]
    lr, eps = opt["lr"], opt["eps"]
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    shadow = {k: v.detach().clone() for k, v in params.items()}
    decay = cfg["ema"]["decay"]
    target = int(cfg["target_batch_size"])
    n_samples = min(target // n_rays, 256, geom.n_candidates)
    cap = cfg.get("compacted_batch")
    if cap and n_rays * n_samples > cap:
        raise ValueError("the reference does not compact a batch")
    delta = cfg["loss"]["delta"]
    losses, first_grads = [], None

    jitter = torch.rand((1, 3, geom.grid ** 3), generator=gen, device=dev)
    bits, mean = first_refresh(geom, field, params, q, scene, jitter)
    bg_push = float(mean < MIN_OPTICAL_THICKNESS)
    n_pixels = scene.pixels.shape[0]
    for step in range(1, n_steps + 1):
        idx = torch.randint(0, n_pixels, (n_rays,), generator=gen, device=dev)
        bg = torch.rand((n_rays, 3), generator=gen, device=dev)
        u = torch.rand((n_rays,), generator=gen, device=dev)
        rgba = scene.pixels[idx]
        target_rgb = rgba[:, :3] * rgba[:, 3:] + bg * (1.0 - rgba[:, 3:])
        o, d = pixel_rays(scene, idx)
        pos, dirs, dts, valid, _ = march(geom, bits, o, d, u, n_samples)
        raw_rgb, raw_sigma = run_field(field, params, q, pos, dirs, valid)
        rgb, t_final = composite(raw_rgb, raw_sigma, dts, valid)
        rgb = rgb + t_final[:, None] * bg
        main = torch.mean(huber(rgb, target_rgb, delta))
        push = bg_push * L1_COEF * torch.sum(
            torch.where(valid, torch.relu(-raw_sigma), torch.zeros_like(dts)))
        grads = torch.autograd.grad(main + push, list(params.values()),
                                    allow_unused=True)
        losses.append(float(main.detach()))
        with torch.no_grad():
            if first_grads is None:
                first_grads = {k: (g if g is not None else torch.zeros_like(v))
                               for (k, v), g in zip(params.items(), grads)}
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            keep = 1.0 - decay
            mix = decay * (1.0 - decay ** (step - 1))
            debias = 1.0 / (1.0 - decay ** step)
            for (k, p), g in zip(params.items(), grads):
                if g is None:
                    g = torch.zeros_like(p)
                mu[k].mul_(b1).add_(g * (1.0 - b1))
                nu[k].mul_(b2).add_(g * g * (1.0 - b2))
                p.sub_(lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                p.mul_(keep).add_(shadow[k] * mix).mul_(debias)
                shadow[k].copy_(p)
    return losses, first_grads, {k: v.detach() for k, v in params.items()}


# -------------------------------------------------------------- rendering
@torch.no_grad()
def render_view(cfg, field, params, bits, pose_blender, H, W, focal, u,
                q: Quant):
    """One view [H, W, 3] (numpy) on the occupancy ``bits``: chunks of
    4096 rays, each ray of a chunk starting at its entry of ``u`` [4096],
    at the inference budget of 256 samples a ray, no background term."""
    geom = geom_of(cfg)
    n_samples = min(256, geom.n_candidates)
    dev = bits.device
    pose = torch.from_numpy(nerf_to_ngp(pose_blender)).to(dev)
    o, d = image_rays(pose, H, W, focal)
    out = []
    for a in range(0, H * W, RENDER_CHUNK):
        oc, dc = o[a:a + RENDER_CHUNK], d[a:a + RENDER_CHUNK]
        pos, dirs, dts, valid, _ = march(geom, bits, oc, dc,
                                         u[:oc.shape[0]], n_samples)
        raw_rgb, raw_sigma = run_field(field, params, q, pos, dirs, valid)
        out.append(composite(raw_rgb, raw_sigma, dts, valid)[0])
    return torch.cat(out).reshape(H, W, 3).cpu().numpy()
