"""Fused Instant-NGP MLP: density + RGB networks in one kernel each way.

Same function as `jnerf_tpu/ops/fused_mlp.py` (``fused_ngp_mlp`` and its
custom VJP, ``fused_density_mlp``)::

    pos_feat[N,32] -> density MLP (32->64->16) = dout ->+
                                                        |-> rgb MLP
    dir_feat[N,16] -------------------------------------+   (32->64->64->3)

    out[N,4] = [rgb logits, dout[:, 0]]   (f32)

bias-free, with bf16 operands, f32 accumulation, ReLU in f32 and each
hidden activation re-quantized to bf16; the rgb input "concat" is two
partial products on the row halves of V0, summed after.  The backward
recomputes the forward and mirrors the JAX kernel's cast schedule: the
rgb lanes of g rounded to bf16, lane 3 (the sigma gradient) added to
d(dout)[:, 0] in f32 before its bf16 rounding, and every cotangent that
feeds a product rounded to bf16.  ``dir_feat`` gets no gradient.

Three CUDA kernels (`jnerf_tpu_torch/csrc/fused_mlp.cu`) compute these:
``fused_mlp_fwd`` (F-MLP), ``fused_mlp_bwd`` (B-MLP, weight gradients
reduced in a fixed order, without atomics) and ``fused_density_mlp``
(D-MLP, the forward's density half), which share one tensor-core
forward.  Each wrapper runs its plain PyTorch twin
(``fused_ngp_mlp_plain``, ``fused_ngp_mlp_bwd_plain``,
``fused_density_mlp_plain``) only when given CPU tensors; for CUDA tensors
it launches the kernel or raises.  Each wrapper counts its launches in
``.launches``.  The kernels take any row count; the network's gate keeps
the JAX package's ``N % _BLK == 0`` rule.
"""

from __future__ import annotations

import torch

D_IN = 32     # hash-encode features
D_HID = 64
D_GEO = 16    # density-MLP output width (col 0 = raw sigma)
SH_DIM = 16   # SH degree-4 view encoding
RGB_IN = D_GEO + SH_DIM
_BLK = 8192   # the JAX package's row block: the fused path needs N % _BLK == 0

WEIGHT_SHAPES = ((D_IN, D_HID), (D_HID, D_GEO), (RGB_IN, D_HID),
                 (D_HID, D_HID), (D_HID, 3))
_N_GRAD = sum(a * b for a, b in WEIGHT_SHAPES)  # 9408


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep f32."""
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------ plain twins
def _forward_chain(weights, pos_feat, dir_feat):
    """The forward with its intermediates (f32 tensors holding the values
    the JAX kernel computes; products of bf16-exact values are exact)."""
    w0, w1, v0, v1, v2 = (_bf(w.float()) for w in weights)
    x, d = _bf(pos_feat.float()), _bf(dir_feat.float())
    a0 = x @ w0
    hb = _bf(torch.relu(a0))
    dout = hb @ w1
    db = _bf(dout)
    a1 = db @ v0[:D_GEO] + d @ v0[D_GEO:]
    r1b = _bf(torch.relu(a1))
    a2 = r1b @ v1
    r2b = _bf(torch.relu(a2))
    rgb = r2b @ v2
    return (w0, w1, v0, v1, v2), (x, d), (a0, hb, dout, db, a1, r1b, a2, r2b,
                                          rgb)


def fused_ngp_mlp_plain(weights, pos_feat, dir_feat) -> torch.Tensor:
    """Plain twin of F-MLP: [N, 4] f32 = [rgb logits, raw sigma]."""
    _, _, (*_, dout, _db, _a1, _r1b, _a2, _r2b, rgb) = _forward_chain(
        weights, pos_feat, dir_feat)
    return torch.cat([rgb, dout[:, :1]], dim=1)


def fused_ngp_mlp_bwd_plain(weights, pos_feat, dir_feat, g):
    """Plain twin of B-MLP, the torch mirror of the JAX ``_fused_bwd``:
    returns ((dW0, dW1, dV0, dV1, dV2), dpos_feat), all f32."""
    (w0, w1, v0, v1, v2), (x, d), (a0, hb, _dout, db, a1, r1b, a2, r2b,
                                   _rgb) = _forward_chain(weights, pos_feat,
                                                          dir_feat)
    g = g.float()
    g4 = _bf(g[:, :3])
    dr2 = _bf((g4 @ v2.T) * (a2 > 0))
    dv2 = r2b.T @ g4
    dr1 = _bf((dr2 @ v1.T) * (a1 > 0))
    dv1 = r1b.T @ dr2
    d_dout = dr1 @ v0[:D_GEO].T
    d_dout = _bf(torch.cat([d_dout[:, :1] + g[:, 3:4], d_dout[:, 1:]], dim=1))
    dv0 = torch.cat([db.T @ dr1, d.T @ dr1], dim=0)
    dh = _bf((d_dout @ w1.T) * (a0 > 0))
    dw1 = hb.T @ d_dout
    dx = dh @ w0.T
    dw0 = x.T @ dh
    return (dw0, dw1, dv0, dv1, dv2), dx


def fused_density_mlp_plain(w0, w1, pos_feat) -> torch.Tensor:
    """Plain twin of D-MLP: raw sigma [N, 1] f32."""
    hb = _bf(torch.relu(_bf(pos_feat.float()) @ _bf(w0.float())))
    return hb @ _bf(w1.float())[:, :1]


# ---------------------------------------------------------- kernel wrappers
def _cuda_args(pos_feat, dir_feat=None, weights=(), g=None):
    """Check and lay out the kernels' inputs on one card, contiguous and
    16-byte aligned: the feature rows bf16 (as the network feeds them;
    rounding here is the kernels' own input rounding), weights and g f32."""
    dev = pos_feat.device
    n = pos_feat.shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    named = [("pos_feat", pos_feat, (n, D_IN), bf16)]
    if dir_feat is not None:
        named.append(("dir_feat", dir_feat, (n, SH_DIM), bf16))
    named += [(f"weight {i}", w, s, f32) for i, (w, s) in
              enumerate(zip(weights, WEIGHT_SHAPES))]
    if g is not None:
        named.append(("g", g, (n, 4), f32))
    out = []
    for name, tns, shape, dtype in named:
        if tns.device != dev or tuple(tns.shape) != shape \
                or tns.dtype not in (f32, bf16):
            raise ValueError(f"{name} must be {shape} float32 or bfloat16 on "
                             f"{dev}, got {tuple(tns.shape)} {tns.dtype} on "
                             f"{tns.device}")
        tns = tns.detach().to(dtype).contiguous()
        out.append(tns.clone() if tns.data_ptr() % 16 else tns)
    return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_mlp_fwd(weights, pos_feat, dir_feat) -> torch.Tensor:
    """F-MLP: weights (w0, w1, v0, v1, v2), [N, 32], [N, 16] -> [N, 4] f32."""
    if pos_feat.device.type == "cpu":
        return fused_ngp_mlp_plain(weights, pos_feat, dir_feat)
    if pos_feat.device.type != "cuda":
        raise ValueError(f"fused MLP takes CPU or CUDA tensors, got "
                         f"{pos_feat.device}")
    if len(weights) != 5:
        raise ValueError("fused MLP takes five weights")
    x, d, *ws = _cuda_args(pos_feat, dir_feat, weights)
    from .cuda_lib import check, fused_mlp_lib

    lib = fused_mlp_lib()
    n, dev = x.shape[0], x.device
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        status = lib.fused_mlp_fwd(x.data_ptr(), d.data_ptr(),
                                   *(w.data_ptr() for w in ws),
                                   out.data_ptr(), n, _stream(dev))
    check(status, "fused_mlp_fwd")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(weights, pos_feat, dir_feat, g):
    """B-MLP: ((dW0, dW1, dV0, dV1, dV2), dpos_feat), all f32, from the
    upstream gradient g [N, 4].  The weight gradients are summed in a
    fixed order (no atomics), so they are the same from run to run."""
    if pos_feat.device.type == "cpu":
        return fused_ngp_mlp_bwd_plain(weights, pos_feat, dir_feat, g)
    if pos_feat.device.type != "cuda":
        raise ValueError(f"fused MLP takes CPU or CUDA tensors, got "
                         f"{pos_feat.device}")
    if len(weights) != 5:
        raise ValueError("fused MLP takes five weights")
    x, d, *ws, gg = _cuda_args(pos_feat, dir_feat, weights, g)
    from .cuda_lib import check, fused_mlp_lib

    lib = fused_mlp_lib()
    n, dev = x.shape[0], x.device
    dx = torch.empty((n, D_IN), dtype=torch.float32, device=dev)
    dw = torch.zeros((_N_GRAD,), dtype=torch.float32, device=dev)
    if n == 0:
        return _split_grads(dw), dx
    with torch.cuda.device(dev):
        n_blocks = lib.fused_mlp_bwd_blocks(n)
        partial = torch.empty((n_blocks, _N_GRAD), dtype=torch.float32,
                              device=dev)
        status = lib.fused_mlp_bwd(x.data_ptr(), d.data_ptr(),
                                   *(w.data_ptr() for w in ws),
                                   gg.data_ptr(), dx.data_ptr(),
                                   partial.data_ptr(), dw.data_ptr(), n,
                                   n_blocks, _stream(dev))
    check(status, "fused_mlp_bwd")
    fused_mlp_bwd.launches += 1
    return _split_grads(dw), dx


fused_mlp_bwd.launches = 0


def _split_grads(dw: torch.Tensor):
    out, off = [], 0
    for a, b in WEIGHT_SHAPES:
        out.append(dw[off:off + a * b].view(a, b))
        off += a * b
    return tuple(out)


def fused_density_mlp(w0, w1, pos_feat) -> torch.Tensor:
    """D-MLP: pos_feat [N, 32] -> raw sigma [N, 1] f32 (no gradient)."""
    if pos_feat.device.type == "cpu":
        return fused_density_mlp_plain(w0, w1, pos_feat)
    if pos_feat.device.type != "cuda":
        raise ValueError(f"fused MLP takes CPU or CUDA tensors, got "
                         f"{pos_feat.device}")
    x, w0c, w1c = _cuda_args(pos_feat, None, (w0, w1))
    from .cuda_lib import check, fused_mlp_lib

    lib = fused_mlp_lib()
    n, dev = x.shape[0], x.device
    out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        status = lib.fused_density_mlp_fwd(x.data_ptr(), w0c.data_ptr(),
                                           w1c.data_ptr(), out.data_ptr(), n,
                                           _stream(dev))
    check(status, "fused_density_mlp_fwd")
    fused_density_mlp.launches += 1
    return out


fused_density_mlp.launches = 0


class FusedNGPMLP(torch.autograd.Function):
    """F-MLP forward, B-MLP backward (the twins on CPU tensors);
    ``dir_feat`` gets no gradient."""

    @staticmethod
    def forward(ctx, pos_feat, dir_feat, *weights):
        ctx.save_for_backward(pos_feat, dir_feat, *weights)
        return fused_mlp_fwd(weights, pos_feat, dir_feat)

    @staticmethod
    def backward(ctx, g):
        pos_feat, dir_feat, *weights = ctx.saved_tensors
        dws, dx = fused_mlp_bwd(weights, pos_feat, dir_feat, g.contiguous())
        return (dx, None, *dws)


def fused_ngp_mlp(weights, pos_feat, dir_feat) -> torch.Tensor:
    """weights = (w0[32,64], w1[64,16], v0[32,64], v1[64,64], v2[64,3]);
    pos_feat [N,32], dir_feat [N,16] -> [N,4] f32 (rgb logits, raw sigma),
    differentiable in the weights and ``pos_feat``."""
    return FusedNGPMLP.apply(pos_feat, dir_feat, *weights)
