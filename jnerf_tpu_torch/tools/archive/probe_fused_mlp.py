"""The fused NGP MLP kernels against the plain chain: the counterpart of
`tools/archive/probe_fused_mlp.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_fused_mlp [jf ff jg fg fd] [--cpu]

N = 2^18 rows, the pos and dir features precomputed (U(-1, 1)), the five
weights N(0, 0.01) and the upstream gradient g N(0, 1), drawn with numpy:

  jf  the plain chain (`models/networks/mlp.py::apply_mlp` with bf16
      operands, as the archive's ``jnp_forward``), forward
  ff  F-MLP (`ops/fused_mlp.py::fused_ngp_mlp`), forward
  jg  the plain chain, forward and backward (torch autograd of <out, g>
      in the weights and the pos features)
  fg  F-MLP forward, B-MLP backward
  fd  D-MLP (`fused_density_mlp`)

Each fused line also gives its largest difference from the plain chain
(fd: from the chain's density column; fg: of each gradient, over that
gradient's largest entry) and whether it lies within the JAX package's
own tolerances for the same comparison (`tests/test_fused_mlp.py`:
forward rtol 1e-5 + atol 2e-3; gradients 0.03 of the largest entry, the
kernel rounding its cotangents to bf16 where autograd keeps f32).
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
SECTIONS = ("jf", "ff", "jg", "fg", "fd")
DEFAULT = ("jf", "ff", "jg", "fg")
FWD_RTOL, FWD_ATOL = 1e-5, 2e-3
GRAD_ATOL_OF_MAX = 0.03
LABELS = {"jf": "jnp fwd      ", "ff": "fused fwd    ", "jg": "jnp fwd+bwd  ",
          "fg": "fused fwd+bwd", "fd": "fused density"}


def inputs(seed: int = 0):
    """numpy (weights (w0, w1, v0, v1, v2), x [N, 32], d [N, 16],
    g [N, 4])."""
    from jnerf_tpu_torch.ops import fused_mlp as fm

    weights = tuple(common.normal(s, 0.1, seed=seed + i)
                    for i, s in enumerate(fm.WEIGHT_SHAPES))
    x = common.uniform((N, fm.D_IN), -1.0, 1.0, seed=seed + 5)
    d = common.uniform((N, fm.SH_DIM), -1.0, 1.0, seed=seed + 6)
    g = common.normal((N, 4), seed=seed + 7)
    return weights, x, d, g


def plain_forward(w, x, d):
    """The archive's ``jnp_forward``: density chain, then the rgb chain on
    [bf16(density), bf16(d)], out [rgb, raw sigma] f32."""
    from jnerf_tpu_torch.models.networks.mlp import apply_mlp

    bf16 = torch.bfloat16
    dens = apply_mlp(w[:2], x, bf16)
    h = torch.cat([dens.to(bf16), d.to(bf16)], dim=-1)
    rgb = apply_mlp(w[2:], h, bf16)
    return torch.cat([rgb, dens[..., :1]], dim=-1).float()


def _fwd_ok(got, want) -> bool:
    return bool(((got - want).abs() <= FWD_ATOL + FWD_RTOL * want.abs())
                .all())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, DEFAULT)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops import fused_mlp as fm

    p = common.start(args.cpu, "probe_fused_mlp")
    w_np, x_np, d_np, g_np = inputs()
    w = tuple(p.tensor(a).requires_grad_() for a in w_np)
    x, d, g = (p.tensor(a) for a in (x_np, d_np, g_np))
    xg = x.clone().requires_grad_()

    def grads(fwd):
        out = fwd(w, xg, d)
        return torch.autograd.grad((out * g).sum(), w + (xg,))

    def fwd_plain():
        with torch.no_grad():
            return plain_forward(w, x, d)

    def fwd_fused():
        with torch.no_grad():
            return fm.fused_ngp_mlp(w, x, d)

    def density():
        return fm.fused_density_mlp(w[0].detach(), w[1].detach(), x)

    def line(key, fn, ran, check=None):
        ms = p.time(fn)
        extra, tail = {}, ""
        if check is not None:
            err, ok = check(fn())
            extra = dict(max_diff=err, ok=ok)
            tail = f"; max |diff| from the plain chain {err:.3e}, " \
                   f"within the JAX tests' tolerance: {ok}"
        p.line(key, f"{LABELS[key]}: {ms:.2f} ms", ms, ran + tail, **extra)

    ref_out, ref_grads = fwd_plain(), grads(plain_forward)

    def check_fwd(out):
        want = ref_out[:, 3:] if out.shape[1] == 1 else ref_out
        return float((out - want).abs().max()), _fwd_ok(out, want)

    def check_grads(got):
        rel = [float((a - b).abs().max() / (b.abs().max() + 1e-8))
               for a, b in zip(got, ref_grads)]
        return max(rel), max(rel) <= GRAD_ATOL_OF_MAX

    sections = {
        "jf": lambda: line("jf", fwd_plain, "plain chain: apply_mlp, bf16 "
                           "operands, f32 sums (torch matmuls)"),
        "ff": lambda: line("ff", fwd_fused, "F-MLP", check_fwd),
        "jg": lambda: line("jg", lambda: grads(plain_forward),
                           "plain chain forward + torch autograd"),
        "fg": lambda: line("fg", lambda: grads(fm.fused_ngp_mlp),
                           "F-MLP + B-MLP", check_grads),
        "fd": lambda: line("fd", density, "D-MLP", check_fwd),
    }
    common.run_sections(args.sections, DEFAULT, sections, {}, p)
    return p.lines


if __name__ == "__main__":
    main()
