"""The table backward at the reference's capacity: the port's counterpart
of `tools/probe_cap19.py`.

    python3 -m jnerf_tpu_torch.tools.probe_cap19 [--cpu]

At 2^19-entry hashed levels (the reference's table size) and 2^16
uniform samples, for the f8l4 and f4l8 geometries, and at the two other
tables the bench trains (f8l4 at 2^16 and f4l8 at 2^17 entries, the
hash encoder's default caps; f2l16 at 2^18 is `chip_smoke.py` phase 3's
and phase 18's), it holds kernel F to
its plain twin (max abs difference of the f32 outputs) and kernel B to
the exact adjoint: the float64 sum of the same f32 contributions, each
corner's entry and weight from the twin's own arithmetic, as
`chip_smoke.py` does (``rel_err``: the largest difference over the
largest entry; ``twin_rel_err``: the f32 twin's).  Then it times kernel F
(bf16 output, the path's), kernel B and a forward and backward through
``hash_encode_nbr``'s autograd, each beside its plain twin: CUDA-event
means of 10 reps after one warm-up call.  One JSON line a geometry, with
the card's name and power limit.  Runs on the card; without one it
raises unless given ``--cpu`` (where the wrappers run their twins).
"""

from __future__ import annotations

import argparse
import json

import torch

# (levels, features, hashed-level cap): f8l4 and f4l8 at the reference's
# 2^19, then at the bench's default caps.
GEOMETRIES = ((4, 8, 1 << 19), (8, 4, 1 << 19), (4, 8, 1 << 16),
              (8, 4, 1 << 17))


def exact_grad_table(hash_nbr, spec, pos, g):
    """The table gradient [n_entries, F] as the float64 sum of the f32
    contributions ``w_c * g`` (each product exact in f64)."""
    consts = hash_nbr.level_consts(spec)
    L, F = spec.n_levels, spec.n_features_per_level
    g3 = g.double().reshape(pos.shape[0], F, L)
    ref = torch.zeros((spec.n_entries, F), dtype=torch.float64,
                      device=pos.device)
    for lvl in range(L):
        e0, X = hash_nbr._cell(consts, lvl, pos)
        for c in range(8):
            w = hash_nbr._corner_weight(X, c).double()
            ref.index_add_(0, hash_nbr._corner_entry(consts, lvl, e0, c),
                           w[:, None] * g3[:, :, lvl])
    return ref


def run(levels, feats, device, n=1 << 16, cap=1 << 19, reps=10):
    """Check and time one geometry; returns its JSON dict."""
    from jnerf_tpu_torch.ops import hash_nbr
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.tools.tool_util import timed

    spec = HashGridSpec(n_levels=levels, n_features_per_level=feats,
                        base_resolution=16, log2_hashmap_size=19,
                        max_level_size=cap)
    gen = torch.Generator(device).manual_seed(0)
    t = torch.randn((spec.n_entries, feats), generator=gen,
                    device=device) * 0.1
    p = torch.rand((n, 3), generator=gen, device=device)
    g = torch.randn((n, feats * levels), generator=gen, device=device)

    fwd_err = float((hash_nbr.encode_fwd(spec, t, p)
                     - hash_nbr.hash_encode_plain(spec, t, p)).abs().max())
    ref = exact_grad_table(hash_nbr, spec, p, g)
    ref_max = float(ref.abs().max())
    rel_err = float((hash_nbr.grad_table(spec, p, g).double() - ref)
                    .abs().max()) / ref_max
    twin_rel_err = float((hash_nbr.grad_table_plain(spec, p, g).double() - ref)
                         .abs().max()) / ref_max
    del ref

    tv = t.clone().requires_grad_(True)

    def fwd_bwd():
        out = hash_nbr.hash_encode_nbr(spec, tv, p,
                                       compute_dtype=torch.bfloat16)
        (out.float() ** 2).sum().backward()
        tv.grad = None

    def ms(fn):
        fn()
        return timed(fn, reps, device)

    bf16 = torch.bfloat16
    times = {
        "fwd_bwd": ms(fwd_bwd),
        "fwd": ms(lambda: hash_nbr.encode_fwd(spec, t, p, out_dtype=bf16)),
        "bwd": ms(lambda: hash_nbr.grad_table(spec, p, g)),
        "plain_fwd": ms(lambda: hash_nbr.hash_encode_plain(spec, t, p)
                        .to(bf16)),
        "plain_bwd": ms(lambda: hash_nbr.grad_table_plain(spec, p, g)),
    }
    # The card's clock where there is one, else the host's.
    line = {"geom": f"f{feats}l{levels}", "cap": cap, "n": n, "L": levels,
            "n_entries": spec.n_entries, "fwd_err": fwd_err,
            "rel_err": rel_err, "twin_rel_err": twin_rel_err}
    line.update({f"{k}_ms": round(dev if dev is not None else host, 4)
                 for k, (host, dev) in times.items()})
    line["clock"] = "cuda events" if device.type == "cuda" else "host"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.tools.tool_util import card, device_for

    device = device_for(args.cpu, "probe_cap19")
    on = card(device)
    out = []
    for levels, feats, cap in GEOMETRIES:
        line = dict(run(levels, feats, device, cap=cap), card=on)
        out.append(line)
        print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
