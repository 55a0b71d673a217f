"""F=4 / L=8 against F=2 / L=16 through kernels F and B: the counterpart of
`tools/archive/probe_f4.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_f4 [F4L8 F2L16] [--cpu]

For each spec (F4L8: 8 levels x 4 features, hashed levels capped at
2^17 entries; F2L16: 16 x 2 capped at 2^18; both log2 19) a table
N(0, 0.01) and N = 2^18 uniform positions, drawn with numpy: the spec
line, then the forward (kernel F, `ops/hash_nbr.py::hash_encode_nbr`)
and the forward and backward of mean(out^2) in the table (kernels F and
B through autograd; B is ``grad_table``).  F4L8 alone by default, as the
archive.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
LOG2 = 19
SPECS = {"F4L8": (8, 4, 1 << 17), "F2L16": (16, 2, 1 << 18)}


def spec_of(tag: str):
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec

    levels, feats, cap = SPECS[tag]
    return HashGridSpec(n_levels=levels, n_features_per_level=feats,
                        log2_hashmap_size=LOG2, max_level_size=cap)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, tuple(SPECS), ("F4L8",))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.hash_nbr import hash_encode_nbr

    p = common.start(args.cpu, "probe_f4")

    def run(tag):
        spec = spec_of(tag)
        F = spec.n_features_per_level
        print(f"{tag}: {spec.n_entries} entries, sizes "
              f"{list(spec.level_sizes)}", flush=True)
        table = p.tensor(common.normal((spec.n_entries, F), 0.1))
        pos = p.tensor(common.uniform((N, 3), seed=1))
        leaf = table.clone().requires_grad_()

        def fwd():
            return hash_encode_nbr(spec, table, pos)

        def fwd_bwd():
            out = hash_encode_nbr(spec, leaf, pos)
            return torch.autograd.grad((out * out).mean(), leaf)[0]

        for name, fn, ran in ((f"{tag} fwd", fwd, "kernel F"),
                              (f"{tag} fwd+bwd", fwd_bwd,
                               "kernel F + kernel B (autograd)")):
            ms = p.time(fn)
            p.line(name, f"{name}: {ms:.2f} ms", ms, ran,
                   n_entries=spec.n_entries, level_sizes=spec.level_sizes)

    common.run_sections(args.sections, ("F4L8",),
                        {t: (lambda t=t: run(t)) for t in SPECS}, {}, p)
    return p.lines


if __name__ == "__main__":
    main()
