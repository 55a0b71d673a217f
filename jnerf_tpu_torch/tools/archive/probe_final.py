"""The hash-path design decision's microbenches: the counterpart of
`tools/archive/probe_final.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_final [1 2 3 4 5] [--cpu]

Sections, as in the archive (none runs unless named):
1, 2. the XLA scatter of 4M rows into [1M, 128] bf16 / f32 (2 GiB of f32
   values), as ``index_add_``: library yardsticks;
3. the Pallas read-modify-write scatter (``sec_pallas_scatter.k_fn``,
   ``pallas_call`` at ``:77``) of 1M rows into [16384, 128] f32: K3
   (`ops/envelope.py::row_scatter_add`);
4, 5. the XLA packed forward blend over a [2^19, 128] bf16 table at 4M
   samples, reshape and mask variants, as PyTorch calls: library
   yardsticks.
"""

from __future__ import annotations

import argparse

import torch

from jnerf_tpu_torch.tools.archive import common, probe_scatter2

N = 1 << 22
TBIG = 1 << 20
NL, TL = 1 << 20, 1 << 14
T19 = 1 << 19


def _line(p, name, ms, items, nbytes, ran):
    return p.emit(name, f"{name}: {ms:.3f} ms -> {ms * 1e6 / items:.2f} "
                  "ns/item", ms, items, nbytes, ran)


def sec_xla_scatter(p, dtype, label):
    idx = p.tensor(common.uniform_idx(N, TBIG))
    vals = torch.ones((N, 128), dtype=dtype, device=p.device)
    ms = p.time(lambda: torch.zeros((TBIG, 128), dtype=dtype, device=p.device)
                .index_add_(0, idx, vals))
    _line(p, f"XLA scatter {label} [4M]->[1M,128]", ms, N,
          common.scatter_bytes(N, 128 * vals.element_size(), TBIG),
          "library: index_add_")


def sec_pallas_scatter(p):
    from jnerf_tpu_torch.ops.envelope import row_scatter_add

    idxl = p.tensor(common.uniform_idx(NL, TL))
    vl = torch.ones((NL, 128), device=p.device)
    ms = p.time(lambda: row_scatter_add(idxl, vl, TL))
    _line(p, "pallas RMW scatter [1M]->[16K,128]", ms, NL,
          common.scatter_bytes(NL, 512, TL), "K3")


def sec_fwd(p, variant):
    tbl, rows, b, w = probe_scatter2.blend_inputs(p, T19, N)
    read = common.distinct(rows)
    nbytes = common.gather_bytes(N, 256, read, out_row_bytes=4,
                                 w_row_bytes=4 + 32)
    if variant == "reshape":
        ms = p.time(lambda: probe_scatter2.fwd_reshape(tbl, rows, b, w)[:, 0])
        _line(p, "XLA fused fwd (reshape blend)", ms, N, nbytes,
              "library: index_select + reshape blend")
    else:
        ms = p.time(lambda: probe_scatter2.fwd_mask(tbl, rows, b, w,
                                                    both=False))
        _line(p, "XLA fused fwd (mask blend)", ms, N, nbytes,
              "library: index_select + masked blend")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*", choices=list("12345"),
                    metavar="section")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    p = common.start(args.cpu, "probe_final")
    a = args.sections
    if "1" in a:
        sec_xla_scatter(p, torch.bfloat16, "bf16")
    if "2" in a:
        sec_xla_scatter(p, torch.float32, "f32")
    if "3" in a:
        sec_pallas_scatter(p)
    if "4" in a:
        sec_fwd(p, "reshape")
    if "5" in a:
        sec_fwd(p, "mask")
    return p.lines


if __name__ == "__main__":
    main()
