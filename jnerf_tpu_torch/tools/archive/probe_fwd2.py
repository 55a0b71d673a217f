"""The linear hash forward stage by stage: the counterpart of
`tools/archive/probe_fwd2.py`.

    python3 -m jnerf_tpu_torch.tools.archive.probe_fwd2 [idx take blend asm] [--cpu]

16 levels x 2 features, log2 19, hashed levels capped at 2^18 entries, a
table N(0, 0.01) and N = 2^18 uniform positions (numpy).  Each stage adds
one to the last, as the archive's:

  idx    each level's base entry and fractions (`ops/hash_nbr.py::_cell`)
  take   no counterpart: the split gather of the neighbourhood table
         (``_take_split``)
  blend  the corners gathered from the bf16 master table, weighted,
         rounded to bf16 and summed: the plain twin of kernel F
         (``hash_encode_plain``, PyTorch calls)
  asm    no counterpart: the assembly matmul (``_assembly_matrix``)
"""

from __future__ import annotations

import argparse

from jnerf_tpu_torch.tools.archive import common

N = 1 << 18
LEVELS, LOG2, CAP = 16, 19, 1 << 18
SECTIONS = ("idx", "take", "blend", "asm")
MISSING = {
    "take": ("jnerf_tpu.ops.hash_nbr._take_split",
             "a gather split for the TPU's table-size knee"),
    "asm": ("jnerf_tpu.ops.hash_nbr._assembly_matrix",
            "an MXU matmul that lays out the neighbourhood lanes"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.section_arg(ap, SECTIONS, SECTIONS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from jnerf_tpu_torch.ops.hash_grid import HashGridSpec
    from jnerf_tpu_torch.ops.hash_nbr import (
        _cell, hash_encode_plain, level_consts,
    )

    p = common.start(args.cpu, "probe_fwd2")
    spec = HashGridSpec(n_levels=LEVELS, log2_hashmap_size=LOG2,
                        max_level_size=CAP)
    consts = level_consts(spec)
    table = p.tensor(common.normal((spec.n_entries, 2), 0.1))
    pos = p.tensor(common.uniform((N, 3), seed=1))

    def line(name, fn, ran):
        ms = p.time(fn)
        p.line(name, f"{name}: {ms:.2f} ms", ms, ran)

    sections = {
        "idx": lambda: line("idx", lambda: [
            _cell(consts, lvl, pos) for lvl in range(spec.n_levels)],
            "_cell a level (PyTorch calls)"),
        "blend": lambda: line("blend", lambda: hash_encode_plain(
            spec, table, pos), "hash_encode_plain: kernel F's plain twin "
            "(PyTorch calls)"),
    }
    common.run_sections(args.sections, SECTIONS, sections, MISSING, p)
    return p.lines


if __name__ == "__main__":
    main()
