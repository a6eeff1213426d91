"""Table-compiler CLI: the Python twin of cpp/tools/huffgen.

Offline equivalent of the reference generator
(reference: source/huffman_generator/generator.c:216-352) in the
tables-as-data design: parse a ``.def`` (or TSV) table, validate it
(prefix-free, Kraft), and emit data artifacts instead of C source:

  python -m tpu_huffman.huffgen table.def --tsv out.tsv    # portable TSV
  python -m tpu_huffman.huffgen table.def --npz out.npz    # compiled LUTs
  python -m tpu_huffman.huffgen table.def --check          # validate only

Artifacts are consumable by both the JAX kernels (HuffmanTable.load /
from_tsv_file) and the C++ host library (parse_tsv).
"""

from __future__ import annotations

import argparse
import os
import sys

from .tables import HuffmanTable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_huffman.huffgen",
        description="Compile a Huffman .def/.tsv table into data artifacts.",
    )
    ap.add_argument("input", help="table definition (.def or .tsv)")
    ap.add_argument("--tsv", metavar="OUT", help="emit portable TSV artifact")
    ap.add_argument("--npz", metavar="OUT", help="emit compiled .npz artifact (LUTs included)")
    ap.add_argument("--check", action="store_true", help="validate only")
    ap.add_argument("--name", default=None, help="table name (default: input stem)")
    args = ap.parse_args(argv)

    loader = (
        HuffmanTable.from_tsv_file
        if args.input.endswith(".tsv")
        else HuffmanTable.from_def_file
    )
    try:
        table = loader(args.input, name=args.name)
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    n_codes = int((table.lengths > 0).sum())
    if args.check or not (args.tsv or args.npz):
        print(
            f"ok: {n_codes} codes, lengths {table.min_len}..{table.max_len}, "
            f"root_bits={table.root_bits}"
        )
    if args.tsv:
        with open(args.tsv, "w") as f:
            f.write(table.to_tsv())
    if args.npz:
        out = args.npz[:-4] if args.npz.endswith(".npz") else args.npz
        table.save(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
