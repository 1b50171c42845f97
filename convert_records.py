#!/usr/bin/env python3
"""Convert self-play rows and loss histories between the port's record
files (`.rec`, `tetris_mcts_tpu_torch/utils/data.py`) and the JAX
package's HDF5 files (`.h5`, `tetris_mcts_tpu/utils/data.py`), both ways.

    python convert_records.py data/data0.rec out/data0.h5
    python convert_records.py data/data0.h5 data/loss0.h5 out/     # into a directory

The direction follows each source's extension; the schema (self-play rows,
`DataSaver`, or the loss history, `LossSaver`) follows its columns. The
HDF5 side is written as the JAX package's saver writes it: one resizable
dataset a column, chunks of 256 rows. Needs h5py (the card's machine has
none); no module of the package imports this script.
"""

from __future__ import annotations

import argparse
import os
import sys

import h5py
import numpy as np

from tetris_mcts_tpu_torch.utils.data import (LOSS_SCHEMA, MAGIC, STATE_SCHEMA,
                                              read_records, write_records)

SCHEMAS = {"state": STATE_SCHEMA, "loss": LOSS_SCHEMA}
CHUNK_ROWS = 256


def _rec_schema(path: str) -> str:
    for name, schema in SCHEMAS.items():
        try:
            read_records(path, schema)
            return name
        except ValueError:
            continue
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
    raise ValueError(f"{path}: not a record file of the self-play or the loss schema "
                     f"(header {head!r})")


def rec_to_h5(src: str, dst: str) -> int:
    schema = SCHEMAS[_rec_schema(src)]
    recs = read_records(src, schema)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    with h5py.File(dst, "w") as f:
        for name, (shape, dtype) in schema.items():
            f.create_dataset(name, data=np.asarray(recs[name], dtype).reshape((-1,) + shape),
                             maxshape=(None,) + shape, chunks=(CHUNK_ROWS,) + shape)
    return len(recs)


def h5_to_rec(src: str, dst: str) -> int:
    with h5py.File(src, "r") as f:
        keys = set(f.keys())
        found = [n for n, s in SCHEMAS.items() if set(s) == keys]
        if not found:
            raise ValueError(f"{src}: columns {sorted(keys)} are neither the self-play "
                             "nor the loss schema")
        schema = SCHEMAS[found[0]]
        cols = {k: np.asarray(f[k]) for k in schema}
    write_records(dst, schema, cols)
    return len(next(iter(cols.values())))


def convert(src: str, dst: str) -> int:
    """Convert one file; returns the rows written."""
    if src.endswith(".rec"):
        return rec_to_h5(src, dst)
    if src.endswith(".h5"):
        return h5_to_rec(src, dst)
    raise ValueError(f"{src}: want a .rec or an .h5 file")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+", help="SRC DST, or SRC... DIR")
    args = p.parse_args(argv)
    if len(args.paths) < 2:
        p.error("give a source and a destination")
    *srcs, dst = args.paths
    into_dir = len(srcs) > 1 or os.path.isdir(dst) or dst.endswith(os.sep)
    for src in srcs:
        out = dst
        if into_dir:
            stem = os.path.splitext(os.path.basename(src))[0]
            out = os.path.join(dst, stem + (".h5" if src.endswith(".rec") else ".rec"))
        n = convert(src, out)
        print(f"{src} -> {out}: {n} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
