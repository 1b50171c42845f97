"""Self-play rows and training-loss history on disk (counterpart of the
reference package's `utils/data.py`), in a format numpy alone writes and
reads: no h5py, no pickle.

The schemas are the reference's, field by field (name, shape, dtype):
`STATE_SCHEMA` is one row a game a move, `LOSS_SCHEMA` one row a
validation window. A file (`data{cycle}.rec`, `loss{cycle}.rec`) is a
header, then packed little-endian records of one numpy structured dtype
built from the schema in schema order:

    b"TMTREC1\\n"  uint32 n  n bytes of JSON {"schema": [[name, dtype, shape], ...]}
    record record record ...

The savers append and flush on every batch, as the reference's HDF5
appender does, so a reader sees every finished batch of a running saver.
The loaders read with `np.fromfile`; a trailing partial record (a crash
mid-write) is dropped with a message, and a file whose header does not
hold this schema is refused (an HDF5 file of the JAX package is named as
such: it is converted where h5py is installed).

`DataLoader` concatenates every column over its files and offsets each
file's episode ids, so ids stay unique across files (MC targets and the
episodic split key on them).
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys
from typing import Iterable, Mapping

import numpy as np

STATE_SCHEMA = {
    "episode": ((), np.int32),
    "board": ((20, 10), np.int8),
    "policy": ((7,), np.float32),
    "action": ((), np.int32),
    "combo": ((), np.int32),
    "lines": ((), np.int32),
    "line_stats": ((4,), np.int32),
    "score": ((), np.int64),
    "child_stats": ((3, 7), np.float32),
    "cycle": ((), np.int32),
    "value": ((), np.float32),
    "variance": ((), np.float32),
}

LOSS_SCHEMA = {
    "cycle": ((), np.int32),
    "iteration": ((), np.int64),
    "loss_train": ((), np.float32),
    "loss_val": ((), np.float32),
    "loss_val_std": ((), np.float32),
    "grad_norm": ((), np.float32),
}

MAGIC = b"TMTREC1\n"
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def record_dtype(schema: Mapping) -> np.dtype:
    """The packed little-endian structured dtype of one row of `schema`."""
    return np.dtype([(name, np.dtype(dt).newbyteorder("<"), shape)
                     for name, (shape, dt) in schema.items()])


def _header(schema: Mapping) -> bytes:
    desc = [[name, np.dtype(dt).newbyteorder("<").str, list(shape)]
            for name, (shape, dt) in schema.items()]
    body = json.dumps({"schema": desc}).encode()
    return MAGIC + struct.pack("<I", len(body)) + body


def read_records(path: str, schema: Mapping) -> np.ndarray:
    """Every whole record of the file at `path` (a structured array)."""
    want = _header(schema)
    with open(path, "rb") as f:
        head = f.read(len(want))
    if head.startswith(_HDF5_MAGIC):
        raise ValueError(
            f"{path} is an HDF5 file of the JAX package (tetris_mcts_tpu/utils/data.py, "
            "h5py); the port reads its own .rec records. Convert it where h5py is "
            "installed: read its columns and write them with this module's savers")
    if head != want:
        raise ValueError(f"{path} is not a record file of this schema (want the header "
                         f"{want[:8]!r} + {json.loads(want[12:])}); an HDF5 file of the JAX "
                         "package is converted where h5py is installed")
    dt = record_dtype(schema)
    body = os.path.getsize(path) - len(want)
    n, rest = divmod(body, dt.itemsize)
    if rest:
        print(f"{path}: dropping a trailing partial record ({rest} of {dt.itemsize} bytes; "
              "the writer stopped mid-record)", file=sys.stderr, flush=True)
    return np.fromfile(path, dtype=dt, count=n, offset=len(want))


class _RecAppender:
    """Appends rows of `schema` to a new file at `path` (truncated on open),
    flushing after every append."""

    def __init__(self, path: str, schema: Mapping):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._schema = dict(schema)
        self._dtype = record_dtype(schema)
        self._f = open(path, "wb")
        self._f.write(_header(schema))
        self._f.flush()
        self._n = 0

    def append(self, rows: Mapping[str, np.ndarray]):
        """rows: column name -> (n, ...) arrays of one leading length."""
        lengths = {k: len(np.asarray(v)) for k, v in rows.items()}
        n = next(iter(lengths.values()))
        if any(v != n for v in lengths.values()):
            raise ValueError(f"columns of unequal lengths: {lengths}")
        rec = np.empty(n, self._dtype)
        for name, (shape, dt) in self._schema.items():
            rec[name] = np.asarray(rows[name], dtype=dt).reshape((n,) + shape)
        self._f.write(rec.tobytes())
        self._f.flush()
        self._n += n

    def close(self):
        self._f.close()

    def __len__(self):
        return self._n


def write_records(path: str, schema: Mapping, cols: Mapping[str, np.ndarray]):
    """A new record file at `path` holding the rows of `cols` (column name
    -> (n, ...) arrays of `schema`)."""
    w = _RecAppender(path, schema)
    try:
        w.append(cols)
    finally:
        w.close()


class DataSaver:
    """Per-move self-play rows, one a game, to `{save_dir}/{filename}{cycle}.rec`."""

    def __init__(self, save_dir: str, filename: str = "data", cycle: int = 0):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{filename}{cycle}.rec")
        self.cycle = cycle
        self._w = _RecAppender(self.path, STATE_SCHEMA)

    def add_batch(self, episode, board, policy, action, combo, lines,
                  line_stats, score, child_stats, value, variance):
        """Append B rows (one a game in flight) of one batched move."""
        b = np.asarray(board)
        n = b.shape[0]
        self._w.append(dict(
            episode=episode, board=b, policy=policy, action=action,
            combo=combo, lines=lines, line_stats=line_stats, score=score,
            child_stats=child_stats, cycle=np.full(n, self.cycle, np.int32),
            value=value, variance=variance,
        ))

    def close(self):
        self._w.close()

    def __len__(self):
        return len(self._w)


def _paths(paths: Iterable[str] | str, what: str) -> list:
    if isinstance(paths, str):
        paths = sorted(glob.glob(paths))
    paths = list(paths)
    if not paths:
        raise FileNotFoundError(f"no {what} files")
    return paths


class DataLoader:
    """Every column of `STATE_SCHEMA` over the files (a glob or a list),
    concatenated in file order, as attributes: loader.board, loader.value,
    ... Each file's episode ids are offset past the previous files'."""

    def __init__(self, paths: Iterable[str] | str):
        recs = [read_records(p, STATE_SCHEMA) for p in _paths(paths, "data")]
        # episode ids restart at 0 in every file: two files' "episode 5" are
        # different games
        episodes, base = [], 0
        for r in recs:
            ep = r["episode"].copy()
            ep += base
            if len(ep):
                base = int(ep.max()) + 1
            episodes.append(ep)
        for k in STATE_SCHEMA:
            setattr(self, k, np.concatenate(
                episodes if k == "episode" else [r[k] for r in recs], axis=0))
        self.n = len(self.episode)

    def __len__(self):
        return self.n


class LossSaver:
    """Training-loss history, one row a validation window, to
    `{save_dir}/{filename}{cycle}.rec`."""

    def __init__(self, save_dir: str, filename: str = "loss", cycle: int = 0):
        os.makedirs(save_dir, exist_ok=True)
        self.cycle = cycle
        self.path = os.path.join(save_dir, f"{filename}{cycle}.rec")
        self._w = _RecAppender(self.path, LOSS_SCHEMA)

    def add(self, iteration, loss_train, loss_val, loss_val_std, grad_norm=0.0):
        self._w.append(dict(
            cycle=[self.cycle], iteration=[iteration], loss_train=[loss_train],
            loss_val=[loss_val], loss_val_std=[loss_val_std], grad_norm=[grad_norm],
        ))

    def add_history(self, history):
        """Append a `train_data` history of (iteration, train loss, val
        loss, val std[, grad norm]) rows."""
        for row in history:
            self.add(row[0], row[1], row[2], row[3],
                     grad_norm=row[4] if len(row) > 4 else 0.0)

    def close(self):
        self._w.close()


class LossLoader:
    """Every column of `LOSS_SCHEMA` over the files, concatenated."""

    def __init__(self, paths: Iterable[str] | str):
        recs = [read_records(p, LOSS_SCHEMA) for p in _paths(paths, "loss")]
        for k in LOSS_SCHEMA:
            setattr(self, k, np.concatenate([r[k] for r in recs], axis=0))
        self.n = len(self.cycle)
