"""A numpy-only reader of the JAX package's checkpoints.

A checkpoint of the reference package (`VVModel.save`, `VPModel.save`,
`DQNDriver.save`) is a stdlib pickle of a dict: `params` and `opt_state`
are flax state dicts serialised by `flax.serialization.to_bytes`
(msgpack); the VV model adds its output bounds `ubound` and `lbound` as
numpy arrays, the DQN driver its target net's `target_params` as flax
bytes. This module reads
such a file without flax or msgpack, so the card's machine, which has
neither, can load the trained nets:

- the outer pickle goes through an unpickler that builds numpy arrays and
  nothing else (any other global it names is refused);
- `msgpack_restore` decodes the msgpack subset flax writes: maps, arrays,
  strings, binary, ints, floats, nil and booleans, and flax's extension
  type 1, an ndarray, itself a packed (shape, dtype name, raw bytes)
  triple. Its other extension types (numpy scalars, complex numbers) and
  arrays chunked by flax (only those over 1 GiB) are refused: the models'
  checkpoints hold none.

The result is flax's state-dict form: nested dicts keyed by module and
field names (an optimizer state's tuples keyed "0", "1", ...), numpy leaves.
"""

from __future__ import annotations

import io
import pickle
import struct

import numpy as np

EXT_NDARRAY = 1  # flax's `_MsgpackExtType.ndarray`


class _Decoder:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixed = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        raise ValueError(f"msgpack: unsupported extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray extension: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = _Decoder(payload).value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        raise ValueError("flax checkpoint: bfloat16 arrays are not supported")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(data: bytes):
    """The state dict of flax msgpack bytes (`flax.serialization.to_bytes`),
    with numpy leaves."""
    dec = _Decoder(data)
    out = dec.value()
    if dec.pos != len(dec.data):
        raise ValueError("msgpack: trailing bytes after the state dict")
    _refuse_chunked(out)
    return out


def _refuse_chunked(d):
    if isinstance(d, dict):
        if "__msgpack_chunked_array__" in d:
            raise ValueError("flax checkpoint: chunked arrays (over 1 GiB) are not supported")
        for v in d.values():
            _refuse_chunked(v)


class _NumpyOnly(pickle.Unpickler):
    """Builds numpy arrays (and the plain containers pickle itself makes);
    refuses every other global."""

    _RECONSTRUCT = np.zeros(1).__reduce__()[0]  # this numpy's own _reconstruct

    def find_class(self, module, name):
        if module in ("numpy.core.multiarray", "numpy._core.multiarray") and (
                name == "_reconstruct"):
            return self._RECONSTRUCT
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        raise pickle.UnpicklingError(f"a JAX checkpoint holds no {module}.{name}")


def read_jax_checkpoint(path: str) -> dict:
    """The JAX package's checkpoint at `path` as a dict: `params` and
    `opt_state` state dicts (numpy leaves), `target_params` where the file
    has them (the DQN driver's), and `ubound` / `lbound` where the file has
    them (the VV model's)."""
    with open(path, "rb") as f:
        blob = _NumpyOnly(io.BytesIO(f.read())).load()
    if not isinstance(blob, dict) or "params" not in blob or "opt_state" not in blob:
        raise ValueError(f"{path}: not a checkpoint of the JAX package (no params / opt_state)")
    out = dict(blob)
    for k in ("params", "opt_state", "target_params"):
        if k in blob:
            out[k] = msgpack_restore(blob[k])
    return out
