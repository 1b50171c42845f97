"""Build and load the port's CUDA kernels (`csrc/`) at first use.

Each library is one `nvcc` call that compiles its source into a shared
library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`),
loaded with `ctypes`:

| library | source | kernels |
| --- | --- | --- |
| `tree_walk` | `csrc/tree_walk.cu` (+ `env_packed.cuh`) | select, insert7, LP backup, backup, the micro-benchmark walk |
| `vv_forward` | `csrc/vv_forward.cu` | the fused packed-board VV forward (conv ladder, FC) |

A library goes to `tetris_mcts_tpu_torch/build/` (listed in .gitignore)
under a name that carries a hash of its sources and flags, so an edited
source is rebuilt and concurrent processes never load a half-written file.
`build_all()` starts every library's `nvcc` at once. Nothing is built or
loaded at import time. `launch()` calls a library's C entry on the stream
of its tensors' device, with that device current, whatever device the
caller has current.

The walk kernels are built with `--fmad=false`: every float multiply and
add stays a separate IEEE operation, as PyTorch's elementwise kernels
compute them, so the kernels and their plain versions round alike (their
contract is bit-exactness). The forward is built without it: its contract
is a tolerance (rtol 1e-4), and contracted multiply-adds halve its
instruction count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Library(NamedTuple):
    source: str
    includes: tuple
    flags: tuple
    # C signatures; every function returns a cudaError_t (0 = launched).
    signatures: dict


LIBRARIES = {
    "tree_walk": Library(
        "tree_walk.cu", ("env_packed.cuh",), _BASE_FLAGS + ("--fmad=false",), {
            "select_walk": [_P] * 16 + [_I] * 9 + [_P],
            "insert7_walk": [_P] * 10 + [_I] * 4 + [_P],
            "lp_backup_walk": [_P] * 11 + [_I] * 4 + [_F, _P],
            "backup_walk": [_P] * 8 + [_I] * 4 + [_F, _P],
            "bench_walk": [_P] * 7 + [_I] * 3 + [_P],
        }),
    "vv_forward": Library(
        "vv_forward.cu", (), _BASE_FLAGS, {
            "vv_forward": [_P] * 15 + [_I, _P],
        }),
}

_libs = {}
build_seconds = {}  # library -> nvcc wall seconds (0.0 when already built)
ptxas_log = {}      # library -> nvcc's output (-Xptxas -v: registers, smem)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    spec = LIBRARIES[name]
    h = hashlib.sha1()
    for src in (spec.source, *spec.includes):
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(spec.flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=tuple(LIBRARIES)) -> dict:
    """Compile every library of `names` not built yet, all nvcc calls
    running at once. Returns {name: path}; raises if any build fails."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    for n in names:
        if n not in todo:
            build_seconds.setdefault(n, 0.0)
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        spec = LIBRARIES[n]
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *spec.flags, "-o", str(tmp), str(CSRC / spec.source)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += "\nnvcc timed out after 600 s"
        build_seconds[n] = time.perf_counter() - t0
        ptxas_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def lib(name: str = "tree_walk"):
    """The loaded kernel library `name` (built on first call)."""
    if name not in _libs:
        handle = ctypes.CDLL(str(build_all((name,))[name]))
        for fn_name, argtypes in LIBRARIES[name].signatures.items():
            fn = getattr(handle, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = handle
    return _libs[name]


def tensors_device(name: str, tensors) -> torch.device:
    """The one device all `tensors` lie on; raises if they span several."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs lie on several devices "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def launch(name: str, fn_name: str, *args):
    """Call the C entry `fn_name` of library `name` with `args` (tensors as
    their data pointers, ints and floats as they are) and the stream of the
    tensors' device, with that device current. Raises if the tensors lie on
    several devices or the launch failed."""
    dev = tensors_device(fn_name, [a for a in args if isinstance(a, torch.Tensor)])
    fn = getattr(lib(name), fn_name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
