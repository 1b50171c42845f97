"""The TPU micro-benchmark's Welford walk: a CUDA kernel and its plain version.

Counterpart of `scripts/microbench_pallas_walk.py`, whose Pallas kernel
(`walk_kernel`, launched by `run_pallas`) this replaces:

| wrapper | plain version | replaces (scripts/microbench_pallas_walk.py) |
| --- | --- | --- |
| `bench_walk` | `bench_walk_plain` | `walk_kernel` / `run_pallas` |

Each of B lanes walks LEVELS levels: at level t it takes obs o = idxs[t, b]
of its column of the (M, B) statistics, runs one Welford update toward
`acc` (visit + 1, value + x / (visit + 1), var + x^2 / (visit + 1) with
x = acc - value), and scales acc by 0.999. The inputs are left as they are;
the updated statistics are returned. On a CUDA tensor the wrapper launches
`bench_walk_kernel` of `csrc/tree_walk.cu` (built by `ops/build.py`) and
counts the launch in `LAUNCHES`; on a CPU tensor it runs the plain version;
any other device raises. No path of the search calls it: like the script,
it exists to time a walk.

What bounds the kernel on the H100: bytes. The function reads the three
(M, B) statistics and writes them back whole (12 bytes an entry each way);
the walk itself is 16 dependent levels per lane. So the copy runs on every
SM: each block copies the rows it owns, 16 bytes a load where B is a
multiple of 4 and the arrays are 16-byte aligned. A level's update touches
only its own (row, lane) entry, so each block also walks, a thread a lane,
the levels whose rows it owns: the lane's 16 idxs in one round trip, their
input statistics in a second, the updates in registers (a level on a row
already walked takes that level's result), and after the block's copy of
those rows one store for each distinct row. The TPU kernel's one-hot masks
over all M rows become direct indexing. The kernel walks at most LEVELS
levels; the plain version takes any number.
"""

from __future__ import annotations

import torch

from tetris_mcts_tpu_torch.ops import build

LEVELS = 16   # the script's walk depth
DECAY = 0.999  # acc *= DECAY per level

# Kernel launches, counted where the kernel is launched.
LAUNCHES = {"bench_walk": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bench_walk_plain(idxs, visit, value, var):
    """Plain form of the kernel: idxs (L, B) int, statistics (M, B) float32
    -> updated copies (visit, value, var)."""
    visit, value, var = visit.clone(), value.clone(), var.clone()
    B = idxs.shape[1]
    b = torch.arange(B, device=idxs.device)
    acc = torch.ones(B, dtype=torch.float32, device=idxs.device)
    for t in range(idxs.shape[0]):
        o = idxs[t].long()
        vi, va, vr = visit[o, b], value[o, b], var[o, b]
        x = acc - va
        visit[o, b] = vi + 1.0
        value[o, b] = va + x / (vi + 1.0)
        var[o, b] = vr + x * x / (vi + 1.0)
        acc = acc * DECAY
    return visit, value, var


def bench_walk(idxs, visit, value, var):
    """The walk on idxs (L, B) int32 and statistics (M, B) float32: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = build.tensors_device("bench_walk", (idxs, visit, value, var))
    if dev.type == "cpu":
        return bench_walk_plain(idxs, visit, value, var)
    if dev.type != "cuda":
        raise ValueError(f"bench_walk runs on cuda or cpu tensors, not {dev}")
    L, B = idxs.shape
    M = visit.shape[0]
    if idxs.dtype != torch.int32 or not idxs.is_contiguous():
        raise ValueError(f"idxs: want contiguous int32 (L, B), got {idxs.dtype}")
    if L > LEVELS:
        raise ValueError(f"bench_walk kernel: at most {LEVELS} levels, got {L}")
    for name, x in (("visit", visit), ("value", value), ("var", var)):
        if x.dtype != torch.float32 or tuple(x.shape) != (M, B) or not x.is_contiguous():
            raise ValueError(f"{name}: want contiguous float32 {(M, B)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    out = [torch.empty_like(visit) for _ in range(3)]
    build.launch("tree_walk", "bench_walk", idxs, visit, value, var, *out, B, M, L)
    LAUNCHES["bench_walk"] += 1
    return tuple(out)
