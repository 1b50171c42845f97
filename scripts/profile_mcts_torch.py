"""Per-phase timing of the port's MCTS simulation, the counterpart of
`scripts/profile_mcts.py` (which times the JAX package's).

    python scripts/profile_mcts_torch.py [B [POOL]]            # on the card
    python scripts/profile_mcts_torch.py 4 256 --sims 4 --device cpu

At B=256 games, pools of POOL=8192 (table 2 x POOL), depth 64, 64 sims,
the lp evaluator and a bfloat16 body, after one pass of `make_run_sims`
has grown the trees, each phase is timed as SIMS repetitions, the best of
3 after a warm-up, between CUDA events on the card (the host clock on the
CPU):

- select(+replay fused): the select kernel (`ops/tree_walk.select_walk`,
  which steps each lane's env inline and the leaf's 7 children), with its
  planes' draw;
- nn_forward: the VV net on B x 7 boards;
- backup: the backup kernel (`ops/tree_walk.backup`) of one select's traces
  from v0 = 10, var0 = 1, SIMS times on a copy of the trees;
- full_sim: `make_run_sims` (SIMS simulations: select, insert, commit,
  net, LP backup) on a copy of the trees;
- expand+glue(residual): full_sim less the three above;
- expand:7xstep, expand:pack+insert, expand:render: the plain 7-child
  step of the B root envs (`search/tree.expand_children`), the insert
  kernel on those children (its writes to the obs table undone after each
  call, outside the timed span, so every call does the same work, as the
  JAX loop discards its tree), and the children's images for the net.

One JSON line a phase, {"phase", "total_s", "us_per_sim"}, after a line
{"batch", "sims", "device"} naming the card and its power limit, and a
{"sims_per_s"} line after the residual. This script imports nothing of JAX
or of the JAX package.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import bench_torch  # noqa: E402
from tetris_mcts_tpu_torch.env import engine  # noqa: E402
from tetris_mcts_tpu_torch.obs.card import device_label  # noqa: E402
from tetris_mcts_tpu_torch.ops import tree_walk  # noqa: E402
from tetris_mcts_tpu_torch.search import mcts  # noqa: E402
from tetris_mcts_tpu_torch.search import tree as T  # noqa: E402
from tetris_mcts_tpu_torch.search.tree import TreeConfig  # noqa: E402
from tetris_mcts_tpu_torch.train.trainer import VVModel  # noqa: E402


REPS = 3  # timed repetitions of a phase, after one warm-up


class Spans:
    """Timed spans: CUDA events on a card, read after one synchronisation
    at the end; the host clock on the CPU."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.pairs = []
        self.ms = 0.0

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs.append([e, None])
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs[-1][1] = e
        else:
            self.ms += (time.perf_counter() - self.t0) * 1e3

    def total_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.pairs)
        return self.ms


def timed(name, body, dev, sims, emit, calls=None, setup=tuple, undo=None):
    """Best of REPS (after a warm-up) of `calls` (default sims) calls of
    body(*setup()), in seconds; with `undo`, undo(*args) runs after each
    call, outside the timed spans."""
    calls = sims if calls is None else calls

    def rep():
        args = setup()
        bench_torch.sync(dev)
        spans = Spans(dev)
        if undo is None:
            spans.start()
            for _ in range(calls):
                body(*args)
            spans.stop()
        else:
            for _ in range(calls):
                spans.start()
                body(*args)
                spans.stop()
                undo(*args)
        return spans.total_ms() / 1e3

    rep()
    best = min(rep() for _ in range(REPS))
    emit({"phase": name, "total_s": round(best, 4), "us_per_sim": round(best / sims * 1e6, 1)})
    return best


def profile(B=256, pool=8192, sims=64, device="cuda", emit=None):
    """Time the phases at B games, pools of `pool`, `sims` sims; each
    phase's line goes to emit(dict) (default: printed as JSON). Returns
    {phase: seconds}."""
    emit = emit or (lambda d: print(json.dumps(d), flush=True))
    dev = torch.device(device)
    tcfg = TreeConfig(max_nodes=pool, max_obs=pool, table_size=2 * pool, max_depth=64)
    cfg = mcts.SearchConfig(tree=tcfg, sims=sims, evaluator="lp")
    apply_fn = VVModel(seed=0, device=dev).apply_fn(torch.bfloat16)
    planes = mcts.TorchPlanes(1, dev)
    run_sims = mcts.make_run_sims(mcts.nn_child_evaluator(apply_fn), cfg, planes)
    trees, envs = mcts.init_batch(0, B, cfg, dev)
    run_sims(trees)  # grow the trees first (depth > 1)
    bench_torch.sync(dev)
    emit({"batch": B, "sims": sims, "device": device_label(dev)})
    out = {}

    def phase(name, body, **kw):
        out[name] = timed(name, body, dev, sims, emit, **kw)
        return out[name]

    D = tcfg.max_depth
    t_sel = phase("select(+replay fused)",
                  lambda: tree_walk.select_walk(trees, *planes(B, D), tcfg))
    imgs0 = torch.zeros(B * 7, 1, 20, 10, device=dev)
    t_nn = phase("nn_forward", lambda: apply_fn(imgs0))
    traces, lengths = tree_walk.select_walk(trees, *planes(B, D), tcfg)[:2]
    v0 = torch.full((B,), 10.0, device=dev)
    var0 = torch.full((B,), 1.0, device=dev)
    fresh = lambda: (trees.clone(),)
    t_back = phase("backup", lambda tt: tree_walk.backup(tt, traces, lengths, v0, var0, tcfg),
                   setup=fresh)
    t_full = phase("full_sim", run_sims, calls=1, setup=fresh)
    resid = t_full - t_sel - t_nn - t_back
    out["expand+glue(residual)"] = resid
    emit({"phase": "expand+glue(residual)", "total_s": round(resid, 4),
          "us_per_sim": round(resid / sims * 1e6, 1)})
    emit({"sims_per_s": round(B * sims / t_full, 1)})

    # ---- expand sub-phases: the root envs' 7 children
    _, packed7, _, end7 = T.expand_children(envs, tcfg)
    phase("expand:7xstep", lambda: T.expand_children(envs, tcfg))
    ok = torch.ones(B, dtype=torch.bool, device=dev)

    def snapshot():
        tt = trees.clone()
        return tt, (tt.tbl_h1.clone(), tt.tbl_h2.clone(), tt.tbl_obs.clone(), tt.n_obs.clone())

    def undo(tt, saved):
        for a, b in zip((tt.tbl_h1, tt.tbl_h2, tt.tbl_obs, tt.n_obs), saved):
            a.copy_(b)

    phase("expand:pack+insert",
          lambda tt, saved: tree_walk.insert_obs7(tt, packed7, end7, ok, tcfg),
          setup=snapshot, undo=undo)
    phase("expand:render",
          lambda: engine.unpack_obs(packed7).reshape(B * 7, 1, 20, 10).float())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="python scripts/profile_mcts_torch.py")
    p.add_argument("batch", type=int, nargs="?", default=256)
    p.add_argument("pool", type=int, nargs="?", default=8192)
    p.add_argument("--sims", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card, its kernels) or cpu (the plain versions)")
    args = p.parse_args(argv)
    dev = bench_torch.device_arg(p, args.device)
    return profile(args.batch, args.pool, args.sims, dev)


if __name__ == "__main__":
    main()
