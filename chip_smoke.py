#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port (`tetris_mcts_tpu_torch`) only; it imports nothing of JAX or
of the JAX package. Phases, each printing its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernels, one nvcc call per library, all started together
   (ops/build.py: the walk kernels with --fmad=false, the forward without);
3. small: 3-move searches at a small size with stub evaluators and fixed
   random planes (and fixed playout draws), on the card (kernels) and on
   the CPU (plain versions), for the lp, leaf and rollout evaluators:
   actions, traces, obs ids and visits must match exactly, values within
   rtol 1e-6 / atol 1e-5; and the VV net's float32 forward on the card
   against the CPU (rtol 1e-4; atol 1e-3 value, 1e-2 variance);
4. main (lp): frozen-net ValueSimLP self-play through `SelfPlayDriver` at
   the CLI's default width (B=64, sims 100, pools 4096/4096, table 8192,
   depth 96, VV net 32 filters / fc 256 with weights made from the seed)
   for 20 moves; select, insert and LP backup must each launch moves x
   sims times, the backup walk never;
5. profile (lp): two moves under torch.profiler, device time by kernel;
6. leaf: ValueSim self-play at the same width for 20 moves; select,
   insert and the backup walk must each launch moves x sims times, the LP
   backup never; then two profiled moves;
7. rollout: Vanilla self-play (low 5, rollout_cap 512) at B=64 with 4 sims
   for 2 moves; the backup walk must launch moves x sims times;
8. forward: the fused packed-board forward's own entry
   (`vv_forward_packed`, two launches counted as one call) on the search's
   boards: the 448 child boards of one lp simulation and the 64 leaf boards
   of one leaf simulation; then the TPU micro-benchmark walk's entry
   (`bench_walk`) at the script's B=256, M=2048;
9. kernels: on the trees those paths grew, each kernel against its plain
   version (integers exact; values/vars within rtol 1e-6 / atol 1e-5; the
   select kernel under every selection rule it accepts, on the lp and the
   leaf trees; the forward within rtol 1e-4, atol 1e-3 / 1e-2 against its
   plain version and `VVNet`, also on 1792 boards; the bench walk and the
   backup exact; insert and both backups also on the edge inputs of
   tests/torch_walk_cases.py: D=96 traces with repeated obs within and
   across the backups' chunks of 32 levels, a 16-slot table with
   contending keys, a wrapping probe and an id pool that runs out; the
   bench walk also at B = 1 and 67 and at M = 4, where lanes revisit rows),
   with the kernel's device time a launch (torch.profiler; for the forward
   both of its kernels), the time of a call through its wrapper and of its
   plain version (CUDA events), a bound, and for the forward the device
   time of the `VVNet` forward;
10. online: ValueSimLP self-play with training at the same width (the CLI's
   online defaults: min_visits 25, memory 100000, growth 5000, a session
   every 5000 new rows, minibatch 128, a validation every 100 steps; cut:
   at most 2000 steps a session) until a session has run and 5 moves more
   (at most 80 moves): select, insert and LP backup must launch moves x
   sims times, and sims times a move after the session; the net's outputs
   on fixed boards must change; then one train step on the card against
   the same step on the CPU (TF32 switched on around it, so the step must
   pin it off), the device time and launches of a train step and of a
   move's harvest and store, and a save/load round trip.

Each path's launch counts are set to 0 just before it runs and read just
after. It then prints a JSON `kernels` line, the card's name and power
limit, and, last, {"ok": true, "device": {...}}. Any failure exits non-zero
without the last line; a watchdog ends a hang with a traceback.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

WATCHDOG_S = 600
ONLINE_MAX_ITERS = 2000  # the online phase's cut of train_max_iters (CLI: 50000)
ONLINE_MOVE_CAP = 80
PROFILER_SESSIONS = 3  # device_ms's tries; each kernel row reports how many it took
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
FP32_FLOPS = 67e12         # H100 SXM published float32 rate outside the tensor cores
MOVES = 20
T0 = time.perf_counter()


def say(msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def nvidia_smi():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """One entry per kernel of nvcc's -Xptxas -v output: its name, stack
    frame, spills, registers and shared memory."""
    import re

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for _ZN\d+\w+?\d+(\w+?_kernel)", ln)
        if m:
            name = m.group(1)
        elif name and "stack frame" in ln:
            out.append(f"{name}: {ln.strip()}")
        elif name and "registers" in ln:
            out[-1] += "; " + ln.split(":", 1)[1].strip()
            name = None
    return out


def close(name, got, want, exact, rtol=1e-6, atol=1e-5):
    """max |got - want|; raises when integers differ or floats leave tol."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if exact:
        bad = (got != want).sum().item()
        if bad:
            raise AssertionError(f"{name}: {bad} entries differ")
        return 0.0
    gf, wf = got.double(), want.double()
    err = (gf - wf).abs()
    tol = atol + rtol * wf.abs()
    if bool((err > tol).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} over tolerance")
    return float(err.max().item()) if err.numel() else 0.0


def cuda_ms(fn, reps, setup=None):
    """Mean ms per call of fn() over reps calls issued back to back between
    two CUDA events. This is the call's cost as a caller sees it: where the
    host takes longer to issue a call than the device takes to run it (a
    short kernel behind its wrapper's Python checks, or a plain version's
    many small ops), the host's time is what is measured. setup() makes
    each call's inputs (fresh tree copies for the kernels that update in
    place) before timing."""
    import torch

    args = [setup() if setup else () for _ in range(reps)]
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for a in args:
        fn(*a)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps, kernel, setup=None, parts=None):
    """(ms, sessions): the device time of one call's launches of `kernel`
    (its qualified name in csrc/, e.g. "tmt::select_kernel", or a tuple of
    names for a call that
    launches several kernels: their mean times a launch are summed): fn() is
    called reps times under torch.profiler, and the device-side time of the
    launches the profiler recorded is averaged. The host's time between
    launches is not counted. The profiler can miss launches at the start of a
    session (1 to 3 of 20 seen on the H100), and once missed all 20 of a
    session; the mean is over the launches it recorded. A session that
    recorded fewer than half of reps, or more than reps, is measured again,
    up to PROFILER_SESSIONS sessions; then it raises, naming what the profiler
    saw. `sessions` is how many it took. Each kernel's own mean goes into the
    dict `parts` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    for session in range(PROFILER_SESSIONS):
        args = [setup() if setup else () for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in args:
                fn(*a)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows = {name: [e for e in events  # "name(" or a template's "name<"
                       if f"{name}(" in e.key or f"{name}<" in e.key] for name in names}
        seen = {name: sum(e.count for e in r) for name, r in rows.items()}
        if all(reps // 2 <= n <= reps for n in seen.values()):
            break
        say(f"device_ms: profiler session {session + 1} saw {seen} launches of {reps}; "
            f"its device events: {[(e.key[:60], e.count) for e in events[:4]]}")
    else:
        raise AssertionError(f"{names}: profiler saw {seen} launches, want {reps}")
    total = 0.0
    for name in names:
        ms = sum(e.self_device_time_total for e in rows[name]) / 1e3 / seen[name]
        if parts is not None:
            parts[name] = ms
        total += ms
    return total, session + 1


def stub_evaluator(x):
    """Deterministic stand-in for the net (the reference tests' linspace
    evaluator): v = linspace(1, 8), var = 2.5."""
    import torch

    n = x.shape[0]
    return (torch.linspace(1.0, 8.0, n, device=x.device),
            torch.full((n,), 2.5, device=x.device))


def phase_small(torch, mcts, T, evaluator):
    """The move program on the card against the same program on the CPU,
    with the stub net (lp, leaf) or fixed playout draws (rollout)."""
    import numpy as np

    tcfg = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=16,
                        low=5 if evaluator == "rollout" else 1)
    scfg = mcts.SearchConfig(tree=tcfg, sims=8, evaluator=evaluator, rollout_cap=64)
    rng = np.random.RandomState(0)
    n_calls = 3 * scfg.sims
    planes = [torch.as_tensor(-np.log(rng.exponential(size=(4, 16, 7))), dtype=torch.float32)
              for _ in range(n_calls)]
    draws = torch.as_tensor(rng.randint(0, 7, (n_calls * scfg.rollout_cap, 4)))
    zeros = torch.zeros(4, 16, 7)
    results = {}
    for dev in ("cuda", "cpu"):
        feed = iter(planes)
        src = lambda B, D, dev=dev: (next(feed).to(dev), zeros.to(dev))
        acts = iter(draws)
        draw = lambda B, step, dev=dev: next(acts).to(dev)
        ev = {"lp": lambda: mcts.nn_child_evaluator(stub_evaluator),
              "leaf": lambda: mcts.nn_leaf_evaluator(stub_evaluator),
              "rollout": lambda: mcts.rollout_evaluator(scfg, draw)}[evaluator]()
        move = mcts.make_move_fn(ev, scfg, src)
        trees, envs = mcts.init_batch(7, 4, scfg, device=dev)
        out = []
        for _ in range(3):
            envs, st = move(trees, envs)
            out.append(st.action)
        results[dev] = (torch.stack(out), trees, envs)
    ga, gt, ge = results["cuda"]
    ca, ct, ce = results["cpu"]
    close(f"small[{evaluator}] actions", ga, ca, True)
    close(f"small[{evaluator}] envs", ge, ce, True)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits",
              "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        close(f"small[{evaluator}] {f}", getattr(gt, f), getattr(ct, f), True)
    return max(close(f"small[{evaluator}] values", gt.values, ct.values, False),
               close(f"small[{evaluator}] vars", gt.vars_, ct.vars_, False))


def phase_net(torch):
    """The VV net's float32 forward on the card against the CPU, same
    weights (from seed 5), on 448 random boards (one sim's 64 x 7 children)."""
    import numpy as np

    from tetris_mcts_tpu_torch.train.trainer import VVModel

    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randint(-1, 2, (448, 1, 20, 10)).astype(np.float32))
    v_c, var_c = VVModel(seed=5, device="cpu").apply_fn()(x)
    v_g, var_g = VVModel(seed=5, device="cuda").apply_fn()(x.cuda())
    return (close("net value", v_g, v_c, False, rtol=1e-4, atol=1e-3),
            close("net variance", var_g, var_c, False, rtol=1e-4, atol=1e-2))


def bytes_select(lengths, D, B):
    # per level: cbase 4 + 7 x (score 4 + obs 4) + 7 x 3 stats x 4 + gumbels 28;
    # per lane: root 4 + env in 176, out: trace D x 4, length/leaf 8,
    # leaf env 176, 7 packed children 560, scores/ends 56
    levels = int(lengths.sum().item())
    return levels * (4 + 56 + 84 + 28) + B * (4 + 176 + 4 * D + 8 + 176 + 560 + 56)


def bytes_insert(n_new, B):
    # per lane: 7 boards in 560, end7 7, ok 1, >= 7 slot probes x 12, n_obs
    # 8, obs7 28; per fresh id: its slot 12 + obs_end 1 + obs_bits 80
    return B * (560 + 7 + 1 + 84 + 8 + 28) + n_new * (12 + 1 + 80)


def bytes_lp(lengths, B):
    # per lane: lengths 4, v/var 56, expanded 1, leaf cbase/score 8, 7
    # children x (score, obs, end 9 + stats 12); per level: trace 4,
    # score/obs 8, stats read 12 + write 12
    levels = int(lengths.sum().item())
    return B * (4 + 56 + 1 + 8 + 7 * 21) + levels * (4 + 8 + 24)


def bytes_backup(lengths, B):
    # per lane: v0/var0/length 12; per level: trace 4, score/obs 8, stats
    # read 12 + write 12
    levels = int(lengths.sum().item())
    return B * 12 + levels * (4 + 8 + 24)


def bytes_bench_walk(L, B, M):
    # idxs in; the three (M, B) statistics read once and written once
    return L * B * 4 + 2 * 3 * M * B * 4


# multiply-adds of one board through the VV net: conv1 18*8*32*9, conv2
# 16*6*32*288, conv3 14*4*32*288, fc1 1792*256, fc2 256*2
VV_MACS = 18 * 8 * 32 * 9 + 16 * 6 * 32 * 288 + 14 * 4 * 32 * 288 + 1792 * 256 + 256 * 2


def bound_vv(n, net):
    """(bound ms, what bounds it) of the fused forward on n boards: the
    larger of its float32 operations over the card's float32 rate and its
    bytes (boards in 80 B, outputs 8 B, every weight once) over HBM's."""
    w_bytes = 4 * sum(p.numel() for p in net.parameters())
    t_ops = 2 * VV_MACS * n / FP32_FLOPS
    t_bytes = (n * (80 + 8) + w_bytes + 16) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def device_ms_all(fn, reps):
    """(device ms, kernel launches) of one fn() call: all the kernels it
    launches (torch.profiler, device-side events only), over reps calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / reps,
            sum(e.count for e in rows) / reps)


def reset_launches():
    from tetris_mcts_tpu_torch.ops import bench_walk, tree_walk, vv_forward

    tree_walk.reset_launches()
    vv_forward.reset_launches()
    bench_walk.reset_launches()


def read_launches():
    from tetris_mcts_tpu_torch.ops import bench_walk, tree_walk, vv_forward

    return {**tree_walk.LAUNCHES, **vv_forward.LAUNCHES, **bench_walk.LAUNCHES}


def check_launches(path, got, want):
    """Every kernel's launches on `path` equal want.get(name, 0)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)}")


def drive(torch, cfg, moves, log):
    """SelfPlayDriver for cfg on the card: one warm-up move, then `moves`
    moves with the launch counts set to 0 just before and read just after.
    Returns (driver, wall seconds of the moves, launches)."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayDriver

    driver = SelfPlayDriver(cfg, device="cuda", log=log)
    driver.step()  # warm-up move: cuDNN autotune, allocator
    torch.cuda.synchronize()
    reset_launches()
    t_run = time.perf_counter()
    driver.run(moves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = read_launches()
    st = driver.last_stats
    for name, x in st._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x[x > -torch.inf]).all()):
            raise AssertionError(f"{cfg.evaluator} path: non-finite {name}")
    if not bool((st.child_stats[:, 0].sum(1) > 0).all()):
        raise AssertionError(f"{cfg.evaluator} path: a root without visits")
    return driver, wall, launches


def report_episode(driver, episodes):
    st = driver.last_stats
    if episodes:
        say(f"episode line: {episodes[-1]}")
    else:  # games outlast the run: game 0 so far, in the Episode format
        say(f"episode line (game 0, live): Episode:     -  Score:{int(st.score[0]):10d}  "
            f"Lines Cleared:{int(st.lines[0]):5d}")


def report_profile(torch, driver, wall, moves, label):
    t = time.perf_counter()
    busy_ms, prof_rows = profile_moves(torch, driver, 2)
    per_move_ms = wall / moves * 1e3
    say(f"phase profile ({label}): device kernel time {busy_ms / 2:.2f} ms per move "
        f"against {per_move_ms:.2f} ms wall per move unprofiled (device busy share "
        f"{busy_ms / 2 / per_move_ms:.3f}); top device kernels:")
    # the twelve largest, and the port's own kernels wherever they rank
    for name, ms, n in prof_rows[:12] + [r for r in prof_rows[12:] if r[0].startswith("tmt")]:
        say(f"  {ms / 2:9.3f} ms/move  {n // 2:6d} launches/move  {name[:90]}")
    say(f"phase profile ({label}) took {time.perf_counter() - t:.1f}s")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from tetris_mcts_tpu_torch.ops import build, tree_walk, vv_forward
        from tetris_mcts_tpu_torch.search import mcts
        from tetris_mcts_tpu_torch.search import tree as T
        from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig
    except ImportError as e:
        print(f"chip_smoke: the port package is not here ({e})", file=sys.stderr)
        return 2

    # ---- 1. device ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"phase device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {count} device(s)")

    # ---- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    build.build_all()
    for name in build.LIBRARIES:
        build.lib(name)
        say(f"phase build: {name}: nvcc {build.build_seconds[name]:.1f}s; ptxas: "
            f"{' | '.join(ptxas_summary(build.ptxas_log.get(name, '')))}")
    walk_ptxas = ptxas_summary(build.ptxas_log.get("tree_walk", ""))
    say("ptxas -v of the backups and the bench walk, and of insert: " + (" | ".join(
        x for x in walk_ptxas if x.startswith(("backup_kernel", "lp_backup_kernel",
                                               "bench_walk_kernel", "insert7_kernel")))
        or "none: the library was built before this run"))
    say(f"phase build took {time.perf_counter() - t:.1f}s (nvcc calls in parallel, "
        f"with load)")

    # ---- 3. small: card vs CPU on small searches ----------------------------
    t = time.perf_counter()
    small_err = {ev: phase_small(torch, mcts, T, ev) for ev in mcts.EVALUATORS}
    net_err = phase_net(torch)
    say(f"phase small: 3 moves x 8 sims at B=4 equal on cuda and cpu for "
        + ", ".join(f"{ev} (float max abs err {e:.3e})" for ev, e in small_err.items())
        + f"; VV net float32 on cuda vs cpu max abs err value {net_err[0]:.3e}, "
        f"variance {net_err[1]:.3e}; in {time.perf_counter() - t:.1f}s")

    # ---- 4. main path (lp) --------------------------------------------------
    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True)  # the CLI's default width, frozen net
    episodes = []
    driver, wall, launches = drive(torch, cfg, MOVES, episodes.append)
    want = MOVES * cfg.sims
    check_launches("lp path", launches,
                   {"select_walk": want, "insert7_walk": want, "lp_backup_walk": want})
    st = driver.last_stats
    say(f"phase main (lp): {MOVES} moves x {cfg.sims} sims at B={cfg.batch} in "
        f"{wall:.2f}s: {MOVES / wall:.2f} moves/s, "
        f"{MOVES * cfg.batch * cfg.sims / wall:.1f} sims/s ({smi}); launches "
        f"{launches}; {driver.episodes} episodes; mean root nodes "
        f"{st.n_nodes.float().mean().item():.0f}")
    report_episode(driver, episodes)
    say(f"phase main (lp) took {time.perf_counter() - t:.1f}s")

    # ---- 5. where the time goes: two profiled moves -------------------------
    report_profile(torch, driver, wall, MOVES, "lp")

    # ---- 6. leaf path (ValueSim) --------------------------------------------
    t = time.perf_counter()
    lcfg = cfg._replace(evaluator="leaf")
    episodes = []
    leaf_driver, leaf_wall, leaf_launches = drive(torch, lcfg, MOVES, episodes.append)
    check_launches("leaf path", leaf_launches,
                   {"select_walk": want, "insert7_walk": want, "backup_walk": want})
    st = leaf_driver.last_stats
    say(f"phase leaf: {MOVES} moves x {lcfg.sims} sims at B={lcfg.batch} in "
        f"{leaf_wall:.2f}s: {MOVES / leaf_wall:.2f} moves/s, "
        f"{MOVES * lcfg.batch * lcfg.sims / leaf_wall:.1f} sims/s ({smi}); launches "
        f"{leaf_launches}; {leaf_driver.episodes} episodes; mean root nodes "
        f"{st.n_nodes.float().mean().item():.0f}")
    report_episode(leaf_driver, episodes)
    say(f"phase leaf took {time.perf_counter() - t:.1f}s")
    report_profile(torch, leaf_driver, leaf_wall, MOVES, "leaf")

    # ---- 7. rollout path (Vanilla) ------------------------------------------
    t = time.perf_counter()
    rcfg = cfg._replace(evaluator="rollout", sims=4, low=5)
    r_moves = 2
    episodes = []
    r_driver, r_wall, r_launches = drive(torch, rcfg, r_moves, episodes.append)
    r_want = r_moves * rcfg.sims
    check_launches("rollout path", r_launches,
                   {"select_walk": r_want, "insert7_walk": r_want, "backup_walk": r_want})
    say(f"phase rollout: {r_moves} moves x {rcfg.sims} sims at B={rcfg.batch}, "
        f"rollout_cap {r_driver.search_cfg.rollout_cap}, in {r_wall:.2f}s: "
        f"{r_wall / r_moves * 1e3:.1f} ms wall per move ({smi}); launches {r_launches}; "
        f"last playout ran {r_driver.evaluator.steps} steps")
    say(f"phase rollout took {time.perf_counter() - t:.1f}s")

    # ---- 8. forward path: the fused forward's entry on the search's boards --
    t = time.perf_counter()
    tcfg = driver.search_cfg.tree
    B, D = cfg.batch, tcfg.max_depth
    trees, leaf_trees = driver.trees, leaf_driver.trees
    gum, rnd = mcts.TorchPlanes(123, "cuda", tcfg.policy)(B, D)
    out_lp = tree_walk.select_walk(trees, gum, rnd, tcfg)
    out_leaf = tree_walk.select_walk(leaf_trees, gum, rnd, tcfg)
    from tetris_mcts_tpu_torch.ops.env_packed import packed_obs

    boards = {"lp children": out_lp[4].reshape(B * 7, 20).contiguous(),
              "leaf boards": packed_obs(out_leaf[3]).contiguous()}
    model = driver.model
    reset_launches()
    fwd = {k: vv_forward.vv_forward_packed(model.net, model.ubound, model.lbound, x)
           for k, x in boards.items()}
    torch.cuda.synchronize()
    fwd_launches = read_launches()
    check_launches("forward path", fwd_launches, {"vv_forward": len(boards)})
    for k, (v, var) in fwd.items():
        if not (bool(torch.isfinite(v).all()) and bool(torch.isfinite(var).all())):
            raise AssertionError(f"forward path: non-finite output on {k}")
    say(f"phase forward: vv_forward_packed on {', '.join(f'{x.shape[0]} {k}' for k, x in boards.items())}; "
        f"launches {fwd_launches}; in {time.perf_counter() - t:.1f}s")

    # ---- 8b. the micro-benchmark walk's entry, at the script's shapes --------
    t = time.perf_counter()
    import numpy as np

    from tetris_mcts_tpu_torch.ops import bench_walk

    bw_B, bw_M = 256, 2048
    rng = np.random.RandomState(0)
    bw_idxs = torch.as_tensor(rng.randint(1, bw_M, (bench_walk.LEVELS, bw_B)).astype(np.int32),
                              device="cuda")
    bw_stats = [torch.zeros(bw_M, bw_B, device="cuda") for _ in range(3)]
    reset_launches()
    bw_out = bench_walk.bench_walk(bw_idxs, *bw_stats)
    torch.cuda.synchronize()
    bw_launches = read_launches()
    check_launches("bench walk", bw_launches, {"bench_walk": 1})
    say(f"phase bench walk: bench_walk at B={bw_B}, M={bw_M}, {bench_walk.LEVELS} levels; "
        f"launches {bw_launches}; in {time.perf_counter() - t:.1f}s")

    # ---- 9. kernels vs plain on the grown trees -----------------------------
    t = time.perf_counter()
    rows = []

    # every selection rule the kernel accepts (low=1 lets the rule's bound
    # decide; low=10 is the CLI's bayes setting), then the main path's clt,
    # on the trees of the lp and of the leaf path
    names = ("traces", "lengths", "leafs", "leaf_env", "child_packed",
             "child_score", "child_end")
    cases = [(p, 1) for p in tree_walk.POLICIES if p != "clt"] + [("bayes", 10)]
    for label, tt in (("lp", trees), ("leaf", leaf_trees)):
        for policy, low in cases + [("clt", tcfg.low)]:
            pcfg = tcfg._replace(policy=policy, low=low)
            gum, rnd = mcts.TorchPlanes(123, "cuda", policy)(B, D)
            out_k = tree_walk.select_walk(tt, gum, rnd, pcfg)
            out_p = tree_walk.select_walk_plain(tt, gum, rnd, pcfg)
            for n, a, b in zip(names, out_k, out_p):
                close(f"select[{label} trees, {policy}, low={low}] {n}", a, b, True)
    say(f"kernel select_walk: all 7 outputs equal to plain on the lp and the leaf trees "
        f"for {', '.join(f'{p}/low={lo}' for p, lo in cases)} and clt (the main path's)")
    sel_ms = {}
    for label, tt in (("lp", trees), ("leaf", leaf_trees)):
        gum, rnd = mcts.TorchPlanes(123, "cuda", tcfg.policy)(B, D)
        out_k = tree_walk.select_walk(tt, gum, rnd, tcfg)
        sel = lambda: tree_walk.select_walk(tt, gum, rnd, tcfg)
        sel_ms[label] = (*device_ms(sel, 20, "tmt::select_kernel"), cuda_ms(sel, 20),
                         cuda_ms(lambda: tree_walk.select_walk_plain(tt, gum, rnd, tcfg), 2),
                         out_k)
        say(f"kernel select_walk on the {label} trees: {sel_ms[label][0]:.4f} ms device a "
            f"launch ({sel_ms[label][2]:.4f} ms a call with the wrapper), "
            f"{sel_ms[label][3]:.1f} ms plain; mean length "
            f"{out_k[1].float().mean().item():.1f}")
    ms_k, tries, ev_k, ms_p, out_k = sel_ms["lp"]
    traces, lengths, leafs, _, packed7, sc7, end7i = out_k
    rows.append(("select_walk", "tree_walk.cu", "tetris_mcts_tpu/ops/tree_walk.py:424",
                 launches, 0.0, ms_k, ev_k, ms_p,
                 bytes_select(lengths, D, B) / HBM_BYTES_PER_S * 1e3, "bytes", None, tries))
    say(f"kernel select_walk (clt, lp trees): max diff 0; {launches['select_walk']} launches "
        f"on the lp path, {leaf_launches['select_walk']} on the leaf path")

    b = torch.arange(B, device="cuda")
    can = (~trees.end[b, leafs.long()]) & (trees.cbase[b, leafs.long()] == 0) & (
        trees.n_nodes + 7 <= tcfg.max_nodes) & (trees.n_obs + 7 <= tcfg.max_obs)
    end7 = end7i != 0
    t_k, t_p = trees.clone(), trees.clone()
    o_k = tree_walk.insert_obs7(t_k, packed7, end7, can, tcfg)
    o_p = T.insert_obs7_batched(t_p, packed7, end7, can, tcfg)
    close("insert obs7", o_k, o_p, True)
    for f in ("tbl_h1", "tbl_h2", "tbl_obs", "n_obs", "obs_end", "obs_bits"):
        close(f"insert {f}", getattr(t_k, f), getattr(t_p, f), True)
    n_new = int((t_k.n_obs - trees.n_obs).sum().item())
    ins_k = lambda tt: tree_walk.insert_obs7(tt, packed7, end7, can, tcfg)
    fresh = lambda: (trees.clone(),)
    ms_k, tries = device_ms(ins_k, 20, "tmt::insert7_kernel", setup=fresh)
    ev_k = cuda_ms(ins_k, 20, setup=fresh)
    ms_p = cuda_ms(lambda tt: T.insert_obs7_batched(tt, packed7, end7, can, tcfg), 2,
                   setup=fresh)
    rows.append(("insert7_walk", "tree_walk.cu", "tetris_mcts_tpu/ops/tree_walk.py:804",
                 launches, 0.0, ms_k, ev_k, ms_p,
                 bytes_insert(n_new, B) / HBM_BYTES_PER_S * 1e3, "bytes", None, tries))
    say(f"kernel insert7_walk: max diff 0 (obs7 and tables equal to plain; "
        f"{int(can.sum())} lanes expand, {n_new} fresh ids); {ms_k:.4f} ms device a "
        f"launch ({ev_k:.4f} ms a call with the wrapper), {ms_p:.1f} ms plain; "
        f"{launches['insert7_walk']} launches on the lp path")

    T.expand_commit(t_k, sc7, end7, o_k, leafs, can)
    v, var = model.apply_fn()(packed_imgs(packed7))
    v, var = v.reshape(B, 7).contiguous(), var.reshape(B, 7).contiguous()
    l_k, l_p = t_k.clone(), t_k.clone()
    tree_walk.lp_backup(l_k, traces, lengths, v, var, can, tcfg)
    tree_walk.lp_backup_plain(l_p, traces, lengths, v, var, can, tcfg)
    close("lp visits", l_k.visits, l_p.visits, True)
    err = max(close("lp values", l_k.values, l_p.values, False),
              close("lp vars", l_k.vars_, l_p.vars_, False))
    lp_k = lambda tt: tree_walk.lp_backup(tt, traces, lengths, v, var, can, tcfg)
    fresh = lambda: (t_k.clone(),)
    ms_k, tries = device_ms(lp_k, 20, "tmt::lp_backup_kernel", setup=fresh)
    ev_k = cuda_ms(lp_k, 20, setup=fresh)
    ms_p = cuda_ms(lambda tt: tree_walk.lp_backup_plain(tt, traces, lengths, v, var, can,
                                                        tcfg), 2, setup=fresh)
    rows.append(("lp_backup_walk", "tree_walk.cu", "tetris_mcts_tpu/ops/tree_walk.py:1091",
                 launches, err, ms_k, ev_k, ms_p,
                 bytes_lp(lengths, B) / HBM_BYTES_PER_S * 1e3, "bytes", None, tries))
    say(f"kernel lp_backup_walk: visits equal to plain, values/vars max abs err "
        f"{err:.3e}; {ms_k:.4f} ms device a launch ({ev_k:.4f} ms a call with the "
        f"wrapper), {ms_p:.1f} ms plain; "
        f"{launches['lp_backup_walk']} launches on the lp path")

    edge_err = walk_edges(torch, tree_walk, T)
    say(f"kernel insert7_walk, lp_backup_walk and backup_walk on the edge inputs (B=67, "
        f"D=96): obs ids, tables, obs rows and visits equal to plain, the backup's values "
        f"and vars too; LP values/vars max abs err {edge_err:.3e}; bench_walk equal to "
        f"plain at B=1, 67 and M=4, 2048")

    # the backup walk on the leaf path's grown trees, from the leaf
    # evaluator's (v0, var0): leaf score + net value, net variance
    l_traces, l_lengths, l_leafs, l_env = out_leaf[:4]
    lv, lvar = leaf_driver.evaluator(None, l_env)
    bl = torch.arange(B, device="cuda")
    v0 = leaf_trees.nstat[bl, 0, l_leafs.long()] + lv
    b_k, b_p = leaf_trees.clone(), leaf_trees.clone()
    tree_walk.backup(b_k, l_traces, l_lengths, v0, lvar, tcfg)
    T.backup_batched(b_p, l_traces, l_lengths, v0, lvar, tcfg)
    err = max(close(f"backup {f}", getattr(b_k, f), getattr(b_p, f), True)
              for f in ("visits", "values", "vars_"))
    bk = lambda tt: tree_walk.backup(tt, l_traces, l_lengths, v0, lvar, tcfg)
    fresh = lambda: (leaf_trees.clone(),)
    ms_k, tries = device_ms(bk, 20, "tmt::backup_kernel", setup=fresh)
    ev_k = cuda_ms(bk, 20, setup=fresh)
    ms_p = cuda_ms(lambda tt: T.backup_batched(tt, l_traces, l_lengths, v0, lvar, tcfg),
                   2, setup=fresh)
    rows.append(("backup_walk", "tree_walk.cu", "tetris_mcts_tpu/ops/tree_walk.py:161",
                 leaf_launches, err, ms_k, ev_k, ms_p,
                 bytes_backup(l_lengths, B) / HBM_BYTES_PER_S * 1e3, "bytes", None, tries))
    say(f"kernel backup_walk: visits, values and vars equal to plain; "
        f"{ms_k:.4f} ms device a launch ({ev_k:.4f} ms a call with the wrapper), "
        f"{ms_p:.1f} ms plain; {leaf_launches['backup_walk']} launches on the leaf "
        f"path; mean length {l_lengths.float().mean().item():.1f}")

    # the fused forward against its plain version and VVNet, on both board sets
    from tetris_mcts_tpu_torch.env.engine import unpack_obs

    net, ub, lb = model.net, model.ubound, model.lbound
    fwd_rows = {}
    bits = trees.obs_bits.permute(0, 2, 1).reshape(-1, 20)
    boards["obs rows"] = bits[bits.any(1)][:1792].contiguous()
    if boards["obs rows"].shape[0] != 1792:
        raise AssertionError("forward: fewer than 1792 boards in the lp trees")
    for k, x in boards.items():
        v_k, var_k = (fwd[k] if k in fwd else
                      vv_forward.vv_forward_packed(net, ub, lb, x))
        v_p, var_p = vv_forward.vv_forward_packed_plain(net, ub, lb, x)
        imgs = unpack_obs(x)[:, None].float()
        v_n, var_n = model.apply_fn()(imgs)
        err = max(close(f"vv_forward[{k}] value vs plain", v_k, v_p, False, 1e-4, 1e-3),
                  close(f"vv_forward[{k}] variance vs plain", var_k, var_p, False, 1e-4,
                        1e-2),
                  close(f"vv_forward[{k}] value vs VVNet", v_k, v_n, False, 1e-4, 1e-3),
                  close(f"vv_forward[{k}] variance vs VVNet", var_k, var_n, False, 1e-4,
                        1e-2))
        fk = lambda: vv_forward.vv_forward_packed(net, ub, lb, x)
        split = {}
        ms_k, tries = device_ms(fk, 20, ("tmt_vv::vv_conv_kernel", "tmt_vv::vv_fc_kernel"),
                                parts=split)
        ev_k = cuda_ms(fk, 20)
        ms_p = cuda_ms(lambda: vv_forward.vv_forward_packed_plain(net, ub, lb, x), 5)
        ms_lib, _ = device_ms_all(lambda: model.apply_fn()(imgs), 20)
        bound, bound_by = bound_vv(x.shape[0], net)
        fwd_rows[k] = (err, ms_k, ev_k, ms_p, bound, bound_by, ms_lib, tries)
        say(f"kernel vv_forward on {x.shape[0]} {k}: max abs err {err:.3e} against "
            f"plain and VVNet; {ms_k:.4f} ms device a call (conv ladder "
            f"{split['tmt_vv::vv_conv_kernel']:.4f}, FC {split['tmt_vv::vv_fc_kernel']:.4f}; "
            f"{ev_k:.4f} ms a call "
            f"with the wrapper), {ms_p:.3f} ms plain, VVNet forward (cuDNN/cuBLAS) "
            f"{ms_lib:.4f} ms device; bound {bound:.4f} ms ({bound_by})")
    err = max(r[0] for r in fwd_rows.values())
    rows.append(("vv_forward", "vv_forward.cu", "tetris_mcts_tpu/ops/vv_forward.py:117",
                 fwd_launches, err, *fwd_rows["lp children"][1:]))

    # the micro-benchmark walk against its plain version, the script's shapes
    bw_plain = bench_walk.bench_walk_plain(bw_idxs, *bw_stats)
    for n, a, b in zip(("visit", "value", "var"), bw_out, bw_plain):
        close(f"bench_walk {n}", a, b, True)
    bwk = lambda: bench_walk.bench_walk(bw_idxs, *bw_stats)
    ms_k, tries = device_ms(bwk, 20, "tmt::bench_walk_kernel")
    ev_k = cuda_ms(bwk, 20)
    ms_p = cuda_ms(lambda: bench_walk.bench_walk_plain(bw_idxs, *bw_stats), 2)
    bound = bytes_bench_walk(bench_walk.LEVELS, bw_B, bw_M) / HBM_BYTES_PER_S * 1e3
    rows.append(("bench_walk", "tree_walk.cu", "scripts/microbench_pallas_walk.py:36",
                 bw_launches, 0.0, ms_k, ev_k, ms_p, bound, "bytes", None, tries))
    say(f"kernel bench_walk: equal to plain; {ms_k:.4f} ms device a launch ({ev_k:.4f} ms "
        f"a call with the wrapper), {ms_p:.3f} ms plain; bound {bound:.4f} ms (bytes)")
    say(f"phase kernels took {time.perf_counter() - t:.1f}s")

    # ---- 10. online: self-play with training at the CLI's width --------------
    phase_online(torch, smi)

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"tetris_mcts_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": counts[name], "max_abs_err": err,
        "ms": ms_k, "call_ms": ev_k, "plain_ms": ms_p,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": ms_lib,
        "profiler_sessions": tries,
    } for (name, src, replaces, counts, err, ms_k, ev_k, ms_p, bound, bound_by,
           ms_lib, tries) in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def phase_online(torch, smi):
    """ValueSimLP self-play with training at the CLI's width, through
    `SelfPlayDriver` in online mode; then the train step and the store
    measured and checked on their own."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.models.nets import tf32_off
    from tetris_mcts_tpu_torch.obs.metrics import MetricsReader, MetricsWriter
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
    from tetris_mcts_tpu_torch.search import mcts
    from tetris_mcts_tpu_torch.search import tree as T
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_train_cases import agreeing_minibatch, min_nonzero_preactivation

    t = time.perf_counter()
    cfg = SelfPlayConfig(train_max_iters=ONLINE_MAX_ITERS)
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.jsonl")
        metrics = MetricsWriter(mpath)
        driver = SelfPlayDriver(cfg, device="cuda", log=logs.append, metrics=metrics)
        model = driver.model
        fixed = torch.as_tensor(np.random.RandomState(11).randint(-1, 2, (64, 1, 20, 10)),
                                dtype=torch.float32, device="cuda")
        before = model.apply_fn()(fixed)
        totals, session_move, at_session = [], None, None
        reset_launches()
        t_run = time.perf_counter()
        while len(totals) < ONLINE_MOVE_CAP:
            driver.step()
            totals.append(driver._prev_total)
            if session_move is None and driver.n_trains:
                session_move, at_session = len(totals), read_launches()
            if session_move is not None and len(totals) - session_move >= 5:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = read_launches()
        metrics.close()
        reader = MetricsReader(mpath)
        reader.poll()
        sessions = reader.of_kind("train_session")
        if session_move is None:
            raise AssertionError(f"online path: no training session in {len(totals)} moves "
                                 f"({totals[-1]} rows harvested)")
        moves = len(totals)
        want = moves * cfg.sims
        check_launches("online path", launches,
                       {"select_walk": want, "insert7_walk": want, "lp_backup_walk": want})
        after_moves = moves - session_move
        for k in ("select_walk", "insert7_walk", "lp_backup_walk"):
            if launches[k] - at_session[k] != after_moves * cfg.sims:
                raise AssertionError(f"online path: {k} launched "
                                     f"{launches[k] - at_session[k]} times in the "
                                     f"{after_moves} moves after the session")
        change = max(float((a - b).abs().max()) for a, b in zip(model.apply_fn()(fixed), before))
        if not change > 0:
            raise AssertionError("online path: the net's outputs did not change in training")
        st = driver.last_stats
        for name, x in st._asdict().items():
            if x.is_floating_point() and not bool(torch.isfinite(x[x > -torch.inf]).all()):
                raise AssertionError(f"online path: non-finite {name}")
        per_move = np.diff([0] + totals)
        harvest_moves = int((per_move > 0).sum())
        zero_grad = any(ln.startswith("Zero-gradient") for ln in logs)
        say(f"phase online (lp, training): {moves} moves x {cfg.sims} sims at B={cfg.batch} "
            f"in {wall:.2f}s, the first session after move {session_move}; launches "
            f"{launches}, {after_moves * cfg.sims} of each walk after the session; "
            f"{driver.episodes} episodes ({smi})")
        say(f"  rows harvested: {totals[-1]} in {moves} moves ({totals[-1] / moves:.1f} a move; "
            f"{harvest_moves} moves harvested, {totals[-1] / max(harvest_moves, 1):.1f} rows "
            f"each); ubound now {[round(float(x), 3) for x in model.ubound]}")
        for e in sessions:
            early = (e["iters"] < cfg.train_max_iters and not zero_grad)
            say(f"  session {e['n']}: {e['rows']} rows, {e['iters']} iterations "
                f"(cap {cfg.train_max_iters}; early stopping "
                f"{'fired' if early else 'did not fire'}"
                f"{'; zero-gradient guard fired' if zero_grad else ''}), {e['seconds']:.2f}s, "
                f"{e['iters'] / e['seconds']:.1f} iterations/s, loss train {e['loss_train']:.4f} "
                f"val {e['loss_val']:.4f}")
        say(f"  net outputs on 64 fixed boards moved by up to {change:.4f} after training")

        # the train step on its own: device time and launches at batch 128
        n_rows = min(4096, driver.replay.count.item())
        newest = (np.arange(driver.replay.idx.item() - n_rows, driver.replay.idx.item())
                  % cfg.memory_size)
        states, value, var, weight = driver._training_columns(newest)
        cols = [states.float()[:, None], value, var, weight / weight.mean()]
        sd = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
        mu, nu, count = model.opt.state()

        def copy_of(dev):
            m = VVModel(seed=cfg.seed, device=dev)
            m.load_state({k: v.to(dev) for k, v in sd.items()}, model.ubound.to(dev),
                         model.lbound.to(dev))
            m.opt.load([x.to(dev) for x in mu], [x.to(dev) for x in nu], count)
            return m

        prof_m = copy_of("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        idxs = [torch.randint(0, n_rows, (cfg.train_batch,), generator=gen, device="cuda")
                for _ in range(23)]
        it = iter(idxs)
        step = lambda: prof_m.train_step(cols, next(it))
        for _ in range(3):
            step()
        step_ms, step_launches = device_ms_all(step, 20)
        it = iter(idxs[3:])
        step_call_ms = cuda_ms(step, 20)
        # its parts: the forward (with the loss), forward + backward
        batch = tuple(c[idxs[0]] for c in cols)

        def forward():
            with tf32_off():
                prof_m.per_sample_loss(*batch).mean()

        fwd_ms, fwd_n = device_ms_all(forward, 20)
        fb_ms, fb_n = device_ms_all(lambda: prof_m.loss_and_grads(batch), 20)
        say(f"  train_step at batch {cfg.train_batch}: {step_ms:.4f} ms device, "
            f"{step_launches:.0f} kernel launches, {step_call_ms:.4f} ms a call between CUDA "
            f"events ({smi}); forward + loss {fwd_ms:.4f} ms ({fwd_n:.0f} launches), backward "
            f"{fb_ms - fwd_ms:.4f} ms ({fb_n - fwd_n:.0f}), the gather, grad norm and Yogi "
            f"{step_ms - fb_ms:.4f} ms ({step_launches - fb_n:.0f})")

        # a move's harvest and store, with every lane harvested (the masked
        # store does the same device work whatever the trigger)
        ring = mcts.init_replay(cfg.memory_size, "cuda")
        every = torch.ones(cfg.batch, dtype=torch.bool, device="cuda")

        def harvest_store():
            packed, val, vr, w, mask = T.harvest(driver.trees, cfg.min_visits_store)
            mcts.replay_add(ring, packed, val, vr, w, mask & every[:, None])

        harvest_store()
        hs_ms, hs_launches = device_ms_all(harvest_store, 20)
        say(f"  harvest + store add at B={cfg.batch}, M={cfg.max_obs}: {hs_ms:.4f} ms device a "
            f"move, {hs_launches:.0f} kernel launches ({smi})")

        # one step on the card against the CPU, TF32 switched on around it
        cpu_m, gpu_m = copy_of("cpu"), copy_of("cuda")
        cols_cpu = [c.cpu() for c in cols]
        # a minibatch on which both devices put every ReLU input on the same
        # side of zero (tests/torch_train_cases.py)
        idx, draws, crossed = agreeing_minibatch(cpu_m.net, gpu_m.net, cols_cpu[0],
                                                 cfg.train_batch)
        low = min_nonzero_preactivation(cpu_m.net, cols_cpu[0][idx])
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lc, _, gc = cpu_m.loss_and_grads(tuple(c[idx] for c in cols_cpu))
            lg, _, gg = gpu_m.loss_and_grads(tuple(c[idx.cuda()] for c in cols))
            grad_err = max(close(f"train step grad {n}", a, b, False, 1e-4,
                                 1e-5 * float(b.abs().max()))
                           for n, a, b in zip(cpu_m.names, gg, gc))
            loss_err = close("train step loss", lg, lc, False, 1e-5, 0.0)
            cpu_m.train_step(cols_cpu, idx)
            gpu_m.train_step(cols, idx.cuda())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        param_err = max(close(f"train step param {n}", a, b, False, 1e-4, 1e-6)
                        for n, a, b in zip(cpu_m.names, gpu_m.net.parameters(),
                                           cpu_m.net.parameters()))
        # The control: the same gradients with the step's pin removed (the
        # forward keeps its own), so autograd runs the backward in TF32. It
        # must miss the tolerance above, or that check could not fail.
        from tetris_mcts_tpu_torch.train import trainer as TR

        pin = TR.tf32_off
        TR.tf32_off = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, _, gt = copy_of("cuda").loss_and_grads(tuple(c[idx.cuda()] for c in cols))
        finally:
            TR.tf32_off = pin
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        ctl_err, ctl_over = 0.0, 0.0
        for a, b in zip(gt, gc):
            d = (a.cpu().double() - b.double()).abs()
            tol = 1e-4 * b.double().abs() + 1e-5 * float(b.abs().max())
            ctl_err, ctl_over = max(ctl_err, float(d.max())), max(ctl_over, float((d / tol).max()))
        say(f"  TF32 control (the step's pin removed, the backward in TF32): grads max abs err "
            f"{ctl_err:.3e}, {ctl_over:.1f}x the tolerance at its worst entry")
        if not ctl_over > 1.0:
            raise AssertionError("TF32 control: a TF32 backward stays within the train step's "
                                 "tolerance, so the card-vs-CPU check cannot catch it")
        say(f"  train_step on the card vs the CPU (TF32 switched on around it): loss err "
            f"{loss_err:.3e}, grads max abs err {grad_err:.3e} (rtol 1e-4, atol 1e-5 x each "
            f"tensor's largest), params after the Yogi step {param_err:.3e} (rtol 1e-4, "
            f"atol 1e-6); minibatch draw {draws} ({crossed} ReLU inputs on opposite sides of zero "
            f"in the draws before), nearest pre-activation {low:.2e}")

        # save / load round trip
        path = os.path.join(tmp, "model.pt")
        model.save(path)
        back = VVModel(seed=cfg.seed + 1, device="cuda")
        if not back.load(path):
            raise AssertionError("online: the saved checkpoint did not load")
        for a, b in zip(model.net.parameters(), back.net.parameters()):
            close("checkpoint params", a, b, True)
        for a, b in zip(model.opt.mu + model.opt.nu, back.opt.mu + back.opt.nu):
            close("checkpoint Yogi moments", a, b, True)
        if back.opt.count != model.opt.count:
            raise AssertionError("checkpoint: Yogi count differs")
        for a, b in zip(model.apply_fn()(fixed), back.apply_fn()(fixed)):
            close("checkpoint outputs", a, b, True)
        say(f"  checkpoint round trip: params, Yogi state ({back.opt.count} steps), bounds and "
            f"outputs equal ({os.path.getsize(path)} bytes)")
    say(f"phase online took {time.perf_counter() - t:.1f}s")


def walk_edges(torch, tree_walk, T, B=67):
    """Insert and both backups against their plain versions on the card, on
    the edge inputs of tests/torch_walk_cases.py (B=67: every trace length
    and a partly full last block), and the bench walk at small and ragged
    shapes. Returns the LP's max abs err of values/vars; raises on any
    difference."""
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.ops import bench_walk

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_walk_cases as C

    case = C.lp_case(0, B, 96)
    if C.repeats(case) != (True, True, True):
        raise AssertionError("walk edges: the LP case lacks a repeated obs")
    cfg = T.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M, table_size=16, max_depth=96)
    tk, tp = C.lp_tree(case, "cuda"), C.lp_tree(case, "cuda")
    args = C.lp_args(case, "cuda")
    tree_walk.lp_backup(tk, *args, cfg)
    tree_walk.lp_backup_plain(tp, *args, cfg)
    close("edges lp visits", tk.visits, tp.visits, True)
    err = max(close("edges lp values", tk.values, tp.values, False),
              close("edges lp vars", tk.vars_, tp.vars_, False))
    case = C.backup_case(0, B, 96)
    tk, tp = C.lp_tree(case, "cuda"), C.lp_tree(case, "cuda")
    args = C.backup_args(case, "cuda")
    tree_walk.backup(tk, *args, cfg)
    T.backup_batched(tp, *args, cfg)
    for f in ("visits", "values", "vars_"):
        close(f"edges backup {f}", getattr(tk, f), getattr(tp, f), True)
    rng = np.random.RandomState(1)
    for b, m in ((1, 4), (67, 4), (1, 2048), (67, 2048)):
        idxs = torch.as_tensor(rng.randint(1, m, (bench_walk.LEVELS, b)).astype(np.int32),
                               device="cuda")
        stats = [torch.as_tensor(rng.rand(m, b).astype(np.float32), device="cuda")
                 for _ in range(3)]
        for n, x, y in zip(("visit", "value", "var"), bench_walk.bench_walk(idxs, *stats),
                           bench_walk.bench_walk_plain(idxs, *stats)):
            close(f"edges bench_walk {n} (B={b}, M={m})", x, y, True)
    packed7, end7, ok = C.insert_case(0, B)
    tk, tp = C.insert_trees(0, B, "cuda"), C.insert_trees(0, B, "cuda")
    ran_out = False
    for r in range(C.INSERT_ROUNDS):
        a = [torch.as_tensor(x[r], device="cuda") for x in (packed7, end7, ok)]
        n_before = tk.n_obs.clone()
        got = tree_walk.insert_obs7(tk, *a, C.INSERT_CFG)
        close(f"edges insert obs7 (call {r})", got,
              T.insert_obs7_batched(tp, *a, C.INSERT_CFG), True)
        for f in ("tbl_h1", "tbl_h2", "tbl_obs", "n_obs", "obs_end", "obs_bits"):
            close(f"edges insert {f} (call {r})", getattr(tk, f), getattr(tp, f), True)
        ran_out |= C.ran_out(n_before, tk.n_obs, got, a[2])
    if not (ran_out and C.wrapped(tk)):
        raise AssertionError("walk edges: no probe wrapped or the pool never ran out")
    return err


def profile_moves(torch, driver, n):
    """Device time of n moves under torch.profiler: (total kernel ms, every
    kernel as (name, ms, launches), largest first). Only device-side events count; an
    operator's own row repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        driver.run(n)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def packed_imgs(packed7):
    from tetris_mcts_tpu_torch.env.engine import unpack_obs

    B = packed7.shape[0]
    return unpack_obs(packed7).reshape(B * 7, 1, 20, 10).float()


if __name__ == "__main__":
    sys.exit(main())
