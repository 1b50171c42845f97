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
   the CPU (plain versions), for every evaluator (lp, leaf, rollout, and
   the policy playouts hybrid, finite and full on a stub VP net) and for
   the VP search (ApproxPolicyIter, stub VP net, fixed uniforms): actions,
   traces, obs ids, visits and improvement counts must match exactly,
   values within rtol 1e-6 / atol 1e-5 (the VP priors, a softmax on each
   device, rtol 1e-6 / atol 1e-7); and the VV and VP nets' float32 forwards
   on the card against the CPU (rtol 1e-4; atol 1e-3 value and logits,
   1e-2 variance);
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
   move's harvest and store, and a save/load round trip;
11. cycle (lp, offline): the offline cycle through the CLI mains (`play`,
   `train`, `cycle`), in process, at the same width: `play --benchmark`
   for 20 moves without and then with `--save --save_tree --status_dir`
   (the saver's added host ms a move); the 1280 saved rows read back by
   `DataLoader` must equal the values the driver had on the card for one
   checked move, its boards the pre-move boards, the status memmaps game
   0's last published board, and select, insert and LP backup must each
   launch 2000 times in the saving run; `train --td --weighted
   --weighted_mode 1 --early_stopping --validation --save_loss` (at most
   2000 steps) on those rows writes a checkpoint and `loss0.rec`; `play
   --benchmark --load_model` for 5 moves (500 launches of each walk) must
   give outputs on fixed boards that differ from the seed net's; then
   `cycle --dry_run --iters 2` prints its plan;
12-13. vp, vp online: ApproxPolicyIter frozen (1 move after a warm-up;
   only the insert kernel launches) and online until a session
   (train_rows 500, train_max_iters 500), a VP train step on the card
   against the CPU;
14. playouts: HybridSim at 4 sims for 2 moves;
15. trained: 5 lp moves through `play --load_model` on the repo's JAX
   checkpoint, the loaded net on the card against the CPU;
16. dist: DistValueSim frozen at the CLI's width (50 atoms on [0, 1000],
   low 5) for 1 move after a warm-up: only the insert kernel launches,
   100 times; every visited obs's distribution sums to 1; two profiled
   moves of a 4-sim twin, scaled;
17. dist online: DistValueSim with training (cuts: train_rows 500,
   train_max_iters 500) until the move whose session ran: the stored
   target rows sum to 1 within 1e-3; a DistModel train step's device time
   and launches, and the step on the card against the CPU (TF32 on around
   it);
18. surface: at the CLI's width with 20 sims (cut from 100), 2 lp moves
   with both kernels, with `--select_kernel 0` and with `--insert_kernel
   0` (each bit-equal to the kernels' run in actions, every tree array and
   a select walk's traces), and under `--policy max` (only the insert
   kernel launches). The small phase also holds the dist move, an lp max
   move (vmax too) and `backup_exp_moving` / `backup_mixture` on the card
   against the CPU;
19. s2: ValueSim2 frozen at the CLI's width for 2 moves after a warm-up:
   only the insert kernel launches, 200 times; edges are recorded; two
   profiled moves of a 4-sim twin, scaled. The small phase holds 3 S2
   moves (B=4, pools of 128, a harvest and a reset) on the card against
   the CPU: integers, visits and the edge tables equal, values, vars and
   max_ret within rtol 1e-6 / atol 1e-5;
20-21. dqn, distdqn: `play --agent_type DQN` / `DistDQN` at the CLI's
   defaults (B=64, ring 100000, minibatch 32, target sync every 100) for
   300 moves with training through the CLI main (no walk kernel launches;
   every move trains; the checkpoint is written), a step's device time and
   launches, then 100 moves of `play --benchmark --load_model` (the saved
   net, greedy, nothing trained or stored). The small phase holds 10 steps
   of each head on the card against the CPU with shared draws (actions,
   envs and the ring equal, losses within rtol 1e-5), then one update in
   parts (loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 x the largest on
   a minibatch both devices agree on at every ReLU, Adam fed the card's
   gradients rtol 1e-6 / atol 1e-7).

Each path's launch counts are set to 0 just before it runs and read just
after; the `kernels` line gives each kernel's launches summed over the
paths (`launches`) and by path (`launches_by_path`). It then prints that
JSON `kernels` line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failure exits non-zero
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

WATCHDOG_S = 1100
ONLINE_MAX_ITERS = 2000  # the online phase's cut of train_max_iters (CLI: 50000)
ONLINE_MOVE_CAP = 80
CYCLE_MOVES, CYCLE_CHECKED_MOVE = 20, 10  # the cycle phase's play runs
CYCLE_TRAIN_ITERS = 2000  # the cycle phase's cut of train's --max_iters (CLI: 100000)
PROFILER_SESSIONS = 5  # device_ms's most sessions; each kernel row reports how many ran
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
FP32_FLOPS = 67e12         # H100 SXM published float32 rate outside the tensor cores
MOVES = 20
VP_MOVES = 1             # the vp phase's moves at the CLI width, after a warm-up
VP_PROFILE_SIMS = 4      # the vp profile's cut of the sims (a move issues ~330k
                         # kernels at 100 sims; profiling two took 486 s on the H100)
VP_ONLINE_ROWS = 500     # the vp online phase's cut of --train_rows (CLI: 5000)
VP_ONLINE_ITERS = 500    # ... and of --train_max_iters (CLI: 50000)
VP_ONLINE_MOVE_CAP = 30
VP_ONLINE_AFTER = 0      # moves after the first session, on the trained net
TRAINED_CKPT = "checkpoints/model_vv.msgpack"  # the JAX package's trained VV net
PLAYOUT_MOVES, PLAYOUT_SIMS = 2, 4
DIST_MOVES = 1             # the dist phase's moves at the CLI width, after a warm-up
DIST_PROFILE_SIMS = 4      # the dist profile's cut of the sims (as vp's)
DIST_ONLINE_ROWS = 500     # the dist online phase's cut of --train_rows (CLI: 5000)
DIST_ONLINE_ITERS = 500    # ... and of --train_max_iters (CLI: 50000)
DIST_ONLINE_MOVE_CAP = 30
DIST_ONLINE_AFTER = 0      # moves after the first session, on the trained net (~11 s each)
SURFACE_MOVES, SURFACE_SIMS = 2, 20  # the surface phase's lp runs (sims cut from 100)
S2_MOVES = 2               # the s2 phase's moves at the CLI width, after a warm-up
S2_PROFILE_SIMS = 4        # the s2 profile's cut of the sims (as vp's and dist's)
DQN_MOVES = 300            # the dqn phases' moves of `play` with training
DQN_BENCH_MOVES = 100      # ... and of `play --benchmark --load_model`
# a stand-in for the VP net: logits s x STUB_LOGIT from the board's cell sum s
STUB_LOGIT = (0.3, -0.2, 0.11, 0.05, -0.07, 0.17, -0.02)
# each path's kernel launches, recorded as the path runs (the kernels line)
PATH_LAUNCHES = {}
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
    """(ms, (sessions, seen)): the device time of one call's launches of
    `kernel` (its qualified name in csrc/, e.g. "tmt::select_kernel", or a
    tuple of names for a call that launches several kernels: their mean times
    a launch are summed): fn() is called reps times under torch.profiler, and
    the device-side time of the launches the profiler recorded is averaged.
    The host's time between launches is not counted. A session can record
    fewer launches than were made, at random: 7 of 20 in the last of three
    sessions in a row once, and 19, 5 and 0 of 20 in other runs on the H100
    (PERF.md §6). The calls are alike, so the mean over the recorded
    launches is the measure: a session that recorded at least half of reps
    of every kernel is taken at once, else up to PROFILER_SESSIONS sessions
    run and the one that recorded the most is taken. It raises when no
    session recorded a launch of every kernel, or one recorded more than
    reps. `sessions` is how many sessions ran, `seen` the fewest launches
    of a kernel the taken session recorded. Each kernel's own mean goes
    into the dict `parts` when one is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    best = None
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
        if max(seen.values()) > reps:
            raise AssertionError(f"{names}: profiler saw {seen} launches, more than {reps}")
        if best is None or min(seen.values()) > min(best[1].values()):
            best = (rows, seen)
        if min(seen.values()) >= reps // 2:
            break
        say(f"device_ms: profiler session {session + 1} saw {seen} launches of {reps}; "
            f"its device events: {[(e.key[:60], e.count) for e in events[:4]]}")
    rows, seen = best
    if min(seen.values()) == 0:
        raise AssertionError(f"{names}: profiler saw {seen} launches in the best of "
                             f"{session + 1} sessions, want {reps}")
    total = 0.0
    for name in names:
        ms = sum(e.self_device_time_total for e in rows[name]) / 1e3 / seen[name]
        if parts is not None:
            parts[name] = ms
        total += ms
    return total, (session + 1, min(seen.values()))


def stub_evaluator(x):
    """Deterministic stand-in for the net (the reference tests' linspace
    evaluator): v = linspace(1, 8), var = 2.5."""
    import torch

    n = x.shape[0]
    return (torch.linspace(1.0, 8.0, n, device=x.device),
            torch.full((n,), 2.5, device=x.device))


def stub_vp(x):
    """Deterministic stand-in for the VP net: from the board's cell sum s
    (an exact integer on either device), v = 0.5 s, logits s x STUB_LOGIT."""
    import torch

    s = x.sum(dim=(1, 2, 3))
    return 0.5 * s, s[:, None] * torch.tensor(STUB_LOGIT, device=x.device)


def phase_small(torch, mcts, T, evaluator, policy="clt"):
    """The move program on the card against the same program on the CPU,
    with the stub net (lp, leaf), fixed playout draws (rollout), or the
    stub VP net and fixed gumbels (the policy playouts, 4 sims); under
    `policy` (max: the plain select and backups, vmax compared too)."""
    import numpy as np

    playout = evaluator in mcts.POLICY_PLAYOUTS
    tcfg = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=16,
                        low=5 if evaluator == "rollout" else 1, policy=policy)
    scfg = mcts.SearchConfig(tree=tcfg, sims=4 if playout else 8, evaluator=evaluator,
                             rollout_cap=64)
    rng = np.random.RandomState(0)
    n_calls = 3 * scfg.sims
    planes = [torch.as_tensor(-np.log(rng.exponential(size=(4, 16, 7))), dtype=torch.float32)
              for _ in range(n_calls)]
    draws = torch.as_tensor(rng.randint(0, 7, (n_calls * scfg.rollout_cap, 4)))
    gumbels = torch.as_tensor(-np.log(rng.exponential(size=(n_calls * scfg.rollout_cap, 4, 7))),
                              dtype=torch.float32)
    zeros = torch.zeros(4, 16, 7)
    results = {}
    for dev in ("cuda", "cpu"):
        feed = iter(planes)
        src = lambda B, D, dev=dev: (next(feed).to(dev), zeros.to(dev))
        acts = iter(draws)
        draw = lambda B, step, dev=dev: next(acts).to(dev)
        gums = iter(gumbels)
        gumbel = lambda B, step, dev=dev: next(gums).to(dev)
        if playout:
            ev = mcts.policy_rollout_evaluator(stub_vp, scfg, mcts.playout_depth(scfg),
                                               mcts.POLICY_PLAYOUTS[evaluator][1], gumbel)
        else:
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
    if policy != "clt":
        evaluator = f"{evaluator}, {policy}"
        if not float(ct.vmax.max()) > 0:
            raise AssertionError(f"small[{evaluator}]: no vmax was backed up")
        close(f"small[{evaluator}] vmax", gt.vmax, ct.vmax, False)
    if playout and float(gt.vars_.max()) < 100.0:
        raise AssertionError(f"small[{evaluator}]: no playout variance was backed up")
    close(f"small[{evaluator}] actions", ga, ca, True)
    close(f"small[{evaluator}] envs", ge, ce, True)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits",
              "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        close(f"small[{evaluator}] {f}", getattr(gt, f), getattr(ct, f), True)
    return max(close(f"small[{evaluator}] values", gt.values, ct.values, False),
               close(f"small[{evaluator}] vars", gt.vars_, ct.vars_, False))


def dist_stub(x):
    """Deterministic stand-in for the distributional net: 16 bins weighted
    (s + 3 b) mod 5 + 1 from the board's cell sum s, normalised."""
    import torch

    w = torch.remainder(x.sum(dim=(1, 2, 3))[:, None]
                        + 3 * torch.arange(16, device=x.device), 5.0) + 1.0
    return w / w.sum(1, keepdim=True)


def phase_small_dist(torch, mcts, T):
    """The DistValueSim move program on the card (insert kernel) against the
    CPU, with the stub distributional net and fixed gumbels, 4 moves at B=4
    (pools of 128, so a harvest is stored): actions, env states, the trees'
    integer arrays, visits and the ring's boards and weights equal; values
    and m2 within rtol 1e-6 / atol 1e-5, the distributions and the ring's
    target rows within rtol 1e-6 / atol 1e-6."""
    import numpy as np

    from tetris_mcts_tpu_torch.search import distributional as DD

    scfg = mcts.SearchConfig(tree=T.TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                               max_depth=16, low=5), sims=8)
    dcfg = DD.DistConfig(atoms=16, vmax=200.0)
    rng = np.random.RandomState(2)
    planes = torch.as_tensor(-np.log(rng.exponential(size=(4 * scfg.sims, 4, 16, 7))),
                             dtype=torch.float32)

    class Gumbels:
        def __init__(self, dev):
            self.feed, self.dev = iter(planes), dev

        def level_gumbels(self, B, D):
            return next(self.feed).to(self.dev)

    results = {}
    for dev in ("cuda", "cpu"):
        move = DD.make_dist_move_fn(dist_stub, scfg, dcfg, Gumbels(dev), min_visits_store=1)
        dts, envs = DD.init_dist_batch(7, 4, scfg, dcfg, device=dev)
        rep = DD.init_dist_replay(256, 16, dev)
        out = []
        for _ in range(4):
            envs, st = move(dts, envs, rep)
            out.append(torch.stack([st.action.float(), *st.probs.T]))
        results[dev] = (torch.stack(out), dts, envs, rep)
    gm, gt, ge, grep = results["cuda"]
    cm, ct, ce, crep = results["cpu"]
    close("small[dist] actions and visit policies", gm, cm, True)
    close("small[dist] envs", ge, ce, True)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits",
              "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        close(f"small[dist] {f}", getattr(gt.base, f), getattr(ct.base, f), True)
    if int(grep.total) == 0 or int(grep.total) != int(crep.total):
        raise AssertionError("small[dist]: nothing was stored, or the rings' counts differ")
    gb, gd, gw = grep.rows()
    cb, cd, cw = crep.rows()
    close("small[dist] ring boards", gb, cb, True)
    close("small[dist] ring weights", gw, cw, True)
    return max(close("small[dist] values", gt.base.values, ct.base.values, False),
               close("small[dist] m2", gt.obs_m2, ct.obs_m2, False),
               close("small[dist] distributions", gt.obs_dist, ct.obs_dist, False, 1e-6, 1e-6),
               close("small[dist] ring targets", gd, cd, False, 1e-6, 1e-6))


def phase_small_backups(torch, mcts, T):
    """The alternative backups (`tree.backup_exp_moving`, `backup_mixture`,
    plain torch on either device) on the card against the CPU, from grown
    lp trees of B=4: visits equal, values and vars within rtol 1e-6 / atol
    1e-5."""
    import numpy as np

    from tetris_mcts_tpu_torch.ops import tree_walk

    tcfg = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=16)
    scfg = mcts.SearchConfig(tree=tcfg, sims=8)
    move = mcts.make_move_fn(mcts.nn_child_evaluator(stub_evaluator), scfg,
                             mcts.TorchPlanes(3, "cpu"))
    trees, envs = mcts.init_batch(9, 4, scfg, device="cpu")
    for _ in range(2):
        envs, _ = move(trees, envs)
    traces, lengths = tree_walk.select_walk_plain(trees, *mcts.TorchPlanes(4, "cpu")(4, 16),
                                                  tcfg)[:2]
    rng = np.random.RandomState(5)
    v0 = torch.as_tensor(rng.uniform(0, 60, 4), dtype=torch.float32)
    var0 = torch.as_tensor(rng.uniform(0.5, 30, 4), dtype=torch.float32)
    err = 0.0
    for kind in ("exp_moving", "mixture"):
        fn = getattr(T, f"backup_{kind}")
        tc = trees.clone()
        tg = T.Tree(**{f: getattr(trees, f).cuda() for f in trees.__dataclass_fields__})
        fn(tc, traces, lengths, v0, var0, tcfg)
        fn(tg, traces.cuda(), lengths.cuda(), v0.cuda(), var0.cuda(), tcfg)
        close(f"small[backup_{kind}] visits", tg.visits, tc.visits, True)
        err = max(err, close(f"small[backup_{kind}] values", tg.values, tc.values, False),
                  close(f"small[backup_{kind}] vars", tg.vars_, tc.vars_, False))
    return err


def phase_small_s2(torch, mcts, T):
    """The ValueSim2 move program on the card (insert kernel) against the
    CPU, with the linspace stub net, 3 moves at B=4 (pools of 128: the
    second move harvests, stores and resets every tree): actions,
    edge-count policies, env states, the trees' integer arrays, visits, the
    edge tables and the ring's boards and weights equal; values, vars,
    max_ret and the ring's values and variances within rtol 1e-6 / atol
    1e-5."""
    from tetris_mcts_tpu_torch.search import stochastic as ST

    scfg = mcts.SearchConfig(tree=T.TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                               max_depth=16), sims=8)
    results = {}
    for dev in ("cuda", "cpu"):
        move = ST.make_s2_move_fn(stub_evaluator, scfg, min_visits_store=1)
        s2, envs = ST.init_s2_batch(7, 4, scfg, device=dev)
        rep = mcts.init_replay(256, dev)
        out = []
        for _ in range(3):
            envs, st = move(s2, envs, rep)
            out.append(torch.stack([st.action.float(), *st.probs.T]))
        results[dev] = (torch.stack(out), s2, envs, rep)
    gm, gt, ge, grep = results["cuda"]
    cm, ct, ce, crep = results["cpu"]
    close("small[s2] actions and edge-count policies", gm, cm, True)
    close("small[s2] envs", ge, ce, True)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits",
              "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        close(f"small[s2] {f}", getattr(gt.base, f), getattr(ct.base, f), True)
    for f in ("edge_child", "edge_count", "edge_dscore"):
        close(f"small[s2] {f}", getattr(gt, f), getattr(ct, f), True)
    if not float(gt.edge_count.sum()) > 0 or int(grep.total) == 0 or int(grep.total) != int(
            crep.total):
        raise AssertionError("small[s2]: no edge recorded or nothing stored, or the rings' "
                             "counts differ")
    gb, gv, gvar, gw = grep.rows()
    cb, cv, cvar, cw = crep.rows()
    close("small[s2] ring boards", gb, cb, True)
    close("small[s2] ring weights", gw, cw, True)
    return max(close("small[s2] values", gt.base.values, ct.base.values, False),
               close("small[s2] vars", gt.base.vars_, ct.base.vars_, False),
               close("small[s2] max_ret", gt.max_ret, ct.max_ret, False),
               close("small[s2] ring values", gv, cv, False),
               close("small[s2] ring vars", gvar, cvar, False))


def phase_small_dqn(torch, distributional):
    """10 steps of the DQN agent (B=8, a ring of 64 rows that wraps,
    minibatch 16, target sync every 4) on the card against the CPU from the
    same weights, fed the same draws: actions, env states and the ring
    equal every step, the losses within rtol 1e-5 / atol 1e-7. Then one
    update of the card's state against the CPU's on a minibatch both
    devices agree on at every ReLU (`dqn_update_on_two_devices`): the loss
    within rtol 1e-5, the gradients within rtol 1e-4 / atol 1e-5 x each
    tensor's largest, and Adam on the CPU fed the card's gradients within
    rtol 1e-6 / atol 1e-7 of the card's step. (The nets are not compared
    after the 10 steps: Adam turns a gradient's rounding difference near
    zero into an update of up to its learning rate.) Returns the float max
    abs err."""
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.runtime import dqn as D

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_train_cases import dqn_update_on_two_devices

    cfg = D.DQNConfig(batch=8, memory_size=64, train_batch=16, target_update_steps=4, seed=3,
                      distributional=distributional)
    rng = np.random.RandomState(6)
    steps = 10
    draws = [(rng.rand(cfg.batch).astype(np.float32), rng.randint(0, 7, cfg.batch),
              rng.randint(0, min((k + 1) * cfg.batch, cfg.memory_size), cfg.train_batch))
             for k in range(steps)]
    runs = {}
    for dev in ("cuda", "cpu"):
        d = D.DQNDriver(cfg, device=dev, log=lambda s: None)
        feed = iter(draws)
        d.draws = lambda feed=feed, dev=dev: D.DQNDraws(
            *(torch.as_tensor(x, device=dev) for x in next(feed)))
        out = [(st.action, st.loss, d.envs, *(a.clone() for a in d.replay.arrays()))
               for st in (d.step() for _ in range(steps))]
        runs[dev] = (d, out)
    (g, gout), (c, cout) = runs["cuda"], runs["cpu"]
    name = "distdqn" if distributional else "dqn"
    err = 0.0
    for k, (go, co) in enumerate(zip(gout, cout)):
        close(f"small[{name}] step {k} actions", go[0], co[0], True)
        err = max(err, close(f"small[{name}] step {k} loss", go[1], co[1], False, 1e-5, 1e-7))
        for n, a, b in zip(("envs", "si", "a", "r", "sf", "end"), go[2:], co[2:]):
            close(f"small[{name}] step {k} {n}", a, b, True)
    if not (g.updates == c.updates == steps and g.episodes == c.episodes):
        raise AssertionError(f"small[{name}]: the drivers' counters differ")
    up = dqn_update_on_two_devices(g)
    err = max(err, close(f"small[{name}] update loss", up["card"][0], up["cpu"][0], False,
                         1e-5, 0.0))
    for n, a, b in zip(g.names, up["card"][1], up["cpu"][1]):
        err = max(err, close(f"small[{name}] update grad {n}", a, b, False, 1e-4,
                             1e-5 * float(b.abs().max())))
    for n, a, b in zip(g.names, *up["params"]):
        err = max(err, close(f"small[{name}] Adam step {n}", a, b, False, 1e-6, 1e-7))
    return err


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


def phase_small_vp(torch, mcts, T):
    """The VP move program (ApproxPolicyIter) on the card against the CPU,
    with the stub VP net and fixed uniforms: actions, root policies, env
    states, the trees' integer arrays, visits and improvement counts equal,
    values within rtol 1e-6 / atol 1e-5, priors within rtol 1e-6 / atol
    1e-7; then one more select walk on the final trees gives equal traces.
    Returns (float max abs err, the select levels of the last move)."""
    import numpy as np

    from tetris_mcts_tpu_torch.search import vp as VP

    # pools of 128: the trees fill on the second move, so a harvest is stored
    tcfg = T.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=16)
    scfg = mcts.SearchConfig(tree=tcfg, sims=8)
    rng = np.random.RandomState(1)
    planes = torch.as_tensor(rng.rand(3 * scfg.sims + 1, 4, 16), dtype=torch.float32)

    class Uniforms:
        def __init__(self, dev):
            self.feed, self.dev = iter(planes), dev

        def uniforms(self, B, D):
            return next(self.feed).to(self.dev)

    results = {}
    for dev in ("cuda", "cpu"):
        src = Uniforms(dev)
        move = VP.make_vp_move_fn(stub_vp, scfg, src, min_visits_store=2)
        vts, envs = VP.init_vp_batch(7, 4, scfg, device=dev)
        rep = VP.init_vp_replay(256, dev)
        out = []
        for _ in range(3):
            envs, st = move(vts, envs, rep)
            out.append(torch.stack([st.action.float(), *st.probs.T]))
        sel = VP.select_batched(vts, next(src.feed).to(dev), tcfg)
        results[dev] = (torch.stack(out), vts, envs, sel, rep, move.levels)
    gm, gt, ge, gsel, grep, levels = results["cuda"]
    cm, ct, ce, csel, crep, _ = results["cpu"]
    close("small[vp] actions and root policies", gm, cm, True)
    close("small[vp] envs", ge, ce, True)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits",
              "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        close(f"small[vp] {f}", getattr(gt.base, f), getattr(ct.base, f), True)
    close("small[vp] pol_new", gt.pol_new, ct.pol_new, True)
    for n, a, b in zip(("traces", "actions", "lengths"), gsel[:3], csel[:3]):
        close(f"small[vp] select {n}", a, b, True)
    for a, b in zip(grep.rows(), crep.rows()):
        close("small[vp] ring rows", a, b, a.dtype == torch.int32)
    if not float(gt.pol_new.sum()) > 0 or int(grep.total) == 0 or int(grep.total) != int(
            crep.total):
        raise AssertionError("small[vp]: nothing was backed up or stored, or the rings' "
                             "counts differ")
    err = max(close("small[vp] values", gt.base.values, ct.base.values, False),
              close("small[vp] priors", gt.prior, ct.prior, False, rtol=1e-6, atol=1e-7))
    return err, levels


def phase_net_vp(torch):
    """The VP net's float32 forward on the card against the CPU, same
    weights (from seed 5), on 448 random boards."""
    import numpy as np

    from tetris_mcts_tpu_torch.train.trainer import VPModel

    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randint(-1, 2, (448, 1, 20, 10)).astype(np.float32))
    v_c, l_c = VPModel(seed=5, device="cpu").apply_fn()(x)
    v_g, l_g = VPModel(seed=5, device="cuda").apply_fn()(x.cuda())
    return (close("vp net value", v_g, v_c, False, rtol=1e-4, atol=1e-3),
            close("vp net logits", l_g, l_c, False, rtol=1e-4, atol=1e-3))


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


def record(path, launches):
    """Keep a path's launch counts for the kernels line."""
    PATH_LAUNCHES[path] = dict(launches)
    return launches


def check_launches(path, got, want):
    """Every kernel's launches on `path` equal want.get(name, 0)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)}")


def drive(torch, cfg, moves, log, cls=None):
    """The driver `cls` (default SelfPlayDriver) for cfg on the card: one
    warm-up move, then `moves` moves with the launch counts set to 0 just
    before and read just after. Returns (driver, wall seconds of the moves,
    launches)."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayDriver

    driver = (cls or SelfPlayDriver)(cfg, device="cuda", log=log)
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
    if not hasattr(st, "child_stats"):  # the VP and distributional moves
        if not bool(torch.allclose(st.probs.sum(1), torch.ones_like(st.probs[:, 0]))):
            raise AssertionError(f"{cfg.evaluator} path: a root policy that is not a "
                                 "distribution")
    elif not bool((st.child_stats[:, 0].sum(1) > 0).all()):
        raise AssertionError(f"{cfg.evaluator} path: a root without visits")
    return driver, wall, launches


def report_episode(driver, episodes):
    st = driver.last_stats
    if episodes:
        say(f"episode line: {episodes[-1]}")
    else:  # games outlast the run: game 0 so far, in the Episode format
        say(f"episode line (game 0, live): Episode:     -  Score:{int(st.score[0]):10d}  "
            f"Lines Cleared:{int(st.lines[0]):5d}")


def report_profile(torch, driver, wall, moves, label, scale=1.0):
    """Two profiled moves of `driver`: device time by kernel against the
    wall time a move of the unprofiled run. `scale` multiplies the profiled
    moves' times and launches (a twin with fewer sims, scaled to the run's)."""
    t = time.perf_counter()
    busy_ms, prof_rows = profile_moves(torch, driver, 2)
    busy_ms *= scale
    per_move_ms = wall / moves * 1e3
    say(f"phase profile ({label}): device kernel time {busy_ms / 2:.2f} ms per move "
        f"against {per_move_ms:.2f} ms wall per move unprofiled (device busy share "
        f"{busy_ms / 2 / per_move_ms:.3f}); top device kernels:")
    # the twelve largest, and the port's own kernels wherever they rank
    for name, ms, n in prof_rows[:12] + [r for r in prof_rows[12:] if r[0].startswith("tmt")]:
        say(f"  {ms * scale / 2:9.3f} ms/move  {int(n * scale) // 2:6d} launches/move  "
            f"{name[:90]}")
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
    small_err["vp"], vp_levels = phase_small_vp(torch, mcts, T)
    small_err["lp, max"] = phase_small(torch, mcts, T, "lp", policy="max")
    small_err["dist"] = phase_small_dist(torch, mcts, T)
    small_err["backup_exp_moving, backup_mixture"] = phase_small_backups(torch, mcts, T)
    small_err["s2"] = phase_small_s2(torch, mcts, T)
    small_err["dqn, 10 steps"] = phase_small_dqn(torch, False)
    small_err["distdqn, 10 steps"] = phase_small_dqn(torch, True)
    net_err = phase_net(torch)
    vp_net_err = phase_net_vp(torch)
    say(f"phase small: 3 moves x 8 sims (4 for the playouts) at B=4 equal on cuda and cpu "
        f"for " + ", ".join(f"{ev} (float max abs err {e:.3e})" for ev, e in small_err.items())
        + f" (vp select levels of the last move {vp_levels}); VV net float32 on cuda vs cpu "
        f"max abs err value {net_err[0]:.3e}, variance {net_err[1]:.3e}; VP net value "
        f"{vp_net_err[0]:.3e}, logits {vp_net_err[1]:.3e}; in {time.perf_counter() - t:.1f}s")

    # ---- 4. main path (lp) --------------------------------------------------
    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True)  # the CLI's default width, frozen net
    episodes = []
    driver, wall, launches = drive(torch, cfg, MOVES, episodes.append)
    record("lp", launches)
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
    record("leaf", leaf_launches)
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
    record("rollout", r_launches)
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
    fwd_launches = record("forward", read_launches())
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
    bw_launches = record("bench walk", read_launches())
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

    # ---- 11. the offline cycle through the CLI mains -------------------------
    phase_cycle(torch, smi)

    # ---- 12-13. ApproxPolicyIter, frozen and online ---------------------------
    phase_vp(torch, smi)
    phase_vp_online(torch, smi)

    # ---- 14. the policy playouts (HybridSim) -----------------------------------
    phase_playouts(torch, smi)

    # ---- 15. lp moves with the repo's trained VV net of the JAX package ---------
    phase_trained(torch, smi)

    # ---- 16-17. DistValueSim, frozen and online ---------------------------------
    phase_dist(torch, smi)
    phase_dist_online(torch, smi)

    # ---- 18. the VV surface: --policy max, --select_kernel 0, --insert_kernel 0 --
    phase_surface(torch, smi)

    # ---- 19. ValueSim2 ---------------------------------------------------------
    phase_s2(torch, smi)

    # ---- 20-21. DQN and DistDQN --------------------------------------------------
    phase_dqn(torch, smi, "DQN")
    phase_dqn(torch, smi, "DistDQN")

    def by_path(name):
        return {p: c[name] for p, c in PATH_LAUNCHES.items() if c.get(name)}

    kernels = [{
        "name": name, "route": "cuda",
        "source": f"tetris_mcts_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": sum(by_path(name).values()),
        "launches_by_path": by_path(name), "max_abs_err": err,
        "ms": ms_k, "call_ms": ev_k, "plain_ms": ms_p,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": ms_lib,
        "profiler_sessions": tries[0], "profiler_launches_seen": tries[1],
    } for (name, src, replaces, _, err, ms_k, ev_k, ms_p, bound, bound_by,
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
        launches = record("online", read_launches())
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


def phase_cycle(torch, smi):
    """The offline cycle through the CLI mains, in process, at the CLI's
    width: self-play with the saver against without it, the saved rows
    against the driver's device values, an offline session on those rows,
    self-play with the trained net, and the cycle's plan."""
    import tempfile

    import numpy as np

    from tetris_mcts_tpu_torch.cli import cycle, play, train
    from tetris_mcts_tpu_torch.env import engine
    from tetris_mcts_tpu_torch.obs.metrics import StatusPublisher, StatusReader
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayDriver
    from tetris_mcts_tpu_torch.search import tree as T
    from tetris_mcts_tpu_torch.train.trainer import VVModel
    from tetris_mcts_tpu_torch.utils.data import DataLoader, DataSaver, LossLoader

    t = time.perf_counter()
    step, columns, publish, train_data = (SelfPlayDriver.step, SelfPlayDriver._publish_columns,
                                          SelfPlayDriver._publish, VVModel.train_data)
    status_publish, add_batch = StatusPublisher.publish, DataSaver.add_batch
    times, columns_s, publish_s, seen, session = [], [], [], {}, {}
    part_s = {"status": [], "write": []}

    def timed(fn, key):
        def f(*a, **k):
            t0 = time.perf_counter()
            fn(*a, **k)
            part_s[key].append(time.perf_counter() - t0)
        return f

    def timed_step(self):
        t0 = time.perf_counter()
        prev = self.envs
        st = step(self)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == CYCLE_CHECKED_MOVE + 1 and self.saver is not None:
            seen.update(envs=prev, post=self.envs, stats=st)
        if len(times) == CYCLE_MOVES - 1 and self.saver is not None:
            # every tree resets on move 20 at this width (a tree fills its
            # pool in 5 moves), so the dump at the end is empty: dump here
            seen["dump"] = os.path.join(os.path.dirname(self.saver.path), "tree_move19.npz")
            self.save_nodes(seen["dump"])
            seen["harvested"] = int(T.harvest(self.trees, 1)[4].sum())
        return st

    def timed_columns(self, *a):
        t0 = time.perf_counter()
        cols = columns(self, *a)
        columns_s.append(time.perf_counter() - t0)
        return cols

    def timed_publish(self, *cols):
        t0 = time.perf_counter()
        publish(self, *cols)
        publish_s.append(time.perf_counter() - t0)

    def timed_train_data(self, *a, **k):
        t0 = time.perf_counter()
        hist = train_data(self, *a, **k)
        session.update(seconds=time.perf_counter() - t0, iters=hist[-1][0] if hist else 0)
        return hist

    def host_ms(xs):
        return float(np.median(xs[1:])) * 1e3  # the first move also builds and tunes

    def med_ms(xs):
        return float(np.median(xs)) * 1e3

    SelfPlayDriver.step, SelfPlayDriver._publish = timed_step, timed_publish
    SelfPlayDriver._publish_columns = timed_columns
    StatusPublisher.publish = timed(status_publish, "status")
    DataSaver.add_batch = timed(add_batch, "write")
    VVModel.train_data = timed_train_data
    try:
        with tempfile.TemporaryDirectory() as tmp:
            data, status = os.path.join(tmp, "data"), os.path.join(tmp, "status")
            ckpt = os.path.join(tmp, "ck", "model.pt")
            base = ["--agent_type", "ValueSimLP", "--benchmark", "--checkpoint", ckpt]
            times.clear()
            reset_launches()
            sims = play.main(base + ["--max_moves", str(CYCLE_MOVES)]).cfg.sims
            check_launches("cycle play (no saver)", record("cycle play", read_launches()),
                           {k: CYCLE_MOVES * sims for k in
                            ("select_walk", "insert7_walk", "lp_backup_walk")})
            plain = list(times)
            times.clear()
            reset_launches()
            t_run = time.perf_counter()
            driver = play.main(base + ["--max_moves", str(CYCLE_MOVES), "--save", "--save_dir",
                                       data, "--save_tree", "--status_dir", status])
            run_s = time.perf_counter() - t_run
            launches = record("cycle play --save", read_launches())
            want = CYCLE_MOVES * driver.cfg.sims
            check_launches("cycle play --save", launches,
                           {"select_walk": want, "insert7_walk": want, "lp_backup_walk": want})
            saving = list(times)
            B = driver.cfg.batch
            rows = DataLoader(os.path.join(data, "data0.rec"))
            if len(rows) != CYCLE_MOVES * B:
                raise AssertionError(f"cycle: {len(rows)} saved rows, want {CYCLE_MOVES * B}")
            # the checked move's rows against what the driver had on the card
            m = slice(CYCLE_CHECKED_MOVE * B, (CYCLE_CHECKED_MOVE + 1) * B)
            pre, post = (engine.unpack_state(seen[k]) for k in ("envs", "post"))
            st = seen["stats"]
            want_cols = {
                "board": engine.get_state(pre), "combo": pre.combo, "score": pre.score,
                "lines": pre.lines, "line_stats": pre.line_stats, "policy": st.probs,
                "action": st.action, "child_stats": st.child_stats, "value": st.root_value,
                "variance": st.root_var}
            for k, x in want_cols.items():
                got = torch.as_tensor(getattr(rows, k)[m])
                if not torch.equal(got, x.cpu().to(got.dtype)):
                    raise AssertionError(f"cycle: saved {k} of move {CYCLE_CHECKED_MOVE} differs "
                                         "from the driver's values on the card")
            if np.array_equal(rows.board[m], engine.get_state(post).cpu().numpy()):
                raise AssertionError("cycle: the saved boards are the post-move boards")
            if not (np.array_equal(rows.episode[:B], np.arange(B))
                    and (rows.cycle == 0).all()):
                raise AssertionError("cycle: episode ids or cycle column wrong")
            live = StatusReader(status, batch=B).read()
            if live is None or not np.array_equal(live["board"], rows.board[-B]):
                raise AssertionError("cycle: the status board is not game 0's last board")
            n_dump = []
            for path in (os.path.join(data, "tree0.npz"), seen["dump"]):
                dump = np.load(path)
                n_dump.append(len(dump["game"]))
                if (set(dump.files) != {"board", "value", "variance", "visit", "game"}
                        or dump["board"].shape != (n_dump[-1], 20, 10)
                        or not (dump["visit"] >= 1).all()
                        or not np.isfinite(dump["value"]).all()):
                    raise AssertionError(f"cycle: the tree dump {path} is malformed")
            if n_dump[1] != seen["harvested"] or not n_dump[1]:
                raise AssertionError(f"cycle: the move-19 dump holds {n_dump[1]} nodes, the "
                                     f"trees {seen['harvested']}")
            add_ms = host_ms(saving) - host_ms(plain)
            own_ms = float(np.median(np.add(columns_s, publish_s))) * 1e3
            say(f"phase cycle (lp, offline): play --save at B={B}, {driver.cfg.sims} sims: "
                f"{len(rows)} rows over {CYCLE_MOVES} moves read back equal (move "
                f"{CYCLE_CHECKED_MOVE}: pre-move boards, counters, policy, action, child_stats, "
                f"value, variance as on the card); launches {launches}; tree dump "
                f"{n_dump[0]} nodes at the end, {n_dump[1]} after move 19 (= the trees' "
                f"observations with a visit); status board = game 0's last ({smi})")
            say(f"  saver: {add_ms:.3f} ms of host time added a move (median move "
                f"{host_ms(saving):.3f} ms with --save vs {host_ms(plain):.3f} ms without, "
                f"two runs); its own host code {own_ms:.3f} ms a move (medians: issuing its "
                f"columns {med_ms(columns_s):.3f}, the host side {med_ms(publish_s):.3f}, of "
                f"it the record write {med_ms(part_s['write']):.3f} and the status memmaps "
                f"{med_ms(part_s['status']):.3f}, the rest the unpacking; the shared read "
                f"aside); {len(rows) / run_s:.1f} rows/s over the saving run's {run_s:.2f}s, "
                f"{len(rows) / (sum(publish_s) + sum(columns_s)):.1f} rows/s through its own "
                "code")

            # the offline session on those rows, on the card
            loss_dir = os.path.join(tmp, "loss")
            t_train = time.perf_counter()
            hist = train.main(["--device", "cuda", "--data", os.path.join(data, "data*.rec"),
                               "--td", "--weighted", "--weighted_mode", "1", "--early_stopping",
                               "--validation", "--save_loss", loss_dir, "--max_iters",
                               str(CYCLE_TRAIN_ITERS), "--checkpoint", ckpt, "--dump_dir",
                               os.path.join(tmp, "dump")])
            train_s = time.perf_counter() - t_train
            loss = LossLoader(os.path.join(loss_dir, "loss0.rec"))
            if not os.path.isfile(ckpt) or loss.n != len(hist) or not hist:
                raise AssertionError("cycle: train wrote no checkpoint or no loss0.rec")
            if not all(np.isfinite(h[1]) and np.isfinite(h[2]) for h in hist):
                raise AssertionError("cycle: non-finite losses in the session")
            say(f"  train: {session['iters']} steps in {session['seconds']:.2f}s of session "
                f"({session['iters'] / session['seconds']:.1f} steps/s; cap "
                f"{CYCLE_TRAIN_ITERS}), {train_s:.2f}s for the command; last window loss "
                f"train {hist[-1][1]:.4f} val {hist[-1][2]:.4f}; loss0.rec {loss.n} rows ({smi})")

            # self-play with the trained net
            fixed = torch.as_tensor(np.random.RandomState(11).randint(-1, 2, (64, 1, 20, 10)),
                                    dtype=torch.float32, device="cuda")
            seed_out = VVModel(0, "cuda").apply_fn()(fixed)
            reset_launches()
            trained = play.main(base + ["--max_moves", "5", "--load_model"])
            check_launches("cycle play --load_model",
                           record("cycle play --load_model", read_launches()),
                           {k: 5 * trained.cfg.sims for k in
                            ("select_walk", "insert7_walk", "lp_backup_walk")})
            change = max(float((a - b).abs().max())
                         for a, b in zip(trained.model.apply_fn()(fixed), seed_out))
            if not change > 0:
                raise AssertionError("cycle: the loaded net's outputs equal the seed net's")
            say(f"  play --load_model: 5 moves, {5 * trained.cfg.sims} launches of each walk; "
                f"outputs on 64 fixed boards moved by up to {change:.4f} from the seed net's")
            cycle.main(["--dry_run", "--iters", "2", "--data_dir", os.path.join(tmp, "cyc"),
                        "--device", "cuda", "--checkpoint", ckpt])
    finally:
        SelfPlayDriver.step, SelfPlayDriver._publish = step, publish
        SelfPlayDriver._publish_columns = columns
        StatusPublisher.publish, DataSaver.add_batch = status_publish, add_batch
        VVModel.train_data = train_data
    say(f"phase cycle took {time.perf_counter() - t:.1f}s")


def phase_vp(torch, smi):
    """ApproxPolicyIter with a frozen net at the CLI's width: the insert
    walk launches moves x sims times, no other walk launches; then two
    profiled moves."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, VPSelfPlayDriver

    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True, evaluator="vp")
    driver, wall, launches = drive(torch, cfg, VP_MOVES, lambda s: None, VPSelfPlayDriver)
    record("vp", launches)
    check_launches("vp path", launches, {"insert7_walk": VP_MOVES * cfg.sims})
    levels = driver._move.levels
    say(f"phase vp (ApproxPolicyIter, frozen): {VP_MOVES} moves x {cfg.sims} sims at "
        f"B={cfg.batch} in {wall:.2f}s: {wall / VP_MOVES * 1e3:.1f} ms wall a move, "
        f"{VP_MOVES * cfg.batch * cfg.sims / wall:.1f} sims/s ({smi}); launches {launches}; "
        f"select levels a sim in the last move: mean {sum(levels) / len(levels):.2f}, max "
        f"{max(levels)}; mean nodes {driver.trees.n_nodes.float().mean().item():.0f}")
    say(f"phase vp took {time.perf_counter() - t:.1f}s")
    twin = VPSelfPlayDriver(cfg._replace(sims=VP_PROFILE_SIMS), device="cuda",
                            log=lambda s: None)
    twin.step()  # warm-up
    torch.cuda.synchronize()
    report_profile(torch, twin, wall, VP_MOVES, f"vp, {VP_PROFILE_SIMS} sims a move scaled "
                   f"to {cfg.sims}", scale=cfg.sims / VP_PROFILE_SIMS)


def phase_vp_online(torch, smi):
    """ApproxPolicyIter with training at the CLI's width until a session has
    run and VP_ONLINE_AFTER moves more; then one VP train step on the card
    against the CPU with TF32 switched on around it, and a step's device
    time."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.obs.metrics import MetricsReader, MetricsWriter
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, VPSelfPlayDriver
    from tetris_mcts_tpu_torch.train.trainer import VPModel

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_train_cases import agreeing_minibatch

    t = time.perf_counter()
    cfg = SelfPlayConfig(evaluator="vp", train_rows_trigger=VP_ONLINE_ROWS,
                         train_max_iters=VP_ONLINE_ITERS)
    cuts = (f"cuts: train_rows {VP_ONLINE_ROWS} (CLI 5000), train_max_iters "
            f"{VP_ONLINE_ITERS} (CLI 50000), at most {VP_ONLINE_MOVE_CAP} moves")
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.jsonl")
        metrics = MetricsWriter(mpath)
        driver = VPSelfPlayDriver(cfg, device="cuda", log=lambda s: None, metrics=metrics)
        model = driver.model
        fixed = torch.as_tensor(np.random.RandomState(11).randint(-1, 2, (64, 1, 20, 10)),
                                dtype=torch.float32, device="cuda")
        before = model.apply_fn()(fixed)
        moves, session_move = 0, None
        reset_launches()
        t_run = time.perf_counter()
        while moves < VP_ONLINE_MOVE_CAP:
            driver.step()
            moves += 1
            if session_move is None and driver.n_trains:
                session_move = moves
            if session_move is not None and moves - session_move >= VP_ONLINE_AFTER:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = record("vp online", read_launches())
        metrics.close()
        if session_move is None:
            raise AssertionError(f"vp online: no training session in {moves} moves "
                                 f"({driver._prev_total} rows harvested; {cuts})")
        check_launches("vp online path", launches, {"insert7_walk": moves * cfg.sims})
        change = max(float((a - b).abs().max()) for a, b in zip(model.apply_fn()(fixed), before))
        if not change > 0:
            raise AssertionError("vp online: the net's outputs did not change in training")
        reader = MetricsReader(mpath)
        reader.poll()
        sessions = reader.of_kind("train_session")
        say(f"phase vp online (ApproxPolicyIter, training): {moves} moves x {cfg.sims} sims at "
            f"B={cfg.batch} in {wall:.2f}s, the first session after move {session_move}; "
            f"launches {launches}; {driver._prev_total} rows harvested; net outputs on 64 fixed "
            f"boards moved by up to {change:.4f} ({smi}; {cuts})")
        for e in sessions:
            say(f"  session {e['n']}: {e['rows']} rows, {e['iters']} steps in {e['seconds']:.2f}s "
                f"({e['iters'] / e['seconds']:.1f} steps/s), loss train {e['loss_train']:.4f} "
                f"val {e['loss_val']:.4f}")

        # a train step's device time and launches at batch 128
        rows = min(4096, driver.replay.count.item())
        newest = (np.arange(driver.replay.idx.item() - rows, driver.replay.idx.item())
                  % cfg.memory_size)
        states, value, pol, weight = driver._training_columns(newest)
        cols = [states.float()[:, None], value, pol, weight / weight.mean()]
        sd = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
        mu, nu, nu_max, count = model.opt.state()

        def copy_of(dev):
            m = VPModel(seed=cfg.seed, device=dev)
            m.load_state({k: v.to(dev) for k, v in sd.items()})
            m.opt.load(*([x.to(dev) for x in xs] for xs in (mu, nu, nu_max)), count)
            return m

        prof_m = copy_of("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        idxs = iter([torch.randint(0, rows, (cfg.train_batch,), generator=gen, device="cuda")
                     for _ in range(43)])
        step = lambda: prof_m.train_step(cols, next(idxs))
        for _ in range(3):
            step()
        step_ms, step_launches = device_ms_all(step, 20)
        step_call_ms = cuda_ms(step, 20)
        say(f"  VP train_step at batch {cfg.train_batch}: {step_ms:.4f} ms device, "
            f"{step_launches:.0f} kernel launches, {step_call_ms:.4f} ms a call between CUDA "
            f"events, {1e3 / step_call_ms:.1f} steps/s ({smi})")

        # one step on the card against the CPU, TF32 switched on around it
        cpu_m, gpu_m = copy_of("cpu"), copy_of("cuda")
        cols_cpu = [c.cpu() for c in cols]
        idx, draws, crossed = agreeing_minibatch(cpu_m.net, gpu_m.net, cols_cpu[0],
                                                 cfg.train_batch)
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lc, _, gc = cpu_m.loss_and_grads(tuple(c[idx] for c in cols_cpu))
            lg, _, gg = gpu_m.loss_and_grads(tuple(c[idx.cuda()] for c in cols))
            grad_err = max(close(f"vp train step grad {n}", a, b, False, 1e-4,
                                 1e-5 * float(b.abs().max()))
                           for n, a, b in zip(cpu_m.names, gg, gc))
            loss_err = close("vp train step loss", lg, lc, False, 1e-5, 0.0)
            cpu_m.train_step(cols_cpu, idx)
            gpu_m.train_step(cols, idx.cuda())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        param_err = max(close(f"vp train step param {n}", a, b, False, 1e-4, 1e-6)
                        for n, a, b in zip(cpu_m.names, gpu_m.net.parameters(),
                                           cpu_m.net.parameters()))
        say(f"  VP train_step on the card vs the CPU (TF32 switched on around it): loss err "
            f"{loss_err:.3e}, grads max abs err {grad_err:.3e} (rtol 1e-4, atol 1e-5 x each "
            f"tensor's largest), params after the Adam-amsgrad step {param_err:.3e} (rtol "
            f"1e-4, atol 1e-6); minibatch draw {draws} ({crossed} ReLU inputs crossed over in "
            f"the draws before)")
    say(f"phase vp online took {time.perf_counter() - t:.1f}s")


def phase_playouts(torch, smi):
    """HybridSim at B=64 with 4 sims (cut from 100) for 2 moves: select,
    insert and the backup walk each launch moves x sims times."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig

    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True, evaluator="hybrid", sims=PLAYOUT_SIMS)
    driver, wall, launches = drive(torch, cfg, PLAYOUT_MOVES, lambda s: None)
    record("hybrid", launches)
    want = PLAYOUT_MOVES * cfg.sims
    check_launches("hybrid path", launches,
                   {"select_walk": want, "insert7_walk": want, "backup_walk": want})
    say(f"phase playouts (HybridSim): {PLAYOUT_MOVES} moves x {cfg.sims} sims (cut from 100) "
        f"at B={cfg.batch}, playout depth 30 with the value bootstrap, in {wall:.2f}s: "
        f"{wall / PLAYOUT_MOVES * 1e3:.1f} ms wall a move ({smi}); launches {launches}; the "
        f"last playout ran {driver.evaluator.steps} steps")
    say(f"phase playouts took {time.perf_counter() - t:.1f}s")


def phase_trained(torch, smi):
    """5 lp moves through `play --benchmark --load_model` with the repo's
    trained VV checkpoint of the JAX package: 500 launches of each walk,
    and the loaded net's outputs on the card equal the CPU's."""
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.cli import play
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    t = time.perf_counter()
    ckpt = str(Path(__file__).resolve().parent / TRAINED_CKPT)
    reset_launches()
    driver = play.main(["--agent_type", "ValueSimLP", "--benchmark", "--checkpoint", ckpt,
                        "--load_model", "--max_moves", "5"])
    launches = record("trained lp", read_launches())
    check_launches("trained lp", launches,
                   {k: 5 * driver.cfg.sims for k in
                    ("select_walk", "insert7_walk", "lp_backup_walk")})
    fixed = torch.as_tensor(np.random.RandomState(11).randint(-1, 2, (64, 1, 20, 10)),
                            dtype=torch.float32)
    cpu = VVModel(0, "cpu")
    if not cpu.load(ckpt):
        raise AssertionError(f"trained: {ckpt} did not load")
    got = driver.model.apply_fn()(fixed.cuda())
    want = cpu.apply_fn()(fixed)
    err = max(close("trained value", got[0], want[0], False, 1e-4, 1e-3),
              close("trained variance", got[1], want[1], False, 1e-4, 1e-2))
    seed_out = VVModel(0, "cpu").apply_fn()(fixed)
    change = max(float((a - b).abs().max()) for a, b in zip(want, seed_out))
    if not change > 0:
        raise AssertionError("trained: the loaded net's outputs equal the seed net's")
    say(f"phase trained (lp, {TRAINED_CKPT}): 5 moves x {driver.cfg.sims} sims at "
        f"B={driver.cfg.batch}; launches {launches}; the loaded net on the card vs the CPU "
        f"max abs err {err:.3e}; its outputs differ from the seed net's by up to "
        f"{change:.3f}; score of game 0 after 5 moves {int(driver.last_stats.score[0])} "
        f"({smi}); in {time.perf_counter() - t:.1f}s")


def phase_dist(torch, smi):
    """DistValueSim with a frozen net at the CLI's width (atoms 50, vmax
    1000, low 5): the insert walk launches moves x sims times, no other walk
    launches; then two profiled moves of a DIST_PROFILE_SIMS-sim twin,
    scaled to the run's sims."""
    from tetris_mcts_tpu_torch.runtime.selfplay import DistSelfPlayDriver, SelfPlayConfig

    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True, evaluator="dist", low=5)
    driver, wall, launches = drive(torch, cfg, DIST_MOVES, lambda s: None, DistSelfPlayDriver)
    record("dist", launches)
    check_launches("dist path", launches, {"insert7_walk": DIST_MOVES * cfg.sims})
    levels = driver._move.levels
    dts = driver.dtrees
    mass = dts.obs_dist.sum(1)
    used = dts.base.visits > 0
    if not bool(torch.allclose(mass[used], torch.ones_like(mass[used]), atol=1e-4)):
        raise AssertionError("dist path: a visited obs whose distribution does not sum to 1")
    say(f"phase dist (DistValueSim, frozen): {DIST_MOVES} moves x {cfg.sims} sims at "
        f"B={cfg.batch}, {driver.dcfg.atoms} atoms on [0, {driver.dcfg.vmax:g}], in "
        f"{wall:.2f}s: {wall / DIST_MOVES * 1e3:.1f} ms wall a move, "
        f"{DIST_MOVES * cfg.batch * cfg.sims / wall:.1f} sims/s ({smi}); launches {launches}; "
        f"select levels a sim in the last move: mean {sum(levels) / len(levels):.2f}, max "
        f"{max(levels)}; mean nodes {dts.base.n_nodes.float().mean().item():.0f}; "
        f"{int(used.sum())} visited obs, their distributions sum to 1 within 1e-4")
    say(f"phase dist took {time.perf_counter() - t:.1f}s")
    twin = DistSelfPlayDriver(cfg._replace(sims=DIST_PROFILE_SIMS), device="cuda",
                              log=lambda s: None)
    twin.step()  # warm-up
    torch.cuda.synchronize()
    report_profile(torch, twin, wall, DIST_MOVES, f"dist, {DIST_PROFILE_SIMS} sims a move "
                   f"scaled to {cfg.sims}", scale=cfg.sims / DIST_PROFILE_SIMS)


def phase_dist_online(torch, smi):
    """DistValueSim with training at the CLI's width until a session has run
    and DIST_ONLINE_AFTER moves more on the trained net: the stored target
    rows sum to 1;
    then one DistModel
    train step on the card against the CPU with TF32 switched on around it,
    and a step's device time."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tetris_mcts_tpu_torch.obs.metrics import MetricsReader, MetricsWriter
    from tetris_mcts_tpu_torch.runtime.selfplay import DistSelfPlayDriver, SelfPlayConfig
    from tetris_mcts_tpu_torch.train.trainer import DistModel

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_train_cases import agreeing_minibatch

    t = time.perf_counter()
    cfg = SelfPlayConfig(evaluator="dist", low=5, train_rows_trigger=DIST_ONLINE_ROWS,
                         train_max_iters=DIST_ONLINE_ITERS)
    cuts = (f"cuts: train_rows {DIST_ONLINE_ROWS} (CLI 5000), train_max_iters "
            f"{DIST_ONLINE_ITERS} (CLI 50000), at most {DIST_ONLINE_MOVE_CAP} moves, "
            f"{DIST_ONLINE_AFTER} after the first session")
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.jsonl")
        metrics = MetricsWriter(mpath)
        driver = DistSelfPlayDriver(cfg, device="cuda", log=lambda s: None, metrics=metrics)
        model = driver.model
        fixed = torch.as_tensor(np.random.RandomState(11).randint(-1, 2, (64, 1, 20, 10)),
                                dtype=torch.float32, device="cuda")
        before = model.apply_fn()(fixed)
        moves, session_move = 0, None
        reset_launches()
        t_run = time.perf_counter()
        while moves < DIST_ONLINE_MOVE_CAP:
            driver.step()
            moves += 1
            if session_move is None and driver.n_trains:
                session_move = moves
            if session_move is not None and moves - session_move >= DIST_ONLINE_AFTER:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = record("dist online", read_launches())
        metrics.close()
        if session_move is None:
            raise AssertionError(f"dist online: no training session in {moves} moves "
                                 f"({driver._prev_total} rows harvested; {cuts})")
        check_launches("dist online path", launches, {"insert7_walk": moves * cfg.sims})
        change = float((model.apply_fn()(fixed) - before).abs().max())
        if not change > 0:
            raise AssertionError("dist online: the net's outputs did not change in training")
        count = driver.replay.count.item()
        sums = driver.replay.dist[:count].sum(1)
        row_err = close("dist online: stored target rows sum to 1", sums,
                        torch.ones_like(sums), False, 0.0, 1e-3)
        reader = MetricsReader(mpath)
        reader.poll()
        sessions = reader.of_kind("train_session")
        say(f"phase dist online (DistValueSim, training): {moves} moves x {cfg.sims} sims at "
            f"B={cfg.batch} in {wall:.2f}s, the first session after move {session_move}; "
            f"launches {launches}; {driver._prev_total} rows harvested, the {count} in the "
            f"ring sum to 1 within {row_err:.2e}; net outputs on 64 fixed boards moved by up "
            f"to {change:.4f} ({smi}; {cuts})")
        for e in sessions:
            say(f"  session {e['n']}: {e['rows']} rows, {e['iters']} steps in {e['seconds']:.2f}s "
                f"({e['iters'] / e['seconds']:.1f} steps/s), loss train {e['loss_train']:.4f} "
                f"val {e['loss_val']:.4f}")

        # a train step's device time and launches at batch 128
        rows = min(4096, count)
        newest = (np.arange(driver.replay.idx.item() - rows, driver.replay.idx.item())
                  % cfg.memory_size)
        states, target, weight = driver._training_columns(newest)
        cols = [states.float()[:, None], target, weight / weight.mean()]
        sd = {k: v.detach().clone() for k, v in model.net.state_dict().items()}
        mu, nu, n_steps = model.opt.state()

        def copy_of(dev):
            m = DistModel(seed=cfg.seed, device=dev)
            m.load_state({k: v.to(dev) for k, v in sd.items()})
            m.opt.load([x.to(dev) for x in mu], [x.to(dev) for x in nu], n_steps)
            return m

        prof_m = copy_of("cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        idxs = iter([torch.randint(0, rows, (cfg.train_batch,), generator=gen, device="cuda")
                     for _ in range(43)])
        step = lambda: prof_m.train_step(cols, next(idxs))
        for _ in range(3):
            step()
        step_ms, step_launches = device_ms_all(step, 20)
        step_call_ms = cuda_ms(step, 20)
        say(f"  DistModel train_step at batch {cfg.train_batch}: {step_ms:.4f} ms device, "
            f"{step_launches:.0f} kernel launches, {step_call_ms:.4f} ms a call between CUDA "
            f"events, {1e3 / step_call_ms:.1f} steps/s ({smi})")

        # one step on the card against the CPU, TF32 switched on around it
        cpu_m, gpu_m = copy_of("cpu"), copy_of("cuda")
        cols_cpu = [c.cpu() for c in cols]
        idx, draws, crossed = agreeing_minibatch(cpu_m.net, gpu_m.net, cols_cpu[0],
                                                 cfg.train_batch)
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lc, _, gc = cpu_m.loss_and_grads(tuple(c[idx] for c in cols_cpu))
            lg, _, gg = gpu_m.loss_and_grads(tuple(c[idx.cuda()] for c in cols))
            grad_err = max(close(f"dist train step grad {n}", a, b, False, 1e-4,
                                 1e-5 * float(b.abs().max()))
                           for n, a, b in zip(cpu_m.names, gg, gc))
            loss_err = close("dist train step loss", lg, lc, False, 1e-5, 0.0)
            cpu_m.train_step(cols_cpu, idx)
            gpu_m.train_step(cols, idx.cuda())
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        param_err = max(close(f"dist train step param {n}", a, b, False, 1e-4, 1e-6)
                        for n, a, b in zip(cpu_m.names, gpu_m.net.parameters(),
                                           cpu_m.net.parameters()))
        say(f"  DistModel train_step on the card vs the CPU (TF32 switched on around it): "
            f"loss err {loss_err:.3e}, grads max abs err {grad_err:.3e} (rtol 1e-4, atol 1e-5 "
            f"x each tensor's largest), params after the Yogi step {param_err:.3e} (rtol 1e-4, "
            f"atol 1e-6); minibatch draw {draws} ({crossed} ReLU inputs crossed over in the "
            f"draws before)")
    say(f"phase dist online took {time.perf_counter() - t:.1f}s")


def phase_surface(torch, smi):
    """The VV tree's surface at the CLI's width (B=64, pools 4096, depth 96)
    with SURFACE_SIMS sims: SURFACE_MOVES lp moves with both kernels, then
    with `--select_kernel 0`, with `--insert_kernel 0` (each equal, bit for
    bit, to the kernels' run in actions and every tree array, and in the
    traces of one more select walk), and under `--policy max` (the plain
    select and backups: only the insert kernel launches)."""
    from tetris_mcts_tpu_torch.ops import tree_walk
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
    from tetris_mcts_tpu_torch.search import mcts

    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True, sims=SURFACE_SIMS)
    want = SURFACE_MOVES * cfg.sims
    runs = {}
    for label, kw, launched in (
            ("kernels", {}, ("select_walk", "insert7_walk", "lp_backup_walk")),
            ("select_kernel 0", {"select_kernel": False}, ("insert7_walk", "lp_backup_walk")),
            ("insert_kernel 0", {"insert_kernel": False}, ("select_walk", "lp_backup_walk")),
            ("max", {"policy": "max"}, ("insert7_walk",))):
        driver = SelfPlayDriver(cfg._replace(**kw), device="cuda", log=lambda s: None)
        torch.cuda.synchronize()
        reset_launches()
        t_run = time.perf_counter()
        acts = []
        for _ in range(SURFACE_MOVES):
            driver.step()
            acts.append(driver.last_stats.action)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = record(f"surface {label}", read_launches())
        check_launches(f"surface {label}", launches, {k: want for k in launched})
        runs[label] = (driver, torch.stack(acts))
        say(f"  surface {label}: {SURFACE_MOVES} moves x {cfg.sims} sims at B={cfg.batch} in "
            f"{wall:.2f}s ({wall / SURFACE_MOVES * 1e3:.1f} ms a move); launches {launches}")
    ref, ref_acts = runs["kernels"]
    tcfg = ref.search_cfg.tree
    planes = mcts.TorchPlanes(99, "cuda")(cfg.batch, tcfg.max_depth)
    ref_traces = tree_walk.select_walk(ref.trees, *planes, tcfg)[:2]
    for label in ("select_kernel 0", "insert_kernel 0"):
        driver, acts = runs[label]
        close(f"surface {label} actions", acts, ref_acts, True)
        for f in ref.trees.__dataclass_fields__:
            close(f"surface {label} {f}", getattr(driver.trees, f), getattr(ref.trees, f), True)
        for n, a, b in zip(("traces", "lengths"),
                           tree_walk.select_walk(driver.trees, *planes, tcfg)[:2], ref_traces):
            close(f"surface {label} {n}", a, b, True)
    mx = runs["max"][0]
    st = mx.last_stats
    if not (bool(torch.isfinite(mx.trees.vmax).all()) and float(mx.trees.vmax.max()) > 0
            and bool((st.child_stats[:, 0].sum(1) > 0).all())):
        raise AssertionError("surface max: no vmax backed up, or a root without visits")
    say(f"phase surface: --select_kernel 0 and --insert_kernel 0 equal to the kernels' run "
        f"bit for bit (actions, every tree array, a select walk's traces); --policy max ran "
        f"on the insert kernel alone, vmax up to {float(mx.trees.vmax.max()):.2f} ({smi}; "
        f"sims cut to {SURFACE_SIMS} from 100); in {time.perf_counter() - t:.1f}s")


def phase_s2(torch, smi):
    """ValueSim2 with a frozen net at the CLI's width: the insert walk
    launches moves x sims times, no other walk launches; edges are recorded
    and every root policy is a distribution; then two profiled moves of an
    S2_PROFILE_SIMS-sim twin, scaled to the run's sims."""
    from tetris_mcts_tpu_torch.runtime.selfplay import S2SelfPlayDriver, SelfPlayConfig

    t = time.perf_counter()
    cfg = SelfPlayConfig(benchmark=True, evaluator="s2")
    driver, wall, launches = drive(torch, cfg, S2_MOVES, lambda s: None, S2SelfPlayDriver)
    record("s2", launches)
    check_launches("s2 path", launches, {"insert7_walk": S2_MOVES * cfg.sims})
    levels = driver._move.levels
    s2 = driver.s2trees
    if not (float(s2.edge_count.sum()) > 0 and bool(torch.isfinite(s2.max_ret).all())):
        raise AssertionError("s2 path: no edge recorded, or a non-finite max_ret")
    say(f"phase s2 (ValueSim2, frozen): {S2_MOVES} moves x {cfg.sims} sims at B={cfg.batch} "
        f"in {wall:.2f}s: {wall / S2_MOVES * 1e3:.1f} ms wall a move, "
        f"{S2_MOVES * cfg.batch * cfg.sims / wall:.1f} sims/s ({smi}); launches {launches}; "
        f"select levels a sim in the last move: mean {sum(levels) / len(levels):.2f}, max "
        f"{max(levels)}; mean nodes {s2.base.n_nodes.float().mean().item():.0f}; "
        f"{int((s2.edge_child > 0).sum())} edge slots in use, "
        f"{int((s2.edge_child > 0).sum(-1).max())} children at most on one edge")
    say(f"phase s2 took {time.perf_counter() - t:.1f}s")
    twin = S2SelfPlayDriver(cfg._replace(sims=S2_PROFILE_SIMS), device="cuda",
                            log=lambda s: None)
    twin.step()  # warm-up
    torch.cuda.synchronize()
    report_profile(torch, twin, wall, S2_MOVES, f"s2, {S2_PROFILE_SIMS} sims a move "
                   f"scaled to {cfg.sims}", scale=cfg.sims / S2_PROFILE_SIMS)


def phase_dqn(torch, smi, agent):
    """`play --agent_type agent` (DQN or DistDQN) at the CLI's defaults (B=64,
    ring 100000, minibatch 32, target sync every 100) for DQN_MOVES moves
    with training, through the CLI main in process: no walk kernel
    launches, every move trains, the checkpoint is written; a train step's
    device time and launches; then DQN_BENCH_MOVES moves of `play
    --benchmark --load_model`, which play the saved net greedily and write
    nothing."""
    import contextlib
    import io
    import tempfile

    from tetris_mcts_tpu_torch.cli import play

    t = time.perf_counter()
    label = agent.lower()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "dqn.pt")
        args = ["--agent_type", agent, "--ngames", "1000000", "--checkpoint", ckpt]
        log = io.StringIO()  # the episode lines
        reset_launches()
        t_run = time.perf_counter()
        with contextlib.redirect_stderr(log), contextlib.redirect_stdout(log):
            driver = play.main(args + ["--max_moves", str(DQN_MOVES)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = record(label, read_launches())
        check_launches(f"{label} path", launches, {})
        cfg = driver.cfg
        loss = float(driver.last_stats.loss)
        syncs, eps = driver.updates // cfg.target_update_steps, driver.eps
        if not (driver.moves == driver.opt.count == DQN_MOVES and os.path.isfile(ckpt)
                and loss == loss and abs(loss) < float("inf")):
            raise AssertionError(f"{label}: {driver.moves} moves, {driver.opt.count} updates, "
                                 f"loss {loss}, checkpoint written {os.path.isfile(ckpt)}")
        episodes = log.getvalue().count("Episode:")
        driver.log = lambda s: None  # the measured steps' episode lines
        step_ms, step_launches = device_ms_all(driver.step, 20)
        call_ms = cuda_ms(driver.step, 20)
        say(f"phase {label} ({agent}, training): {DQN_MOVES} moves at B={cfg.batch} in "
            f"{wall:.2f}s: {DQN_MOVES / wall:.1f} moves/s ({smi}); {DQN_MOVES} updates, "
            f"{syncs} target syncs, the last loss "
            f"{loss:.6g}; eps {eps:.4f}; {episodes} episodes; launches {launches}")
        say(f"  {agent} step (act on {cfg.batch} boards, env step, ring write, a minibatch "
            f"of {cfg.train_batch}, Adam): {step_ms:.4f} ms device, {step_launches:.0f} "
            f"kernel launches, {call_ms:.4f} ms a call between CUDA events ({smi})")
        log = io.StringIO()
        t_run = time.perf_counter()
        with contextlib.redirect_stderr(log), contextlib.redirect_stdout(log):
            bench = play.main(args + ["--benchmark", "--load_model", "--max_moves",
                                      str(DQN_BENCH_MOVES)])
        torch.cuda.synchronize()
        bench_wall = time.perf_counter() - t_run
        # the loaded net is the one saved at the end of the training run's moves
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)["dqn_net"]
        if not (bench.count == 0 and bench.opt.count == DQN_MOVES
                and bench.eps == bench.cfg.eps_final and int(bench.replay.count) == 0
                and all(torch.equal(p, saved[n]) for n, p in bench.net.named_parameters())):
            raise AssertionError(f"{label} --benchmark: trained, wrote the ring, or did not "
                                 "play the saved net")
        say(f"  {agent} --benchmark --load_model: {bench.moves} moves in {bench_wall:.2f}s, "
            f"{bench.moves / bench_wall:.1f} moves/s, eps {bench.eps}, "
            f"{log.getvalue().count('Episode:')} episodes, nothing trained or stored")
    say(f"phase {label} took {time.perf_counter() - t:.1f}s")


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
    """Device time of n moves under torch.profiler, which records the
    device's activity alone (nothing here reads the host's operators):
    (total kernel ms, every kernel as (name, ms, launches), largest
    first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
