"""Rank functions of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_distributed.py and tests/test_torch_sharded_playouts.py on
the CPU, tests/test_torch_cuda.py and chip_smoke.py on the card). `runtime/distributed.spawn` runs them in
fresh processes; they import torch and the port only, and return what the
parent compares with the JAX package or with one process.

Randomness on the CPU comes from the parent as recorded global draws (the
JAX key schedule replayed), handed out in order by `RecordedPlanes`; each
rank's `parallel/mesh.ShardedPlanes` slices its rows from them. On the card
each rank draws the global planes from a `search/mcts.TorchPlanes` seeded
as one process's (`card_selfplay`), and `check_card_selfplay` holds the
ranks against one process on the concatenation of their games.
"""

import contextlib
import time
from dataclasses import fields

import torch

from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.runtime import distributed as D
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import stochastic as ST
from tetris_mcts_tpu_torch.search import vp as VP
from tetris_mcts_tpu_torch.train.trainer import VPModel, VVModel
from torch_train_cases import train_columns

VP_LOGIT = (0.03, -0.02, 0.011, 0.005, -0.007, 0.017, -0.002)  # torch_parity.STUB_LOGIT


class RecordedPlanes:
    """The draws a move program asks for, recorded by the parent at the
    global batch, given back in the order they were recorded."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, *_):
        return self.draws.pop(0)

    __call__ = uniforms = level_gumbels = drop = _next


class PlayoutDraws:
    """A playout's recorded global draws, handed out by step (`actions`,
    `gumbels`): the port's loop tests its exit every ROLLOUT_EXIT_EVERY
    steps, so it may stop before the last recorded step."""

    def __init__(self, steps=None):
        self.steps = steps

    def actions(self, B, step):
        return self.steps[step]

    gumbels = actions


class RecordedPlayoutPlanes(RecordedPlanes, PlayoutDraws):
    """`RecordedPlanes` of a move program whose simulations play out:
    `playouts` holds each simulation's playout draws by step, taken up by
    that simulation's select draw."""

    def __init__(self, draws, playouts):
        RecordedPlanes.__init__(self, draws)
        self.playouts = list(playouts)

    def __call__(self, *_):
        self.steps = self.playouts.pop(0)
        return self._next()


def cellsum_net(x):
    """A board-wise stand-in for the VV net (what a rank computes for a
    board does not depend on its batch): v = 0.01 x the board's cell sum
    + 1, var 2.5."""
    n = x.shape[0]
    return x.reshape(n, -1).sum(1) * 0.01 + 1.0, torch.full((n,), 2.5)


def vp_stub(x):
    """torch_parity.vp_stubs' port half: value 0.5 s, logits s x VP_LOGIT."""
    s = x.sum(dim=(1, 2, 3))
    return 0.5 * s, s[:, None] * torch.tensor(VP_LOGIT)


def _move_program(kind, scfg, planes):
    if kind == "lp":
        move = mcts.make_move_fn(mcts.nn_child_evaluator(cellsum_net), scfg, planes,
                                 min_visits_store=1, store=True)
        return move, mcts.init_batch, mcts.init_replay
    if kind == "vp":
        move = VP.make_vp_move_fn(vp_stub, scfg, planes, min_visits_store=1)
        return move, VP.init_vp_batch, VP.init_vp_replay
    move = ST.make_s2_move_fn(cellsum_net, scfg, min_visits_store=1)
    return move, ST.init_s2_batch, mcts.init_replay


def sharded_moves(rank, cases):
    """Each case (kind "lp", "vp" or "s2", its SearchConfig, global batch,
    seed, moves, ring capacity and recorded draws): the move program on this
    rank's rows of `init_batch(seed, B)` (`shard_batch`) with the replicated
    ring. Returns the trees, envs, ring and every move's actions."""
    mesh = M.make_mesh()
    out = {}
    for name, c in cases.items():
        planes = M.ShardedPlanes(RecordedPlanes(c["draws"]), mesh)
        move, init, init_ring = _move_program(c["kind"], c["scfg"], planes)
        trees, envs = M.shard_batch(mesh, init(c["seed"], c["B"], c["scfg"], "cpu"))
        ring = init_ring(c["ring"], "cpu")
        smove = M.sharded_move_fn(move, mesh)
        actions = []
        for _ in range(c["moves"]):
            envs, stats = smove(trees, envs, ring)
            actions.append(stats.action)
        out[name] = dict(trees=trees, envs=envs, ring=ring, actions=actions)
    mesh.close()
    return out


def playout_evaluator(scfg, planes, all_ended=mcts.lanes_ended):
    """scfg.evaluator's playout (the rollout, or a policy playout on
    `vp_stub` at its `mcts.playout_depth`), drawing from `planes`."""
    if scfg.evaluator == "rollout":
        return mcts.rollout_evaluator(scfg, planes.actions, all_ended)
    return mcts.policy_rollout_evaluator(vp_stub, scfg, mcts.playout_depth(scfg),
                                         mcts.POLICY_PLAYOUTS[scfg.evaluator][1],
                                         planes.gumbels, all_ended)


def _logged_exits(mesh_cls):
    """Have every `Mesh.all_ended` call (of any mesh, this process) log
    (this rank's lanes all ended, every rank's) to the list returned."""
    checks, whole = [], mesh_cls.all_ended

    def all_ended(self, env):
        ended = whole(self, env)
        checks.append((mcts.lanes_ended(env), ended))
        return ended

    mesh_cls.all_ended = all_ended
    return checks


def sharded_playouts(rank, evals, moves, drives):
    """The sharded playouts on this rank's rows, every exit test over the
    data axis (`Mesh.all_ended`):

    - `evals` (name -> scfg, the global leaf envs, the global draws by
      step): the evaluator alone; its values and steps;
    - `moves` (name -> scfg, the global trees and envs, moves, ring
      capacity, the recorded select draws and playout draws): the move
      program with the replicated ring; trees, envs, ring, every move's
      actions and every simulation's playout steps;
    - `drives` (name -> cfg, moves, and recorded (draws, playouts) or None
      for the driver's own `TorchPlanes`): `DistributedSelfPlay`; its
      trees, envs, ring, bookkeeping and log.

    Every result carries the exit tests it made, (this rank's lanes all
    ended, every rank's), in order."""
    checks = _logged_exits(M.Mesh)
    mesh = M.make_mesh()
    out = {"evals": {}, "moves": {}, "drives": {}}
    for name, c in evals.items():
        checks.clear()
        ev = playout_evaluator(c["scfg"], M.ShardedPlanes(PlayoutDraws(c["steps"]), mesh),
                               mesh.all_ended)
        v, var = ev(None, M.shard_batch(mesh, c["env"]))
        out["evals"][name] = dict(v=v, var=var, steps=ev.steps, checks=list(checks))
    for name, c in moves.items():
        checks.clear()
        planes = M.ShardedPlanes(RecordedPlayoutPlanes(c["draws"], c["playouts"]), mesh)
        ev, steps = playout_evaluator(c["scfg"], planes, mesh.all_ended), []

        def logged(packed7, leaf_env, ev=ev, steps=steps):
            result = ev(packed7, leaf_env)
            steps.append(ev.steps)
            return result

        move = mcts.make_move_fn(logged, c["scfg"], planes, min_visits_store=1, store=True)
        trees, envs = M.shard_batch(mesh, (c["trees"], c["envs"]))
        ring = mcts.init_replay(c["ring"], "cpu")
        smove = M.sharded_move_fn(move, mesh)
        actions = []
        for _ in range(c["moves"]):
            envs, stats = smove(trees, envs, ring)
            actions.append(stats.action)
        out["moves"][name] = dict(trees=trees, envs=envs, ring=ring, actions=actions,
                                  steps=steps, checks=list(checks))
    for name, (cfg, n, recorded) in drives.items():
        checks.clear()
        log = []
        planes = None if recorded is None else RecordedPlayoutPlanes(*recorded)
        sp = D.DistributedSelfPlay(cfg, device="cpu", log=log.append, planes=planes)
        sp.run(n)
        d = sp.driver
        out["drives"][name] = dict(
            trees=d.trees, envs=d.envs, ring=d.replay, log=log, moves=d.moves,
            episodes=d.episodes, lines=(d.line_tracker.n, d.line_tracker.mean),
            actions=d.last_stats.action, steps=d.evaluator.steps, checks=list(checks))
        sp.close()
    mesh.close()
    return out


def vv_model(state):
    """The port's VVModel on the CPU holding (state dict, ubound, lbound,
    (mu, nu, count))."""
    sd, ub, lb, (mu, nu, count) = state
    m = VVModel(device="cpu")
    m.load_state(sd, ub, lb)
    m.load_opt_state(mu, nu, count)
    return m


def learner_steps(rank, model_parallel, state, data, idxs, ewc=None):
    """`make_sharded_learner` steps on the minibatches idxs; returns the
    whole params and the metrics after each step, and this rank's shards.
    With `ewc` = (Fisher, p0, lam), the same steps again from `state` under
    that EWC penalty (`ewc`: their params and metrics)."""
    m = vv_model(state)
    mesh = M.make_mesh(model_parallel=model_parallel)

    def run(m, lam=0.0):
        lstate, step = M.make_sharded_learner(m, mesh)
        params, metrics = [], []
        for idx in idxs:
            lstate, met, _ = step(lstate, m.ubound, data, idx, lam)
            params.append(M.gather_params(mesh, lstate))
            metrics.append({k: float(v) for k, v in met.items()})
        return lstate, params, metrics

    lstate, params, metrics = run(m)
    shards = {k: v.detach() for k, v in lstate.params.items()}
    whole = M.sharded_train_step(m, mesh)(dict(m.net.named_parameters()), m.opt.state(),
                                          m.ubound, data, idxs[0], m.fisher, m.p0)
    out = dict(params=params, metrics=metrics, shards=shards, whole=whole[0],
               coords=(mesh.data_index, mesh.model_index))
    if ewc is not None:
        fisher, p0, lam = ewc
        m = vv_model(state)
        m.fisher, m.p0 = fisher, p0
        _, params, metrics = run(m, lam)
        out["ewc"] = dict(params=params, metrics=metrics)
    mesh.close()
    return out


def selfplay(rank, cfg, state, draws, moves, online_cfg, online_moves):
    """`DistributedSelfPlay` for `moves` moves on the VV net `state` with
    the recorded draws, then an online run (`online_cfg`, its own seeded
    draws) whose sessions fire; returns the first run's trees, envs, ring
    and bookkeeping and the online run's params and session count."""
    log = []
    sp = D.DistributedSelfPlay(cfg, model=vv_model(state), device="cpu", log=log.append,
                               planes=RecordedPlanes(draws))
    sp.run(moves)
    d = sp.driver
    out = dict(trees=d.trees, envs=d.envs, ring=d.replay, log=log, moves=d.moves,
               episodes=d.episodes, lines=(d.line_tracker.n, d.line_tracker.mean),
               actions=d.last_stats.action)
    sp.close()
    sp = D.DistributedSelfPlay(online_cfg, device="cpu", log=lambda s: None)
    sp.run(online_moves)
    out["online"] = dict(params=sp.driver.model.net.state_dict(), sessions=sp.driver.n_trains,
                         ubound=sp.driver.model.ubound, ring_total=int(sp.driver.replay.total))
    sp.close()
    return out


# ---------------------------------------------------------------------------
# the card: ranks of DistributedSelfPlay and the learner against one process
# ---------------------------------------------------------------------------

def _launch_counts():
    from tetris_mcts_tpu_torch.ops import bench_walk, tree_walk, vv_forward

    return {**tree_walk.LAUNCHES, **vv_forward.LAUNCHES, **bench_walk.LAUNCHES}


def _reset_launches():
    from tetris_mcts_tpu_torch.ops import bench_walk, tree_walk, vv_forward

    for m in (tree_walk, vv_forward, bench_walk):
        m.reset_launches()


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def profiled_device_ms(fn, n, dev="cuda"):
    """Device ms a call of fn (all its CUDA kernels, torch.profiler) over n
    calls, and the kernels recorded a call; (0, 0) off the card. The
    profiler can miss launches (PERF.md §6), so this is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.device(dev).type != "cuda":
        for _ in range(n):
            fn()
        return 0.0, 0
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(dev)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / n,
            sum(e.count for e in rows) / n)


def card_selfplay(rank, cfg, moves, leaf_moves, device, learner=None):
    """On rank's card: `moves` moves of `DistributedSelfPlay(cfg)` (launch
    counts from 0, each move's wall time), one profiled move more, then,
    with `learner` = (seed, idx), one data-parallel and one tensor-parallel
    (model 2) learner step on `train_columns()` and the time of an
    all-reduce of the step's flat gradient over the data group, then
    `leaf_moves` moves of the leaf driver. Returns CPU copies of the trees
    after every move, of the envs and ring after the `moves` moves, the
    launches and the times, with the ms of the ring's gather over the data
    group (`Mesh.gather_rows` on the last move's rows, median of 10) and
    the bytes it gathers."""
    dev = torch.device(device) if device != "cuda" else D.rank_device("cuda")
    sp = D.DistributedSelfPlay(cfg, device=dev, log=lambda s: None)
    d = sp.driver
    gather, last = sp.mesh.gather_rows, []

    def keep_args(*args):  # the move's own gather, its inputs kept
        last[:] = args
        return gather(*args)

    sp.mesh.gather_rows = keep_args
    _reset_launches()
    walls, by_move = [], []
    for _ in range(moves):
        _sync(dev)
        t = time.perf_counter()
        d.step()
        _sync(dev)
        walls.append(time.perf_counter() - t)
        by_move.append(_cpu(d.trees))
    out = dict(trees=by_move[-1], trees_by_move=by_move, envs=d.envs.cpu(),
               ring=[x.cpu() for x in d.replay.rows()],
               ring_counts=[int(x) for x in (d.replay.idx, d.replay.count, d.replay.total)],
               launches=_launch_counts(), walls=walls, episodes=d.episodes, moves=d.moves)
    sp.mesh.gather_rows = gather
    ms = []
    for _ in range(11):
        _sync(dev)
        t = time.perf_counter()
        gather(*last)
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    out["ring_gather_ms"] = sorted(ms[1:])[len(ms[1:]) // 2]
    cols, mask, cand = last
    width = sum(c[0].numel() for c in cols) + 1 + (cand is not None)
    out["ring_gather_bytes"] = mask.shape[0] * width * 4 * sp.mesh.data_size
    out["device_ms"], out["kernels_a_move"] = profiled_device_ms(d.step, 1, dev)
    sp.close()
    if learner is not None:
        seed, idx = learner
        cols = [c.to(dev) for c in train_columns()]
        out["learner"] = {}
        for mp in (1, 2):
            m = VVModel(seed=seed, device=dev)
            mesh = M.make_mesh(model_parallel=mp)
            state, step = M.make_sharded_learner(m, mesh)
            _sync(dev)
            t = time.perf_counter()
            state, met, _ = step(state, m.ubound, cols, idx.to(dev))
            _sync(dev)
            out["learner"][mp] = dict(params={k: v.cpu() for k, v in
                                              M.gather_params(mesh, state).items()},
                                      loss=float(met["loss"]), ms=(time.perf_counter() - t) * 1e3)
            if mp == 1:  # the step's gradient all-reduce alone
                flat = torch.zeros(sum(p.numel() for p in m.net.parameters()), device=dev)
                ms = []
                for _ in range(11):
                    _sync(dev)
                    t = time.perf_counter()
                    torch.distributed.all_reduce(flat, group=mesh.data_group)
                    _sync(dev)
                    ms.append((time.perf_counter() - t) * 1e3)
                out["allreduce_ms"] = sorted(ms[1:])[len(ms[1:]) // 2]
                out["allreduce_floats"] = flat.numel()
            mesh.close()
    if leaf_moves:
        _reset_launches()
        sp = D.DistributedSelfPlay(cfg._replace(evaluator="leaf"), device=dev,
                                   log=lambda s: None)
        sp.run(leaf_moves)
        out["leaf_launches"] = _launch_counts()
        sp.close()
    return out


def _cpu(tree):
    """A CPU copy of a tree (a copy on the CPU too: the moves write in place)."""
    return type(tree)(**{f.name: getattr(tree, f.name).to("cpu", copy=True)
                         for f in fields(tree)})


def _rows(tree, start, n):
    return type(tree)(**{f.name: getattr(tree, f.name)[start:start + n] for f in fields(tree)})


STAT_TOL = dict(rtol=1e-6, atol=1e-5)  # torch_parity.STAT_TOL
# The variances (trees' vars_, the ring's var) of ranks against one
# process: a rank's VV net evaluates a batch of 224 children where one
# process evaluates 448, and cuDNN / cuBLAS give a board other last bits in
# the other batch (up to 1.2e-4 on outputs up to 1e3 on the H100); the
# backups' Welford variance carries that to 1.1e-6 relative, past STAT_TOL.
# The store tests' bound for the ring's var (tests/test_torch_replay.py
# RING_TOL); values stay within STAT_TOL.
NET_VAR_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = {"values": STAT_TOL, "vars_": NET_VAR_TOL, "value": STAT_TOL, "var": NET_VAR_TOL}


def _within(name, a, b, rtol, atol):
    """(max |a - b|, its largest share of STAT_TOL's bound); raises,
    naming the worst entry, past atol + rtol |b|."""
    err = (a.double() - b.double()).abs()
    over = err - (atol + rtol * b.double().abs())
    if bool((over > 0).any()):
        i = int(over.argmax())
        where = tuple(int(j) for j in torch.unravel_index(torch.tensor(i), a.shape))
        raise AssertionError(f"{name}: {int((over > 0).sum())} entries past rtol {rtol} / atol "
                             f"{atol}, worst at {where}: {float(a.flatten()[i])} against "
                             f"{float(b.flatten()[i])}")
    if not err.numel():
        return 0.0, 0.0
    share = err / (STAT_TOL["atol"] + STAT_TOL["rtol"] * b.double().abs())
    return float(err.max()), float(share.max())


def _hold_trees(name, got, want, errs):
    """Every integer array of `got` equal to `want`'s, values and vars
    within TOL; errs[field] takes the largest (abs err, share of STAT_TOL's
    bound) seen."""
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in TOL:
            e = _within(f"{name} {f.name}", a, b, **TOL[f.name])
            errs[f.name] = tuple(max(x, y) for x, y in zip(errs.get(f.name, (0.0, 0.0)), e))
        elif not torch.equal(a, b):
            raise AssertionError(f"{name}: {f.name} differs from one process's")


def _rank_batched(model, W):
    """`model` with its `apply_fn` evaluating the boards in W equal chunks:
    the lp evaluator lays a move's children out lane-major, so each chunk
    is the batch one of W ranks evaluates."""
    whole = model.apply_fn

    def apply_fn(compute_dtype=None):
        f = whole(compute_dtype)

        def chunks(imgs):
            outs = [f(c) for c in imgs.chunk(W)]
            return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

        return chunks

    model.apply_fn = apply_fn
    return model


def _one_process(cfg, W, device, model=None):
    """`SelfPlayDriver(cfg)` on the concatenation of W ranks' games."""
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayDriver

    one = SelfPlayDriver(cfg, model=model, device=device, log=lambda s: None)
    parts = [mcts.init_batch(D.host_seed(cfg.seed, r), cfg.batch // W, one.search_cfg, device)
             for r in range(W)]
    one.trees = type(parts[0][0])(**{f.name: torch.cat([getattr(p[0], f.name) for p in parts])
                                     for f in fields(parts[0][0])})
    one.envs = torch.cat([p[1] for p in parts])
    return one


def check_card_selfplay(outs, cfg, moves, device="cuda", learner=None):
    """Hold the ranks of `card_selfplay` (lp) against one process on
    `device`: `SelfPlayDriver(cfg)` on the concatenation of the ranks'
    games (`host_seed`) with the same planes. Where that process's VV net
    evaluates each rank's boards as a batch of their own (`_rank_batched`),
    every tree array after every move and the ring are bit-equal to the
    ranks'. Where it evaluates them all at once, as one process does: after
    every move every integer tree array equal over each rank's lanes,
    values within STAT_TOL and vars within NET_VAR_TOL; then the envs equal,
    the rings equal across ranks bit for bit and the one process's ring in
    its boards, weights and counters (values and variances as the trees').
    With `learner`, each step's params within the train step's bound on the
    card (rtol 1e-4 / atol 1e-6) of `VVModel.train_step`, and bit-equal
    across ranks. Returns (the one process's driver, its move walls, its
    profiled device ms a move, for each move {field: (max abs err, its
    largest share of STAT_TOL's bound)}, the last move's with the ring's
    "ring value" and "ring var"). For the card: on the CPU the twin with
    the ranks' net batches is not bit-equal (a CPU path rounds otherwise at
    4 lanes than at 8; not traced further)."""
    W = len(outs)
    local = cfg.batch // W
    twin = _one_process(cfg, W, device, _rank_batched(VVModel(cfg.seed, device), W))
    for mv in range(moves):
        twin.step()
        trees = _cpu(twin.trees)
        for r, o in enumerate(outs):
            want = _rows(trees, r * local, local)
            for f in fields(want):
                if not torch.equal(getattr(o["trees_by_move"][mv], f.name), getattr(want, f.name)):
                    raise AssertionError(f"move {mv + 1} rank {r}: {f.name} differs from one "
                                         "process's with the rank's net batch")
    for a, b in zip(outs[0]["ring"], twin.replay.rows()):
        if not torch.equal(a, b.cpu()):
            raise AssertionError("the ring differs from one process's with the ranks' net batch")
    del twin
    one = _one_process(cfg, W, device)
    walls, errs = [], []
    for mv in range(moves):
        _sync(device)
        t = time.perf_counter()
        one.step()
        _sync(device)
        walls.append(time.perf_counter() - t)
        trees, e = _cpu(one.trees), {}
        for r, o in enumerate(outs):
            _hold_trees(f"move {mv + 1} rank {r}", o["trees_by_move"][mv],
                        _rows(trees, r * local, local), e)
        errs.append(e)
    envs, ring = one.envs.cpu(), [x.cpu() for x in one.replay.rows()]
    dev_ms, _ = profiled_device_ms(one.step, 1, device)
    for r, o in enumerate(outs):
        if not torch.equal(o["envs"], envs[r * local:(r + 1) * local]):
            raise AssertionError(f"rank {r}: envs differ from one process's")
        for a, b in zip(o["ring"], outs[0]["ring"]):
            if not torch.equal(a, b):
                raise AssertionError(f"rank {r}'s ring differs from rank 0's")
    for name, a, b in zip(("boards", "value", "var", "weight"), outs[0]["ring"], ring):
        if name in TOL:
            errs[-1][f"ring {name}"] = _within(f"ring {name}", a, b, **TOL[name])
        elif not torch.equal(a, b):
            raise AssertionError(f"ring {name} differs from one process's")
    if outs[0]["ring_counts"] != [int(x) for x in (one.replay.idx, one.replay.count,
                                                   one.replay.total)]:
        raise AssertionError("ring counters differ from one process's")
    if learner is not None:
        seed, idx = learner
        cols = [c.to(device) for c in train_columns()]
        m = VVModel(seed=seed, device=device)
        m.train_step(cols, idx.to(device))
        for mp in (1, 2):
            for r, o in enumerate(outs):
                got = o["learner"][mp]["params"]
                for k, v in m.net.state_dict().items():
                    torch.testing.assert_close(got[k], v.cpu(), rtol=1e-4, atol=1e-6,
                                               msg=f"model {mp} rank {r} {k}")
                    if not torch.equal(got[k], outs[0]["learner"][mp]["params"][k]):
                        raise AssertionError(f"model {mp}: rank {r}'s {k} differs from "
                                             "rank 0's")
    return one, walls, dev_ms, errs


# ---------------------------------------------------------------------------
# the card: the playout evaluators on ranks against one process
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def playout_steps(log):
    """While open, every rollout or policy-playout evaluator that
    `search/mcts` builds appends each call's steps to `log` (a driver built
    inside keeps doing so)."""
    made = mcts.rollout_evaluator, mcts.policy_rollout_evaluator

    def logging(make):
        def build(*args, **kw):
            ev = make(*args, **kw)

            def logged(packed7, leaf_env):
                out = ev(packed7, leaf_env)
                logged.steps = ev.steps
                log.append(ev.steps)
                return out

            logged.steps = 0
            return logged

        return build

    mcts.rollout_evaluator, mcts.policy_rollout_evaluator = map(logging, made)
    try:
        yield log
    finally:
        mcts.rollout_evaluator, mcts.policy_rollout_evaluator = made


def _median_ms(fn, dev, n=10):
    ms = []
    for _ in range(n + 1):
        _sync(dev)
        t = time.perf_counter()
        fn()
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    return sorted(ms[1:])[n // 2]


def card_playouts(rank, runs, device):
    """On rank's card, for each (name, cfg, moves, deep) of `runs`: `moves`
    moves of `DistributedSelfPlay(cfg)` (a playout evaluator; launch counts
    from 0, each move's wall time), then the exit test over the data axis
    (`Mesh.all_ended`) and the local one (`mcts.lanes_ended`) on this
    rank's envs, median ms of 10 each, then, if `deep`, one profiled move
    more (torch.profiler costs ~0.7 ms a kernel there, and a Vanilla move
    runs ~10^5). Returns by name CPU copies of the trees after every move
    and of the envs, the launches, the walls, each move's playout steps by
    simulation and exit tests (this rank's lanes all ended, every rank's),
    those ms and the profiled device ms (None without `deep`)."""
    dev = torch.device(device) if device != "cuda" else D.rank_device("cuda")
    checks = _logged_exits(M.Mesh)
    out = {}
    for name, cfg, moves, deep in runs:
        steps = []
        with playout_steps(steps):
            sp = D.DistributedSelfPlay(cfg, device=dev, log=lambda s: None)
        d = sp.driver
        _reset_launches()
        walls, by_move, steps_by_move, checks_by_move = [], [], [], []
        for _ in range(moves):
            steps.clear()
            checks.clear()
            _sync(dev)
            t = time.perf_counter()
            d.step()
            _sync(dev)
            walls.append(time.perf_counter() - t)
            by_move.append(_cpu(d.trees))
            steps_by_move.append(list(steps))
            checks_by_move.append(list(checks))
        res = dict(trees_by_move=by_move, envs=d.envs.cpu(), launches=_launch_counts(),
                   walls=walls, steps=steps_by_move, checks=checks_by_move)
        res["flag_ms"] = _median_ms(lambda: sp.mesh.all_ended(d.envs), dev)
        res["local_flag_ms"] = _median_ms(lambda: mcts.lanes_ended(d.envs), dev)
        res["device_ms"] = profiled_device_ms(d.step, 1, dev)[0] if deep else None
        sp.close()
        out[name] = res
    return out


def check_card_playouts(outs, runs, device="cuda"):
    """Hold the ranks of `card_playouts` against one process on `device`:
    `SelfPlayDriver(cfg)` on the concatenation of the ranks' games with the
    same planes. The rollout's (no net): every tree array after every move
    and the envs bit-equal, every simulation's playout steps equal. A
    policy playout's: the same against the process whose VP net takes each
    rank's boards as their own batch (`_rank_batched`); then, for a `deep`
    run (`card_playouts`), against one process whose net takes all the
    boards at once, every integer tree array equal, values within STAT_TOL
    and vars within NET_VAR_TOL after every move. Returns by name (the one
    process's move walls, its profiled device ms a move if `deep`, its
    playout steps by move, errs by move as `check_card_selfplay`'s)."""
    result = {}
    for name, cfg, moves, deep in runs:
        W, local = len(outs), cfg.batch // len(outs)
        rollout = cfg.evaluator == "rollout"
        steps = []
        with playout_steps(steps):
            twin = _one_process(cfg, W, device, None if rollout else
                                _rank_batched(VPModel(cfg.seed, device), W))
        walls, steps_by_move = [], []
        for mv in range(moves):
            steps.clear()
            _sync(device)
            t = time.perf_counter()
            twin.step()
            _sync(device)
            walls.append(time.perf_counter() - t)
            steps_by_move.append(list(steps))
            trees = _cpu(twin.trees)
            for r, o in enumerate(outs):
                got = o[name]
                if got["steps"][mv] != steps_by_move[mv]:
                    raise AssertionError(f"{name} move {mv + 1} rank {r}: playout steps "
                                         f"{got['steps'][mv]}, one process's {steps_by_move[mv]}")
                want = _rows(trees, r * local, local)
                for f in fields(want):
                    if not torch.equal(getattr(got["trees_by_move"][mv], f.name),
                                       getattr(want, f.name)):
                        raise AssertionError(f"{name} move {mv + 1} rank {r}: {f.name} differs "
                                             "from one process's" + ("" if rollout else
                                                                     " with the rank's net batch"))
        envs = twin.envs.cpu()
        for r, o in enumerate(outs):
            if not torch.equal(o[name]["envs"], envs[r * local:(r + 1) * local]):
                raise AssertionError(f"{name} rank {r}: envs differ from one process's")
        errs = []
        if deep and not rollout:
            del twin
            steps = []
            with playout_steps(steps):
                twin = _one_process(cfg, W, device)
            walls, steps_by_move = [], []
            for mv in range(moves):
                steps.clear()
                _sync(device)
                t = time.perf_counter()
                twin.step()
                _sync(device)
                walls.append(time.perf_counter() - t)
                steps_by_move.append(list(steps))
                trees, e = _cpu(twin.trees), {}
                for r, o in enumerate(outs):
                    _hold_trees(f"{name} move {mv + 1} rank {r}", o[name]["trees_by_move"][mv],
                                _rows(trees, r * local, local), e)
                errs.append(e)
        dev_ms = profiled_device_ms(twin.step, 1, device)[0] if deep else None
        result[name] = (walls, dev_ms, steps_by_move, errs)
    return result
