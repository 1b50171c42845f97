"""The four MCTS walk kernels of the search, with their plain versions.

Counterpart of the reference package's `ops/tree_walk.py`, whose Pallas
kernels these replace:

| wrapper | plain version | replaces (tetris_mcts_tpu/ops/tree_walk.py) |
| --- | --- | --- |
| `select_walk` | `select_walk_plain` | `_select_kernel` via `select_batched_pallas` |
| `insert_obs7` | `tree.insert_obs7_batched` | `_insert7_kernel` via `insert_obs7_batched_pallas` |
| `lp_backup` | `lp_backup_plain` (`tree.lp_seed` + `tree.backup_batched`) | `_lp_backup_kernel` via `lp_backup_batched_pallas` |
| `backup` | `tree.backup_batched` | `_backup_kernel` via `backup_batched_pallas` |

Each wrapper takes the batched `Tree` and launches its CUDA kernel
(`csrc/tree_walk.cu`, built by `ops/build.py`) when the tree lies on a CUDA
device, counting the launch in `LAUNCHES`; on the CPU it runs the plain
torch version, which is also what the kernel is held against on the card.
Any other device raises. The kernels update the tree in place.

What bounds them on the H100, and what the designs do about it: each is a
walk of dependent loads (child base -> 7 children -> their statistics, one
level after another; a probe slot, then the next), so a tree's time is a
chain of memory latencies and of the serial work between them, and the
bytes a walk touches (about 0.2 KB a level) are far below what the card's
3.35 TB/s could move. So every walk runs a warp per tree, two trees a
block, to cut the number of dependent round trips: select loads a level of
its 7 children (in lanes) in two (and steps the env in shared memory, a
board row a lane); insert resolves a probe round of all 7 keys in one,
settling contending claims in registers; both backups share one walk that
loads up to 32 levels of the trace at once, a level a lane, so it pays its
round trips once a chunk of 32 levels, not once a level, then runs the
serial v chain by shuffles and the statistics' updates of all the chunk's
levels at once, in as many rounds as its most repeated obs has visits (see
`csrc/tree_walk.cu`). The LP backup fetches the walk's first chunk together
with the leaf's children, which it seeds first.
Levels keep their order: every update sees the earlier levels' updates of
its obs. The ~0.5 MB of tree state per lane stays
in device memory and the hot lines in L2 (34 MB at B=64, within the 50 MB
L2). Every device loop is bounded: select by D levels, insert by
PROBE_ROUNDS rounds, the backups by the trace length (<= D). Each kernel
launches on the stream of its tensors' device, with that device current
(`build.launch`).
"""

from __future__ import annotations

import torch

from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.ops import build
from tetris_mcts_tpu_torch.search import tree as T

N_ACTIONS = T.N_ACTIONS
# Selection policies of the select kernel; a policy's index here is the
# `Policy` enum value in csrc/tree_walk.cu, so the two orders must match
# (tests/test_torch_search.py checks it). `--policy max` is not among them:
# its `vmax` statistic lives outside the kernels' tree layout, so a max
# search runs the plain select walk and the plain backups, as the reference
# runs its XLA walks for it (`search/mcts.make_run_sims`); every wrapper but
# insert refuses a policy that is not here.
POLICIES = ("clt", "bayes", "gauss", "ucbv", "mc", "random", "greedy")

# Kernel launches per wrapper, counted where each kernel is launched.
LAUNCHES = {"select_walk": 0, "insert7_walk": 0, "lp_backup_walk": 0,
            "backup_walk": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"walk kernels run on cuda or cpu tensors, not {x.device}")


def _check(name, x, dtype, shape):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    if not x.is_cuda:
        raise ValueError(f"{name}: not on a CUDA device")


def _launch(fn_name, *args):
    build.launch("tree_walk", fn_name, *args)
    LAUNCHES[fn_name] += 1


def _tree_checks(trees: T.Tree, cfg: T.TreeConfig):
    if cfg.policy not in POLICIES:
        raise ValueError(f"walk kernels: unknown or unported policy {cfg.policy!r} "
                         "(--policy max runs the plain walks)")
    B, N = trees.cbase.shape
    M = trees.visits.shape[1]
    _check("cbase", trees.cbase, torch.int32, (B, N))
    _check("nstat", trees.nstat, torch.float32, (B, 2, N))
    _check("end", trees.end, torch.bool, (B, N))
    for f in ("visits", "values", "vars_"):
        _check(f, getattr(trees, f), torch.float32, (B, M))
    return B, N, M


# ---------------------------------------------------------------------------
# selection walk + expansion front half
# ---------------------------------------------------------------------------

def select_walk_plain(trees: T.Tree, gumbels, rnd, cfg: T.TreeConfig):
    """Plain form of the select kernel. Each lane walks from its root: at
    each node it keeps the unique children by obs; if any kept child has
    visits < low it takes the one with the largest gumbel, otherwise the
    first-index argmax of q = value + child score - node score + policy
    bound. Each descent steps the lane's packed env, except on the last
    level of a depth-capped walk. Then the leaf's 7 children are stepped.

    gumbels/rnd (B, D, 7) float32 pre-drawn per level. Returns
    (traces (B, D) int32, lengths (B,) int32, leafs (B,) int32,
    leaf_env (B, 44) int32, child_packed (B, 7, 20) int32,
    child_score (B, 7) int32, child_end (B, 7) int32)."""
    B = trees.root.shape[0]
    D = cfg.max_depth
    dev = trees.root.device
    b = torch.arange(B, device=dev)
    a7 = torch.arange(N_ACTIONS, device=dev)
    traces = torch.zeros(B, D, dtype=torch.int32, device=dev)
    lengths = torch.full((B,), D, dtype=torch.int32, device=dev)
    idx = trees.root.long()
    leafs = idx.clone()
    sc = trees.nstat[b, 0, idx]
    env = trees.root_env.clone()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    step_kw = T.env_kw(cfg)
    for depth in range(D):
        if bool(done.all()):
            break
        live = ~done
        traces[:, depth] = torch.where(live, idx, traces[:, depth].long()).to(torch.int32)
        leafs = torch.where(live, idx, leafs)
        kids, sc_k, obs, kept = T._kids_stats(trees, idx)
        any_kid = kept.any(1) & live
        o = obs.clamp_min(0)
        bc = b[:, None]
        visits = torch.where(kept, trees.visits[bc, o], 0.0)
        n_total = visits.sum(1, keepdim=True)
        q_base = trees.values[bc, o] + sc_k - sc[:, None]
        var = trees.vars_[bc, o].clamp_min(0.0)
        vmax = trees.vmax[bc, o] if cfg.policy == "max" else None
        q = q_base + T.explore_bonus(cfg.policy, visits, var, n_total, q_base,
                                     rnd[:, depth], kept, vmax)
        low_mask = kept & (visits < cfg.low)
        any_low = low_mask.any(1, keepdim=True)
        neg = torch.tensor(-torch.inf, device=dev)
        cand = torch.where(any_low, torch.where(low_mask, gumbels[:, depth], neg),
                           torch.where(kept, q, neg))
        cmax = cand.max(1, keepdim=True).values
        choice = torch.where(cand == cmax, a7, N_ACTIONS).amin(1)
        pick = a7 == choice[:, None]
        nxt = torch.where(pick, kids, 0).sum(1)
        sc_n = torch.where(pick, sc_k, 0.0).sum(1)
        stepped = EP.packed_step(env, choice, **step_kw)
        env = torch.where((any_kid & (depth < D - 1))[:, None], stepped, env)
        newly_done = live & ~any_kid
        lengths = torch.where(newly_done, depth + 1, lengths)
        idx = torch.where(any_kid, nxt, idx)
        sc = torch.where(any_kid, sc_n, sc)
        done = done | newly_done
    _, packed, score, end = T.expand_children(env, cfg)
    return (traces, lengths, leafs.to(torch.int32), env, packed, score,
            end.to(torch.int32))


def select_walk(trees: T.Tree, gumbels, rnd, cfg: T.TreeConfig):
    """Selection walk + child stepping for B trees (see `select_walk_plain`
    for the contract): the CUDA kernel on a CUDA tree, the plain version on
    a CPU tree."""
    if not _on_cuda(trees.cbase):
        return select_walk_plain(trees, gumbels, rnd, cfg)
    B, N, M = _tree_checks(trees, cfg)
    D = cfg.max_depth
    _check("root", trees.root, torch.int32, (B,))
    _check("root_env", trees.root_env, torch.int32, (B, EP.STATE_WORDS))
    _check("gumbels", gumbels, torch.float32, (B, D, N_ACTIONS))
    _check("rnd", rnd, torch.float32, (B, D, N_ACTIONS))
    dev = trees.cbase.device
    i32 = lambda *s: torch.empty(*s, dtype=torch.int32, device=dev)
    out = (i32(B, D), i32(B), i32(B), i32(B, EP.STATE_WORDS),
           i32(B, N_ACTIONS, 20), i32(B, N_ACTIONS), i32(B, N_ACTIONS))
    e = cfg.env
    _launch("select_walk", trees.cbase, trees.nstat, trees.visits, trees.values,
            trees.vars_, trees.root, trees.root_env, gumbels, rnd, *out,
            B, N, M, D, POLICIES.index(cfg.policy), int(cfg.low),
            e.actions_per_drop, e.scoring, e.randomizer)
    return out


# ---------------------------------------------------------------------------
# obs-table insert
# ---------------------------------------------------------------------------

def insert_obs7(trees: T.Tree, packed7, end7, ok, cfg: T.TreeConfig):
    """Find-or-create the obs ids of every tree's 7 children, hashing,
    probing (linearly, or by double hashing under `cfg.probe_double`) and
    writing the fresh ids' obs rows; the plain version is
    `tree.insert_obs7_batched`. packed7 (B, 7, 20) int32, end7 (B, 7) bool,
    ok (B,) bool -> obs7 (B, 7) int32; the tree is updated in place."""
    if not _on_cuda(trees.cbase):
        return T.insert_obs7_batched(trees, packed7, end7, ok, cfg)
    B = packed7.shape[0]
    M = trees.visits.shape[1]
    Tsz = cfg.table_size
    if Tsz & (Tsz - 1) or M != cfg.max_obs:
        raise ValueError("insert kernel: table_size must be a power of two "
                         "and the obs pool max_obs wide")
    _check("packed7", packed7, torch.int32, (B, N_ACTIONS, 20))
    _check("end7", end7, torch.bool, (B, N_ACTIONS))
    _check("ok", ok, torch.bool, (B,))
    for f in ("tbl_h1", "tbl_h2", "tbl_obs"):
        _check(f, getattr(trees, f), torch.int32, (B, Tsz))
    _check("n_obs", trees.n_obs, torch.int32, (B,))
    _check("obs_end", trees.obs_end, torch.bool, (B, M))
    _check("obs_bits", trees.obs_bits, torch.int32, (B, 20, M))
    obs7 = torch.empty(B, N_ACTIONS, dtype=torch.int32, device=packed7.device)
    _launch("insert7_walk", packed7, end7, ok, trees.tbl_h1, trees.tbl_h2,
            trees.tbl_obs, trees.n_obs, trees.obs_end, trees.obs_bits, obs7,
            B, Tsz, M, int(cfg.probe_double))
    return obs7


def insert_fn_for(cfg: T.TreeConfig):
    """The insert every move program runs: `insert_obs7` (the kernel on a
    card), or the plain `tree.insert_obs7_batched` where the configuration
    turns the kernel off (`--insert_kernel 0`)."""
    return insert_obs7 if cfg.insert_kernel else T.insert_obs7_batched


# ---------------------------------------------------------------------------
# leaf-parallel seed + backup
# ---------------------------------------------------------------------------

def lp_backup_plain(trees: T.Tree, traces, lengths, v_nn, var_nn, expanded,
                    cfg: T.TreeConfig):
    """Plain form of the LP-backup kernel: `tree.lp_seed`, then
    `tree.backup_batched` from the averaged value."""
    v0, var0 = T.lp_seed(trees, traces, lengths, v_nn, var_nn, expanded, cfg)
    T.backup_batched(trees, traces, lengths, v0, var0, cfg)


def lp_backup(trees: T.Tree, traces, lengths, v_nn, var_nn, expanded,
              cfg: T.TreeConfig):
    """Seed each leaf's fresh unique children with (v_nn, var_nn), average
    them, and back the average up every trace (`backup_trace_obs_LP`).
    traces (B, D) int32, lengths (B,) int32, v_nn/var_nn (B, 7) float32,
    expanded (B,) bool; visits/values/vars_ are updated in place."""
    if not _on_cuda(trees.cbase):
        return lp_backup_plain(trees, traces, lengths, v_nn, var_nn, expanded, cfg)
    B, N, M = _tree_checks(trees, cfg)
    D = traces.shape[1]
    _check("traces", traces, torch.int32, (B, D))
    _check("lengths", lengths, torch.int32, (B,))
    _check("v_nn", v_nn, torch.float32, (B, N_ACTIONS))
    _check("var_nn", var_nn, torch.float32, (B, N_ACTIONS))
    _check("expanded", expanded, torch.bool, (B,))
    _launch("lp_backup_walk", traces, lengths, v_nn, var_nn, expanded,
            trees.cbase, trees.nstat, trees.end, trees.visits, trees.values,
            trees.vars_, B, N, M, D, float(cfg.gamma))


# ---------------------------------------------------------------------------
# backup from given (v0, var0): the leaf and rollout evaluators
# ---------------------------------------------------------------------------

def backup(trees: T.Tree, traces, lengths, v0, var0, cfg: T.TreeConfig):
    """Back (v0, var0) up every trace with the reverse Welford+gamma walk
    (`backup_trace_obs`); the plain version is `tree.backup_batched`.
    traces (B, D) int32, lengths (B,) int32, v0/var0 (B,) float;
    visits/values/vars_ are updated in place."""
    if not _on_cuda(trees.cbase):
        return T.backup_batched(trees, traces, lengths, v0, var0, cfg)
    B, N, M = _tree_checks(trees, cfg)
    D = traces.shape[1]
    _check("traces", traces, torch.int32, (B, D))
    _check("lengths", lengths, torch.int32, (B,))
    v0 = v0.to(torch.float32).contiguous()
    var0 = var0.to(torch.float32).contiguous()
    _check("v0", v0, torch.float32, (B,))
    _check("var0", var0, torch.float32, (B,))
    _launch("backup_walk", traces, lengths, v0, var0, trees.nstat, trees.visits,
            trees.values, trees.vars_, B, N, M, D, float(cfg.gamma))
