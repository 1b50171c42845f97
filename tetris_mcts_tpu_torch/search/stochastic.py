"""Stochastic-transition MCTS, the ValueSim2 agent, on the batched array
tree: counterpart of the reference package's `search/stochastic.py`.

The piece draw makes a transition stochastic, so every (obs, action) edge
keeps up to EDGE_CAP = 7 observed child obs (one per spawnable piece) with
a traversal count and the mean score delta of the edge, and every obs its
largest backed-up relative return (`max_ret`). One simulation for all B
trees:

- select: from the root, at every node the first action with no recorded
  child, else the first maximum of Q_a + U_a over the edge statistics of
  the node's obs (`_action_stats`):

      n_a      = sum of the edge's counts
      Q_a      = count-weighted mean of (child value + edge score delta)
      explore  = count-weighted mean of child max_ret / sqrt(child visits)
      p_new    = (distinct children + 0.5) / (n_a + 1)
      U_a      = sqrt(log max(sum n_a, 2)) (p_new vmax / sqrt(max(n_a, 1))
                                            + (1 - p_new) explore)

  (vmax the largest max_ret of the obs's children), until an unexpanded
  node; deterministic, no draws;
- replay the chosen path from the root env to the leaf's env;
- evaluate: the VV net's value on the leaf's board, v0 = leaf score + v
  where the leaf expands, else the leaf score;
- expand: the leaf's 7 children stepped (`tree.expand_children`), their obs
  ids found or created by the insert walk (`ops/tree_walk.insert_fn_for`:
  the CUDA insert kernel on a card), the node rows committed;
- backup: a reverse walk that backs the SAME v0 up every level (no γ): per
  obs, visit + 1, the Welford update of the relative return v0 - score and
  max_ret = max(max_ret, v0 - score); per edge (obs_t, a_t) -> obs_t+1, the
  child's slot (its match, else the first empty slot; a full row drops the
  write) gets count + 1 and the running mean of the score delta, a freshly
  claimed slot starting from zero.

A move: `sims` simulations, the greedy root action (first maximum of Q_a
over the actions with recorded children, action 0 when none has), the
edge-count policy, the real env step, the root advance, and, when a lane
is done, its pool full or its root lost (one host read a move), the
harvest-and-reset of those lanes; the harvest appends their rows to the VV
replay ring (`mcts.Replay`) when `store=True`.

Layout: the edge tables are (B, M, 7, C), so a level's gather at one obs
is one contiguous row of 49 entries (the reference keeps (7, C, M) a tree).
The reference's out-of-range writes with mode="drop" (dead lanes, the
leaf's and a full row's edge write) are writes masked to the old value.

The walks are the reference's while-loops over levels, run as bounded
lockstep loops of plain torch ops (the reference runs them as XLA loops):
the select walk checks "every lane is done" every `tree.WALK_EXIT_EVERY`
levels (a host read), and the replay and the backup run as many levels as
the select walk did; done lanes write nothing, so the checks change no
result. The backup's levels run strictly in order: one trace can hold an
obs twice.

Arithmetic, the same on the card and the CPU: the sums over an edge's 7
slots and over the 7 actions are taken in order, term by term; 1/sqrt(x)
is `reciprocal(sqrt(x))` (both IEEE-rounded, where CUDA's rsqrtf is an
approximation); the log of the integer-valued sum of n_a is taken in
float64 and rounded once. XLA's CPU rsqrt and float32 log are within an
ulp of these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.ops import tree_walk
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search.tree import N_ACTIONS, Tree, TreeConfig

EDGE_CAP = 7  # distinct child obs per (obs, action): one per spawnable piece


@dataclass
class S2Tree:
    """B stochastic-edge search trees: the shared array tree plus, per
    (obs, action), the edge tables, and per obs the largest return."""

    base: Tree
    edge_child: torch.Tensor   # int32 (B, M, 7, C) child obs ids, 0 = empty slot
    edge_count: torch.Tensor   # float32 (B, M, 7, C) traversal counts
    edge_dscore: torch.Tensor  # float32 (B, M, 7, C) mean score delta of the edge
    max_ret: torch.Tensor      # float32 (B, M) largest relative return

    def clone(self) -> "S2Tree":
        return S2Tree(self.base.clone(), self.edge_child.clone(), self.edge_count.clone(),
                      self.edge_dscore.clone(), self.max_ret.clone())


def init_s2_tree(env, cfg: TreeConfig) -> S2Tree:
    """Fresh trees rooted at packed states env (B, 44)."""
    base = T.init_tree(env, cfg)
    B, M = base.visits.shape
    shape = (B, M, N_ACTIONS, EDGE_CAP)
    return S2Tree(base, torch.zeros(shape, dtype=torch.int32, device=env.device),
                  torch.zeros(shape, device=env.device), torch.zeros(shape, device=env.device),
                  torch.zeros(B, M, device=env.device))


def init_s2_batch(seed: int, batch: int, cfg: mcts.SearchConfig, device="cuda"):
    """(s2trees, envs) for B fresh games; envs packed (B, 44) int32."""
    envs = engine.pack_state(engine.reset_batch(seed, batch, cfg.tree.env, device))
    return init_s2_tree(envs, cfg.tree), envs


def _rsqrt(x):
    return torch.reciprocal(torch.sqrt(x))


def _action_stats(s2: S2Tree, o):
    """The edge statistics of obs o (B,) int64 of every tree: (q (B, 7),
    u (B, 7), never (B, 7) bool: the actions with no recorded child, n_a
    (B, 7))."""
    base = s2.base
    B, M = base.visits.shape
    b = torch.arange(B, device=o.device)
    kids = s2.edge_child[b, o]                                  # (B, 7, C)
    counts = s2.edge_count[b, o]
    dsc = s2.edge_dscore[b, o]
    valid = kids > 0
    co = kids.long().clamp(0, M - 1).reshape(B, -1)
    cval = base.values.gather(1, co).view(valid.shape)
    cvis = base.visits.gather(1, co).view(valid.shape).clamp_min(1.0)
    cmax = s2.max_ret.gather(1, co).view(valid.shape)
    n_a = T.seq_sum(torch.where(valid, counts, 0.0))           # (B, 7)
    distinct = valid.sum(2).float()
    na1 = n_a.clamp_min(1.0)
    q = T.seq_sum(torch.where(valid, counts * (cval + dsc), 0.0)) / na1
    expl = T.seq_sum(torch.where(valid, counts * cmax * _rsqrt(cvis), 0.0)) / na1
    vmax = torch.where(valid, cmax, 0.0).amax((1, 2))
    p_new = (distinct + 0.5) / (n_a + 1.0)
    log_n = torch.log(T.seq_sum(n_a).double().clamp_min(2.0)).float()
    u = torch.sqrt(log_n)[:, None] * (p_new * vmax[:, None] * _rsqrt(na1)
                                      + (1.0 - p_new) * expl)
    return q, u, distinct == 0, n_a


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_batched(s2: S2Tree, cfg: TreeConfig):
    """The select walk of every tree (the reference `select_batched`).

    Returns (traces (B, D) int32, actions (B, D) int32, lengths (B,) int32,
    levels): lanes that never stop have length D; `levels` is the number of
    levels the loop ran (>= max(lengths))."""
    base = s2.base
    B = base.root.shape[0]
    D = cfg.max_depth
    dev = base.root.device
    b = torch.arange(B, device=dev)
    traces = torch.zeros(B, D, dtype=torch.int32, device=dev)
    acts = torch.zeros(B, D, dtype=torch.int32, device=dev)
    lengths = torch.full((B,), D, dtype=torch.int32, device=dev)
    idx = base.root.long()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    levels = D
    for depth in range(D):
        if depth % T.WALK_EXIT_EVERY == 0 and depth and bool(done.all()):
            levels = depth
            break
        live = ~done
        traces[:, depth] = torch.where(live, idx.to(torch.int32), traces[:, depth])
        q, u, never, _ = _action_stats(s2, base.nstat[b, 1, idx].long())
        a = torch.where(never.any(1), T.first_max(never.float()), T.first_max(q + u))
        acts[:, depth] = torch.where(live, a.to(torch.int32), acts[:, depth])
        cb = base.cbase[b, idx].long()
        nxt = torch.where(cb != 0, cb + a, 0)
        newly_done = live & (nxt == 0)
        lengths = torch.where(newly_done, depth + 1, lengths)
        idx = torch.where(live & (nxt != 0), nxt, idx)
        done = done | newly_done
    return traces, acts, lengths, levels


# ---------------------------------------------------------------------------
# backup
# ---------------------------------------------------------------------------

def backup_batched(s2: S2Tree, traces, actions, lengths, values, levels: int | None = None):
    """Reverse walk up every trace (the reference `backup_batched`), in
    place: step k handles level length-1-k of every lane, strictly in
    order. values (B,) the absolute value backed up at every level.
    `levels` >= max(lengths) bounds the walk (default: max(lengths), a host
    read); lanes past their root write nothing."""
    base = s2.base
    B = lengths.shape[0]
    N = base.cbase.shape[1]
    b = torch.arange(B, device=lengths.device)
    lengths = lengths.long()
    values = values.float()
    last = (lengths - 1).clamp_min(0)
    if levels is None:
        levels = int(lengths.max())
    for k in range(levels):
        t = lengths - 1 - k
        live = t >= 0
        tt = t.clamp_min(0)
        idx = traces[b, tt].long()
        s = base.nstat[b, 0, idx]
        o = base.nstat[b, 1, idx].long()

        v_rel = values - s
        n, valo, varo = base.visits[b, o], base.values[b, o], base.vars_[b, o]
        first = n == 0.0
        delta = v_rel - valo
        val_new = torch.where(first, v_rel, valo + delta / (n + 1.0))
        delta2 = v_rel - val_new
        var_new = torch.where(first, 0.0, varo + (delta * delta2 - varo) / (n + 1.0))
        base.visits[b, o] = torch.where(live, n + 1.0, n)
        base.values[b, o] = torch.where(live, val_new, valo)
        base.vars_[b, o] = torch.where(live, var_new, varo)
        mx = s2.max_ret[b, o]
        s2.max_ret[b, o] = torch.where(live, torch.maximum(mx, v_rel), mx)

        # the edge into the next level, where this node is not the leaf
        has_child = live & (t < lengths - 1)
        child = traces[b, torch.minimum(tt + 1, last)].long()
        a = actions[b, tt].long()
        oc = base.nstat[b, 1, child.clamp_max(N - 1)].to(torch.int32)
        ds = base.nstat[b, 0, child] - s
        slots = s2.edge_child[b, o, a]                          # (B, C)
        match = (slots == oc[:, None]) & has_child[:, None]
        fresh = ~match.any(1)
        empty = slots == 0
        j = torch.where(fresh, torch.where(empty.any(1), T.first_max(empty.float()), EDGE_CAP),
                        T.first_max(match.float()))
        write = has_child & (j < EDGE_CAP)
        jc = j.clamp_max(EDGE_CAP - 1)
        c_old = torch.where(fresh, 0.0, s2.edge_count[b, o, a, jc])
        d_old = torch.where(fresh, 0.0, s2.edge_dscore[b, o, a, jc])
        c_new = c_old + 1.0
        d_new = d_old + (ds - d_old) / c_new
        for tbl, val in ((s2.edge_child, oc), (s2.edge_count, c_new),
                         (s2.edge_dscore, d_new)):
            tbl[b, o, a, jc] = torch.where(write, val, tbl[b, o, a, jc])


# ---------------------------------------------------------------------------
# root statistics, reset
# ---------------------------------------------------------------------------

def root_stats(s2: S2Tree):
    """(greedy action (B,) int32, edge-count policy (B, 7), root value (B,))
    (the reference `best_action`, `visit_probs` and the root obs's value)."""
    base = s2.base
    b = torch.arange(base.root.shape[0], device=base.root.device)
    o = base.nstat[b, 1, base.root.long()].long()
    q, _, _, n_a = _action_stats(s2, o)
    action = T.first_max(torch.where(n_a > 0, q, -torch.inf)).to(torch.int32)
    tot = T.seq_sum(n_a)[:, None]
    probs = torch.where(tot > 0, n_a / tot.clamp_min(1e-9), 1.0 / N_ACTIONS)
    return action, probs, base.values[b, o]


def reset_s2_trees(s2: S2Tree, env, mask, cfg: TreeConfig):
    """Where mask (B,): wipe the tree, edge tables and max_ret, and re-root
    at env (B, 44)."""
    T.reset_trees(s2.base, env, mask, cfg)
    m = mask[:, None, None, None]
    for tbl in (s2.edge_child, s2.edge_count, s2.edge_dscore):
        tbl.masked_fill_(m, 0)
    s2.max_ret.masked_fill_(mask[:, None], 0.0)


# ---------------------------------------------------------------------------
# the move program
# ---------------------------------------------------------------------------

class S2MoveStats(NamedTuple):
    action: torch.Tensor      # int32 (B,)
    probs: torch.Tensor       # float32 (B, 7) edge-count policy
    root_value: torch.Tensor  # float32 (B,)
    score: torch.Tensor       # (B,) score after the move
    lines: torch.Tensor
    done: torch.Tensor        # bool (B,) episode ended on this move
    reset: torch.Tensor       # bool (B,) tree was wiped and re-rooted


def make_s2_move_fn(apply_fn: Callable, cfg: mcts.SearchConfig, min_visits_store: int = 10,
                    store: bool = True):
    """`move(s2trees, envs, replay=None) -> (envs, S2MoveStats)`: one
    batched ValueSim2 move. apply_fn: float images (n, 1, 20, 10) -> (v
    (n,), var (n,)), the VV net; only v is read. s2trees (and the ring,
    which `store=True` requires) are updated in place; envs are packed (B,
    44) int32. `move.levels` holds the select levels of every simulation of
    the last move."""
    tcfg = cfg.tree
    guard = mcts.capacity_guard_for(cfg.sims, tcfg, cfg.allow_clamp)
    env_kw = T.env_kw(tcfg)
    insert = tree_walk.insert_fn_for(tcfg)

    def sim_once(s2: S2Tree):
        base = s2.base
        traces, actions, lengths, levels = select_batched(s2, tcfg)
        b = torch.arange(lengths.shape[0], device=lengths.device)
        leafs = traces[b, (lengths.long() - 1).clamp_min(0)]
        lc = leafs.long()
        leaf_env = T.replay_leaf(base, actions, lengths, tcfg, levels)
        can = ~base.end[b, lc] & (base.cbase[b, lc] == 0) & T.headroom(base, tcfg)

        v, _ = apply_fn(engine.unpack_obs(EP.packed_obs(leaf_env))[:, None].float())

        _, packed7, score7, end7 = T.expand_children(leaf_env, tcfg)
        obs7 = insert(base, packed7.contiguous(), end7, can, tcfg)
        T.expand_commit(base, score7, end7, obs7, leafs, can)

        leaf_score = base.nstat[b, 0, lc]
        value = torch.where(can, leaf_score + v.float(), leaf_score)
        backup_batched(s2, traces, actions, lengths, value, levels)
        return levels

    def move(s2: S2Tree, envs, replay: mcts.Replay | None = None):
        if store and replay is None:
            raise ValueError("a move with store=True needs the replay ring")
        move.levels = [sim_once(s2) for _ in range(cfg.sims)]
        base = s2.base
        action, probs, rv = root_stats(s2)
        envs2 = EP.packed_step(envs, action, **env_kw)
        T.advance_root(base, action, envs2, tcfg)
        done = envs2[:, 43] != 0
        full = (base.n_nodes + guard > tcfg.max_nodes) | (base.n_obs + guard > tcfg.max_obs)
        trigger = done | full | (base.root == 0)
        fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), tcfg.env))
        envs3 = torch.where(done[:, None], fresh, envs2)
        if bool(trigger.any()):  # the move's one host read
            if store:
                packed, val, var, w, mask = T.harvest(base, min_visits_store)
                mcts.replay_add(replay, packed, val, var, w, mask & trigger[:, None])
            reset_s2_trees(s2, envs3, trigger, tcfg)
        return envs3, S2MoveStats(action=action, probs=probs, root_value=rv,
                                  score=envs2[:, 36], lines=envs2[:, 38], done=done,
                                  reset=trigger)

    move.levels = []
    return move
