"""Distributional (C51) MCTS, the DistValueSim agent, on the batched array
tree: counterpart of the reference package's `search/distributional.py`.

Every obs slot carries a categorical value distribution over `atoms` bins
on [0, vmax] (bin centers (b + 0.5) vmax / atoms) and the Welford M2 of the
scalar value. One simulation for all B trees:

- select: from the root, the unique-by-obs children of each node; a kept
  child with fewer than `low` visits is chosen first (the largest of the
  level's gumbels among them), else the first maximum of q = value + child
  score - node score + norm_quantile(sum n) sqrt(m2 / ((n - 1 + 1e-3)(n +
  1e-3))) (the reference's own standard-error rule, not `tree.explore_bonus`),
  until an unexpanded node;
- replay the chosen path from the root env to the leaf's env;
- evaluate: the net's distribution on the leaf's board where the leaf
  expands, else a point mass on bin 0;
- expand: the leaf's 7 children stepped (`tree.expand_children`), their obs
  ids found or created by the insert walk (`ops/tree_walk.insert_fn_for`:
  the CUDA insert kernel on a card), the node rows committed;
- backup: a reverse walk that, at every level, shifts the leaf's
  distribution by the reward delta r - score(node) (r the leaf's score),
  folds it into the obs's running-mean distribution, and runs the Welford
  update of (visits, value, m2) on x = mean(leaf distribution) + delta.

A move: `sims` simulations, the greedy root action (first-max child q), the
real env step, the root advance, and, when a lane is done, its pool full or
its root lost (one host read a move), the harvest-and-reset of those lanes;
the harvest appends their rows (board, target distribution, visits as
weight) to the replay ring (`DistReplay`) when `store=True`.

The walks are the reference's while-loops over levels, run as bounded
lockstep loops of plain torch ops (the reference runs them as XLA loops):
the select walk checks "every lane is done" every `tree.WALK_EXIT_EVERY`
levels (a host read), and the replay and the backup run as many levels as
the select walk did; done lanes write nothing, so the checks change no
result. The backup's levels run strictly in order: one trace can hold an
obs twice.

Fixed summation orders, the same on the card and the CPU: the shift writes
each bin the sum of its terms in a pairwise tree over the 2 x atoms source
terms (lower bins first, then upper, each by source bin), and `mean_dist`
sums its products in the same pairwise tree. Under a shift x >= 0 (the
search's: scores only grow down a path) every bin below the clamped top
one receives at most one term of each kind, so it is exactly the
reference's; the top bin (and the mean, and the bins 0-1 that a negative
shift clamps) can differ from XLA's sequential sums by float32 rounding. The shift's bin position x / Δ is x times the
float32 reciprocal of Δ, as XLA computes the reference's division by a
constant; the other divisions take tensor divisors (CUDA turns a Python
scalar divisor into a multiply by its reciprocal).

Randomness: the select walk takes (B, D, 7) gumbels a simulation,
`planes.level_gumbels(B, D)` (`mcts.TorchPlanes`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, NamedTuple

import numpy as np
import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.ops import tree_walk
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search.quantiles import norm_quantile
from tetris_mcts_tpu_torch.search.tree import Tree, TreeConfig

EPS = 1e-3  # the select rule's visit offsets


class DistConfig(NamedTuple):
    atoms: int = 50
    vmax: float = 1000.0  # support [0, vmax], centers (b + 0.5) * vmax / atoms
    low: int = 5          # visits under which a child is chosen first


@dataclass
class DistTree:
    """B distributional search trees: the shared array tree plus, per obs,
    the running-mean value distribution and the Welford M2."""

    base: Tree
    obs_dist: torch.Tensor  # float32 (B, atoms, M)
    obs_m2: torch.Tensor    # float32 (B, M)

    def clone(self) -> "DistTree":
        return DistTree(self.base.clone(), self.obs_dist.clone(), self.obs_m2.clone())


def init_dist_tree(env, cfg: TreeConfig, dcfg: DistConfig) -> DistTree:
    """Fresh trees rooted at packed states env (B, 44)."""
    base = T.init_tree(env, cfg)
    B, M = base.visits.shape
    return DistTree(base, torch.zeros(B, dcfg.atoms, M, device=env.device),
                    torch.zeros(B, M, device=env.device))


def init_dist_batch(seed: int, batch: int, cfg: mcts.SearchConfig, dcfg: DistConfig,
                    device="cuda"):
    """(dtrees, envs) for B fresh games; envs packed (B, 44) int32."""
    envs = engine.pack_state(engine.reset_batch(seed, batch, cfg.tree.env, device))
    return init_dist_tree(envs, cfg.tree, dcfg), envs


def centers(dcfg: DistConfig, device="cpu"):
    """The bin centers (atoms,) float32."""
    return (torch.arange(dcfg.atoms, dtype=torch.float32, device=device) + 0.5) * (
        dcfg.vmax / dcfg.atoms)


def _pairwise_sum(x):
    """The sum over the last axis as a pairwise tree: zero-padded to a power
    of two, then halves added until one column is left. Elementwise adds
    only, so the card and the CPU round alike."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], width - n)], -1)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def mean_dist(dist, dcfg: DistConfig):
    """E[dist] over the bin centers (the reference `mean_dist`),
    dist (..., atoms)."""
    return _pairwise_sum(dist * centers(dcfg, dist.device))


def shift_distribution_batched(dist, x, dcfg: DistConfig):
    """Move the mass of every lane's distribution dist (B, atoms) up by x
    (B,) value units (the reference `shift_distribution_batched`): source
    bin b sends (1 - f) of its mass to bin clip(b + k) and f to clip(b + k
    + 1), k = floor(x / Δ), f = x / Δ - k, clamped at both ends. Each
    target bin sums its terms in the module's fixed order."""
    B, atoms = dist.shape
    dev = dist.device
    # x / Δ as XLA computes the reference's: times the float32 reciprocal of Δ
    inv_delta = float(np.float32(1.0) / np.float32(dcfg.vmax / atoms))
    bin_shift = x.float() * inv_delta
    fl = torch.floor(bin_shift)
    fraction = (bin_shift - fl)[:, None]
    b = torch.arange(atoms, device=dev)
    lb = (b[None, :] + fl[:, None]).to(torch.int32).clamp(0, atoms - 1).long()
    ub = (lb + 1).clamp(0, atoms - 1)
    # terms (B, 2 atoms): source bins' lower shares, then their upper shares
    terms = torch.cat([dist * (1.0 - fraction), dist * fraction], 1)
    dst = torch.cat([lb, ub], 1)
    hit = dst[:, None, :] == b[None, :, None]                 # (B, atoms, 2 atoms)
    return _pairwise_sum(torch.where(hit, terms[:, None, :], 0.0))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_batched(dts: DistTree, gumbels, cfg: TreeConfig, dcfg: DistConfig):
    """The select walk of every tree (the reference `select_batched`), with
    the level's gumbels (B, D, 7) for the low-visit choice.

    Returns (traces (B, D) int32, actions (B, D) int32, lengths (B,) int32,
    levels): lanes that never stop have length D; `levels` is the number of
    levels the loop ran (>= max(lengths))."""
    base = dts.base
    B = base.root.shape[0]
    D = cfg.max_depth
    dev = base.root.device
    b = torch.arange(B, device=dev)
    bc = b[:, None]
    traces = torch.zeros(B, D, dtype=torch.int32, device=dev)
    acts = torch.zeros(B, D, dtype=torch.int32, device=dev)
    lengths = torch.full((B,), D, dtype=torch.int32, device=dev)
    idx = base.root.long()
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eps = torch.tensor(EPS, device=dev)
    levels = D
    for depth in range(D):
        if depth % T.WALK_EXIT_EVERY == 0 and depth and bool(done.all()):
            levels = depth
            break
        live = ~done
        traces[:, depth] = torch.where(live, idx.to(torch.int32), traces[:, depth])
        kids, sc, obs, kept = T._kids_stats(base, idx)
        any_kid = kept.any(1)
        o = obs.clamp_min(0)
        visits = torch.where(kept, base.visits[bc, o], 0.0)
        low_mask = kept & (visits < dcfg.low)
        any_low = low_mask.any(1)
        low_choice = T.first_max(torch.where(low_mask, gumbels[:, depth], -torch.inf))
        n_total = visits.sum(1, keepdim=True)
        q = (base.values[bc, o] + sc - base.nstat[b, 0, idx][:, None]
             + norm_quantile(n_total) * torch.sqrt(torch.clamp_min(
                 dts.obs_m2[bc, o] / ((visits - 1.0 + eps) * (visits + eps)), 0.0)))
        clt_choice = T.first_max(torch.where(kept, q, -torch.inf))
        choice = torch.where(any_low, low_choice, clt_choice)
        acts[:, depth] = torch.where(live, torch.where(any_kid, choice, 0).to(torch.int32),
                                     acts[:, depth])
        nxt = kids.gather(1, choice[:, None])[:, 0]
        newly_done = live & ~any_kid
        lengths = torch.where(newly_done, depth + 1, lengths)
        idx = torch.where(live & any_kid, nxt, idx)
        done = done | newly_done
    return traces, acts, lengths, levels


# ---------------------------------------------------------------------------
# backup
# ---------------------------------------------------------------------------

def backup_batched(dts: DistTree, traces, lengths, r, dist, dcfg: DistConfig,
                   levels: int | None = None):
    """Reverse walk up every trace (the reference `backup_batched`), in
    place: step k handles level length-1-k of every lane, strictly in order.
    Per level with o the node's obs and Δ = r - score(node): the obs's
    distribution becomes the running mean (dist_o n + shift(dist, Δ)) / (n
    + 1), and (visits, value, m2) take the Welford update of x = mean(dist)
    + Δ. r (B,) the leaf scores, dist (B, atoms). `levels` >= max(lengths)
    bounds the walk (default: max(lengths), a host read); lanes past their
    root write nothing."""
    base = dts.base
    B = lengths.shape[0]
    b = torch.arange(B, device=lengths.device)
    lengths = lengths.long()
    r = r.float()
    dist = dist.float()
    mean0 = mean_dist(dist, dcfg)
    if levels is None:
        levels = int(lengths.max())
    for k in range(levels):
        t = lengths - 1 - k
        live = t >= 0
        idx = traces[b, t.clamp_min(0)].long()
        s = base.nstat[b, 0, idx]
        o = base.nstat[b, 1, idx].long()
        delta_r = r - s
        new_dist = shift_distribution_batched(dist, delta_r, dcfg)
        n = base.visits[b, o]
        cur = dts.obs_dist[b, :, o]                            # (B, atoms)
        merged = (cur * n[:, None] + new_dist) / (n[:, None] + 1.0)
        dts.obs_dist[b, :, o] = torch.where(live[:, None], merged, cur)
        x = mean0 + delta_r
        valo, m2o = base.values[b, o], dts.obs_m2[b, o]
        delta = x - valo
        val_new = valo + delta / (n + 1.0)
        delta2 = x - val_new
        dts.obs_m2[b, o] = torch.where(live, m2o + delta * delta2, m2o)
        base.visits[b, o] = torch.where(live, n + 1.0, n)
        base.values[b, o] = torch.where(live, val_new, valo)


# ---------------------------------------------------------------------------
# harvest, reset, replay ring
# ---------------------------------------------------------------------------

def harvest(dts: DistTree, min_visits: int):
    """Training rows of every tree (the reference `harvest`): each obs slot
    in use, not terminal, with visits >= min_visits. Returns (packed (B, M,
    20) int32, target distribution (B, M, atoms), weight = visits (B, M),
    mask (B, M) bool)."""
    packed, _, _, visits, mask = T.harvest(dts.base, min_visits)
    return packed, dts.obs_dist.permute(0, 2, 1), visits, mask


def reset_dist_trees(dts: DistTree, env, mask, cfg: TreeConfig):
    """Where mask (B,): wipe the tree, distributions and M2, and re-root at
    env (B, 44)."""
    T.reset_trees(dts.base, env, mask, cfg)
    dts.obs_dist.masked_fill_(mask[:, None, None], 0.0)
    dts.obs_m2.masked_fill_(mask[:, None], 0.0)


@dataclass
class DistReplay:
    """The training-memory ring of the distributional agent (the reference
    `DistReplay`): packed boards, target distributions (R, atoms) and visit
    weights, with `mcts.Replay`'s sink rows and counters (`cand` stays 0:
    this store has no stochastic drop)."""

    capacity: int
    boards: torch.Tensor   # int32 (R + sink, 20)
    dist: torch.Tensor     # float32 (R + sink, atoms)
    weight: torch.Tensor   # float32 (R + sink,)
    idx: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor
    cand: torch.Tensor
    drop_prob: torch.Tensor

    def arrays(self):
        return self.boards, self.dist, self.weight

    def rows(self):
        """The ring rows (boards, dist, weight), sink excluded."""
        return tuple(a[:self.capacity] for a in self.arrays())


def init_dist_replay(capacity: int, atoms: int, device="cuda") -> DistReplay:
    rep = mcts.init_replay(capacity, device)
    kw = {f.name: getattr(rep, f.name) for f in fields(rep) if f.name not in ("value", "var")}
    return DistReplay(dist=torch.zeros(capacity + mcts.REPLAY_SINK, atoms, device=device),
                      **kw)


def dist_replay_add(rep: DistReplay, packed, dist, weight, mask):
    """Append the masked rows (any leading shape, flattened; dist with a
    trailing atoms axis) at the ring's head, in place (`mcts.replay_add`'s
    rules)."""
    atoms = rep.dist.shape[1]
    mcts.append_rows(rep, (packed.reshape(-1, 20), dist.reshape(-1, atoms),
                           weight.reshape(-1)), mask.reshape(-1))


# ---------------------------------------------------------------------------
# the move program
# ---------------------------------------------------------------------------

class DistMoveStats(NamedTuple):
    action: torch.Tensor      # int32 (B,)
    probs: torch.Tensor       # float32 (B, 7) visit-proportional policy
    root_value: torch.Tensor  # float32 (B,)
    score: torch.Tensor       # (B,) score after the move
    lines: torch.Tensor
    done: torch.Tensor        # bool (B,) episode ended on this move
    reset: torch.Tensor       # bool (B,) tree was wiped and re-rooted


def make_dist_move_fn(apply_fn: Callable, cfg: mcts.SearchConfig, dcfg: DistConfig, planes,
                      min_visits_store: int = 10, store: bool = True):
    """`move(dtrees, envs, replay=None) -> (envs, DistMoveStats)`: one
    batched DistValueSim move. apply_fn: float images (n, 1, 20, 10) -> (n,
    atoms) probabilities. `planes.level_gumbels(B, D)` gives the select
    walk's draws. dtrees (and the ring, which `store=True` requires) are
    updated in place; envs are packed (B, 44) int32. `move.levels` holds
    the select levels of every simulation of the last move."""
    tcfg = cfg.tree
    guard = mcts.capacity_guard_for(cfg.sims, tcfg, cfg.allow_clamp)
    env_kw = T.env_kw(tcfg)
    insert = tree_walk.insert_fn_for(tcfg)

    def sim_once(dts: DistTree):
        base = dts.base
        B = base.root.shape[0]
        traces, actions, lengths, levels = select_batched(
            dts, planes.level_gumbels(B, tcfg.max_depth), tcfg, dcfg)
        b = torch.arange(B, device=lengths.device)
        leafs = traces[b, (lengths.long() - 1).clamp_min(0)]
        lc = leafs.long()
        leaf_env = T.replay_leaf(base, actions, lengths, tcfg, levels)
        can = ~base.end[b, lc] & (base.cbase[b, lc] == 0) & T.headroom(base, tcfg)

        dist = apply_fn(engine.unpack_obs(EP.packed_obs(leaf_env))[:, None].float()).float()
        # a leaf that does not expand backs up a point mass on bin 0
        point0 = torch.zeros_like(dist)
        point0[:, 0] = 1.0
        dist = torch.where(can[:, None], dist, point0)

        _, packed7, score7, end7 = T.expand_children(leaf_env, tcfg)
        obs7 = insert(base, packed7.contiguous(), end7, can, tcfg)
        T.expand_commit(base, score7, end7, obs7, leafs, can)

        r = base.nstat[b, 0, lc]  # the leaf's score
        backup_batched(dts, traces, lengths, r, dist, dcfg, levels)
        return levels

    def move(dts: DistTree, envs, replay: DistReplay | None = None):
        if store and replay is None:
            raise ValueError("a move with store=True needs the replay ring")
        move.levels = [sim_once(dts) for _ in range(cfg.sims)]
        base = dts.base
        b = torch.arange(envs.shape[0], device=envs.device)
        stats = T.compute_stats(base)
        action = T.best_action(stats)
        probs = T.visit_probs(stats)
        rv = base.values[b, base.nstat[b, 1, base.root.long()].long()]
        envs2 = EP.packed_step(envs, action, **env_kw)
        T.advance_root(base, action, envs2, tcfg)
        done = envs2[:, 43] != 0
        full = (base.n_nodes + guard > tcfg.max_nodes) | (base.n_obs + guard > tcfg.max_obs)
        trigger = done | full | (base.root == 0)
        fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), tcfg.env))
        envs3 = torch.where(done[:, None], fresh, envs2)
        if bool(trigger.any()):  # the move's one host read
            if store:
                packed, dists, w, mask = harvest(dts, min_visits_store)
                dist_replay_add(replay, packed, dists, w, mask & trigger[:, None])
            reset_dist_trees(dts, envs3, trigger, tcfg)
        return envs3, DistMoveStats(action=action, probs=probs, root_value=rv,
                                    score=envs2[:, 36], lines=envs2[:, 38], done=done,
                                    reset=trigger)

    move.levels = []
    return move
