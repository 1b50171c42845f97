"""Policy-iteration MCTS (the ApproxPolicyIter agent) on the batched array
tree: counterpart of the reference package's `search/vp.py`.

One simulation for all B trees:

- select: from the root, sample the action at every node from the stored
  net policy (`prior`, per obs) until an unexpanded node; zero priors
  sample uniformly;
- replay the sampled path from the root env to the leaf's env;
- evaluate: the VP net on the leaf's board, (value, policy logits); the
  softmax seeds the leaf obs's prior where the leaf expands;
- expand: the leaf's 7 children stepped (`tree.expand_children`), their
  obs ids found or created by the insert walk (`ops/tree_walk.insert_obs7`:
  the CUDA insert kernel on a card), the node rows committed;
- backup: a reverse walk that, at every level, counts a visit, moves the
  obs's value to the running mean of (leaf score + net value, or the leaf
  score where nothing expanded) minus the node's score (undiscounted), and
  adds one to the improvement count `pol_new` of the greedy child (the
  first-max child q = value + child score - node score, taken before this
  level's value write).

A move: `sims` simulations, the greedy root action (first-max child q),
the real env step, the root advance, and the harvest-and-reset of every
lane that is done, whose pool is full, or whose root is lost; the harvest
appends the lane's rows (board, value, improvement policy normalised to a
distribution, visits as weight) to the replay ring (`VPReplay`) when
`store=True`.

The prior and the improvement counts live on obs slots, laid out (B, 7, M).
The walks are the reference's while-loops over levels, run as bounded
lockstep loops of plain torch ops: the select walk checks "every lane is
done" every `tree.WALK_EXIT_EVERY` levels (a host read), and the replay
and the backup run as many levels as the select walk did; done lanes are
no-ops, so the checks change no result.

Randomness: the select walk takes one uniform [0, 1) draw a lane a level,
(B, D) planes from `planes.uniforms(B, D)` (`mcts.TorchPlanes`), and
samples as `jax.random.choice(k, 7, p=probs)` does: with the 7-term
cumulative sum c taken in order, the first action whose c is >= c[6] * (1 -
u).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, NamedTuple

import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.ops import tree_walk
from tetris_mcts_tpu_torch.search import mcts
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search.tree import N_ACTIONS, Tree, TreeConfig


@dataclass
class VPTree:
    """B value/policy search trees: the shared array tree plus the net
    policy (0 = unexpanded) and the improvement counts, per obs."""

    base: Tree
    prior: torch.Tensor    # float32 (B, 7, M)
    pol_new: torch.Tensor  # float32 (B, 7, M) exact integer counts

    def clone(self) -> "VPTree":
        return VPTree(self.base.clone(), self.prior.clone(), self.pol_new.clone())


def init_vp_tree(env, cfg: TreeConfig) -> VPTree:
    """Fresh trees rooted at packed states env (B, 44)."""
    base = T.init_tree(env, cfg)
    z = torch.zeros(env.shape[0], N_ACTIONS, cfg.max_obs, device=env.device)
    return VPTree(base, z, z.clone())


def init_vp_batch(seed: int, batch: int, cfg: mcts.SearchConfig, device="cuda"):
    """(vtrees, envs) for B fresh games; envs packed (B, 44) int32."""
    envs = engine.pack_state(engine.reset_batch(seed, batch, cfg.tree.env, device))
    return init_vp_tree(envs, cfg.tree), envs


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_batched(vts: VPTree, uniforms, cfg: TreeConfig):
    """Sample a path in every tree by the stored priors (the reference
    `select_batched`): at node idx, a ~ probs(prior[:, obs(idx)]) with the
    level's uniform, then child cbase[idx] + a, until an unexpanded node.
    uniforms (B, D) float32 in [0, 1).

    Returns (traces (B, D) int32, actions (B, D) int32, lengths (B,) int32,
    levels): lanes that never stop have length D; `levels` is the number of
    levels the loop ran (>= max(lengths))."""
    base = vts.base
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
        o = base.nstat[b, 1, idx].long()
        p = vts.prior[b, :, o]                                    # (B, 7)
        total = T.seq_sum(p)
        probs = torch.where((total > 0)[:, None],
                            p / torch.clamp_min(total, 1e-9)[:, None], 1.0 / N_ACTIONS)
        cum = [probs[:, 0]]
        for a in range(1, N_ACTIONS):
            cum.append(cum[-1] + probs[:, a])
        cum = torch.stack(cum, 1)
        r = cum[:, -1] * (1.0 - uniforms[:, depth])
        a = (cum < r[:, None]).sum(1)                     # searchsorted, side left
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

def backup_value_policy_batched(vts: VPTree, traces, lengths, values, levels: int):
    """Reverse walk up every trace (the reference
    `backup_value_policy_batched`), in place: step k handles level
    length-1-k of every lane, strictly in order (one trace can hold an obs
    twice). Per level: visit + 1, value += (v - score - value) / visits,
    and pol_new + 1 at (greedy child action, obs), the greedy child from
    the values before this level's write. `levels` >= max(lengths) bounds
    the walk; lanes past their root are no-ops."""
    base = vts.base
    B, M = base.visits.shape
    b = torch.arange(B, device=lengths.device)
    lengths = lengths.long()
    values = values.float()
    for k in range(levels):
        t = lengths - 1 - k
        live = t >= 0
        idx = traces[b, t.clamp_min(0)].long()
        s = base.nstat[b, 0, idx]
        o = base.nstat[b, 1, idx].long()
        v_rel = values - s
        n, valo = base.visits[b, o], base.values[b, o]
        new_visit = n + 1.0
        val_new = valo + (v_rel - valo) / new_visit
        kids = T.children_of(base, idx)
        ksc = base.nstat[b[:, None], 0, kids]
        kobs = base.nstat[b[:, None], 1, kids].long().clamp_max(M - 1)
        q = torch.where(kids != 0, base.values[b[:, None], kobs] + ksc - s[:, None],
                        -torch.inf)
        amax = T.first_max(q)
        base.visits[b, o] = torch.where(live, new_visit, n)
        base.values[b, o] = torch.where(live, val_new, valo)
        vts.pol_new[b, amax, o] += live.float()


# ---------------------------------------------------------------------------
# root stats
# ---------------------------------------------------------------------------

def best_action(vts: VPTree):
    """Greedy first-max over the root children's q, (B,) int32."""
    return T.best_action(T.compute_stats(vts.base))


def root_policy(vts: VPTree):
    """The root's improvement counts normalised to a distribution (uniform
    where there are none), (B, 7)."""
    base = vts.base
    b = torch.arange(base.root.shape[0], device=base.root.device)
    o = base.nstat[b, 1, base.root.long()].long()
    counts = vts.pol_new[b, :, o]
    total = T.seq_sum(counts)[:, None]
    return torch.where(total > 0, counts / torch.clamp_min(total, 1e-9), 1.0 / N_ACTIONS)


def harvest(vts: VPTree, min_visits: int):
    """Training rows of every tree (the reference `harvest`): each obs slot
    in use, not terminal, with visits >= min_visits. Returns (packed (B, M,
    20) int32, value (B, M), policy (B, M, 7), weight = visits (B, M), mask
    (B, M) bool)."""
    base = vts.base
    packed, value, _, visits, mask = T.harvest(base, min_visits)
    counts = vts.pol_new
    totals = counts.sum(1, keepdim=True)   # exact: integer counts
    pol = torch.where(totals > 0, counts / torch.clamp_min(totals, 1e-9), 1.0 / N_ACTIONS)
    return packed, value, pol.permute(0, 2, 1), visits, mask


def reset_vp_trees(vts: VPTree, env, mask, cfg: TreeConfig):
    """Where mask (B,): wipe the tree, priors and counts, and re-root at
    env (B, 44)."""
    T.reset_trees(vts.base, env, mask, cfg)
    m = mask[:, None, None]
    vts.prior.masked_fill_(m, 0.0)
    vts.pol_new.masked_fill_(m, 0.0)


# ---------------------------------------------------------------------------
# replay ring
# ---------------------------------------------------------------------------

@dataclass
class VPReplay:
    """The training-memory ring of the VP agent (the reference `VPReplay`):
    `mcts.Replay`'s layout with a policy column (R, 7) in place of the
    variance. `cand` stays 0: the VP store has no stochastic drop, and the
    reference reads 0 for a ring without the counter."""

    capacity: int
    boards: torch.Tensor   # int32 (R + sink, 20)
    value: torch.Tensor    # float32 (R + sink,)
    policy: torch.Tensor   # float32 (R + sink, 7)
    weight: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor
    cand: torch.Tensor
    drop_prob: torch.Tensor

    def arrays(self):
        return self.boards, self.value, self.policy, self.weight

    def rows(self):
        """The ring rows (boards, value, policy, weight), sink excluded."""
        return tuple(a[:self.capacity] for a in self.arrays())


def init_vp_replay(capacity: int, device="cuda") -> VPReplay:
    rep = mcts.init_replay(capacity, device)
    kw = {f.name: getattr(rep, f.name) for f in fields(rep) if f.name != "var"}
    return VPReplay(policy=torch.zeros(capacity + mcts.REPLAY_SINK, N_ACTIONS,
                                       device=device), **kw)


def vp_replay_add(rep: VPReplay, packed, value, policy, weight, mask):
    """Append the masked rows (any leading shape, flattened; policy with a
    trailing 7) at the ring's head, in place (`mcts.replay_add`'s rules)."""
    mcts.append_rows(rep, (packed.reshape(-1, 20), value.reshape(-1),
                           policy.reshape(-1, N_ACTIONS), weight.reshape(-1)),
                     mask.reshape(-1))


# ---------------------------------------------------------------------------
# the move program
# ---------------------------------------------------------------------------

class VPMoveStats(NamedTuple):
    action: torch.Tensor      # int32 (B,)
    probs: torch.Tensor       # float32 (B, 7) root improvement policy
    root_value: torch.Tensor  # float32 (B,)
    score: torch.Tensor       # (B,) score after the move
    lines: torch.Tensor
    done: torch.Tensor        # bool (B,) episode ended on this move
    reset: torch.Tensor       # bool (B,) tree was wiped and re-rooted


def make_vp_move_fn(apply_fn: Callable, cfg: mcts.SearchConfig, planes,
                    min_visits_store: int = 10, store: bool = True):
    """`move(vtrees, envs, replay=None) -> (envs, VPMoveStats)`: one batched
    ApproxPolicyIter move. apply_fn: float images (n, 1, 20, 10) -> (v (n,),
    logits (n, 7)). `planes.uniforms(B, D)` gives the select walk's draws.
    vtrees (and the ring, which `store=True` requires) are updated in
    place; envs are packed (B, 44) int32. `move.levels` holds the select
    levels of every simulation of the last move."""
    tcfg = cfg.tree
    guard = mcts.capacity_guard_for(cfg.sims, tcfg, cfg.allow_clamp)
    env_kw = T.env_kw(tcfg)
    insert = tree_walk.insert_fn_for(tcfg)

    def sim_once(vts: VPTree):
        base = vts.base
        B = base.root.shape[0]
        traces, actions, lengths, levels = select_batched(
            vts, planes.uniforms(B, tcfg.max_depth), tcfg)
        b = torch.arange(B, device=lengths.device)
        leafs = traces[b, (lengths.long() - 1).clamp_min(0)]
        lc = leafs.long()
        leaf_env = T.replay_leaf(base, actions, lengths, tcfg, levels)
        can = ~base.end[b, lc] & (base.cbase[b, lc] == 0) & T.headroom(base, tcfg)

        v, logits = apply_fn(engine.unpack_obs(EP.packed_obs(leaf_env))[:, None].float())
        p = torch.softmax(logits.float(), -1)
        leaf_obs = base.nstat[b, 1, lc].long()
        vts.prior[b, :, leaf_obs] = torch.where(can[:, None], p, vts.prior[b, :, leaf_obs])

        _, packed7, score7, end7 = T.expand_children(leaf_env, tcfg)
        obs7 = insert(base, packed7.contiguous(), end7, can, tcfg)
        T.expand_commit(base, score7, end7, obs7, leafs, can)

        leaf_score = base.nstat[b, 0, lc]
        value = torch.where(can, leaf_score + v.float(), leaf_score)
        backup_value_policy_batched(vts, traces, lengths, value, levels)
        return levels

    def move(vts: VPTree, envs, replay: VPReplay | None = None):
        if store and replay is None:
            raise ValueError("a move with store=True needs the replay ring")
        move.levels = [sim_once(vts) for _ in range(cfg.sims)]
        base = vts.base
        b = torch.arange(envs.shape[0], device=envs.device)
        action = best_action(vts)
        probs = root_policy(vts)
        rv = base.values[b, base.nstat[b, 1, base.root.long()].long()]
        envs2 = EP.packed_step(envs, action, **env_kw)
        T.advance_root(base, action, envs2, tcfg)
        done = envs2[:, 43] != 0
        full = (base.n_nodes + guard > tcfg.max_nodes) | (base.n_obs + guard > tcfg.max_obs)
        trigger = done | full | (base.root == 0)
        fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), tcfg.env))
        envs3 = torch.where(done[:, None], fresh, envs2)
        if store:
            packed, val, pol, w, mask = harvest(vts, min_visits_store)
            vp_replay_add(replay, packed, val, pol, w, mask & trigger[:, None])
        reset_vp_trees(vts, envs3, trigger, tcfg)
        return envs3, VPMoveStats(action=action, probs=probs, root_value=rv,
                                  score=envs2[:, 36], lines=envs2[:, 38], done=done,
                                  reset=trigger)

    move.levels = []
    return move
