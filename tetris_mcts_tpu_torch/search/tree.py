"""Array-tree MCTS storage and the main-path tree ops, batched over B trees.

Counterpart of the reference package's `search/tree.py`. The layout is the
reference's (`Tree`, pool axes minor): `cbase[N]` holds the first child of
each node (children are contiguous, child[a] = cbase + a), `nstat[2, N]`
holds [score; obs id], and the per-obs statistics `visits`/`values`/`vars_`
are separate arrays. Every field carries a leading batch axis B.

Differences from the reference, all in representation only:

- The root env state is kept packed (`root_env`, (B, 44) int32, the
  `engine.pack_state` layout), the form the select kernel consumes.
- u32 words (`obs_bits`, `tbl_h1`, `tbl_h2`) are int32 bit patterns.
- Ops update the tree in place, where the reference returns new arrays: the
  walk kernels write the (B, M) statistics and (B, T) tables in place, and
  a copy of the 34 MB tree state per simulation would buy nothing.

Probing is linear (+1); the reference's `TMT_PROBE=double` mode is not
ported. The single-key insert of `alloc_node` probes a window of
`PROBE_ROUNDS` slots at once, the bound the insert kernel uses.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from tetris_mcts_tpu_torch.env.engine import EnvConfig
from tetris_mcts_tpu_torch.env.rng import MASK32, i32, u32
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.search.quantiles import bayes_quantile, norm_quantile

N_ACTIONS = 7
PROBE_ROUNDS = 128  # the reference insert kernel's _INSERT_ROUNDS


class TreeConfig(NamedTuple):
    """Static search configuration."""

    max_nodes: int = 4096
    max_obs: int = 4096
    table_size: int = 8192  # power of two, >= 2 * max_obs
    max_depth: int = 96
    low: int = 1           # unvisited-first threshold (`check_low` n)
    gamma: float = 0.999   # backup discount
    policy: str = "clt"    # clt | bayes | gauss | ucbv | max | mc | random | greedy
    env: EnvConfig = EnvConfig()
    select_kernel: bool = True  # the select kernel, else the plain walk
    insert_kernel: bool = True  # the insert kernel, else the plain insert


@dataclass
class Tree:
    """B search trees (leading axis B on every field)."""

    cbase: torch.Tensor     # int32 (B, N) first child id; 0 = unexpanded
    nstat: torch.Tensor     # float32 (B, 2, N) [score; obs id (exact int)]
    end: torch.Tensor       # bool (B, N)
    n_nodes: torch.Tensor   # int32 (B,) next free node id (starts at 1)
    root_env: torch.Tensor  # int32 (B, 44) packed env state at the root
    visits: torch.Tensor    # float32 (B, M) visit counts (exact ints)
    values: torch.Tensor    # float32 (B, M)
    vars_: torch.Tensor     # float32 (B, M)
    obs_end: torch.Tensor   # bool (B, M)
    obs_bits: torch.Tensor  # int32 (B, 20, M) packed boards (u32 bits)
    n_obs: torch.Tensor     # int32 (B,) next free obs id (starts at 1)
    tbl_h1: torch.Tensor    # int32 (B, T) key lane 1 (u32 bits)
    tbl_h2: torch.Tensor    # int32 (B, T) key lane 2 (u32 bits)
    tbl_obs: torch.Tensor   # int32 (B, T) obs id, 0 = empty
    root: torch.Tensor      # int32 (B,)
    # float32 (B, M) the largest backed-up relative return per obs, which
    # only `--policy max` tracks and reads; zeros when not given
    vmax: torch.Tensor | None = None

    def __post_init__(self):
        if self.vmax is None:
            self.vmax = torch.zeros_like(self.values)

    def clone(self) -> "Tree":
        return Tree(**{f.name: getattr(self, f.name).clone()
                       for f in fields(self)})


def _rows(x):
    return torch.arange(x.shape[0], device=x.device)


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _mix32(h):
    """Final avalanche (xorshift-multiply, lowbias32 constants), int64 u32."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & MASK32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & MASK32
    return h ^ (h >> 16)


_HK1 = [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1,
        0xD3A2646D, 0xFD7046C5, 0xB55A4F09, 0x94D049BB, 0xBF58476D,
        0x2545F491, 0x708ED7D7, 0x9E6C63D1, 0xA3B19535, 0x8DA6B343,
        0xD8163841, 0xCB9E59B1, 0x6295C58D, 0x2F6BBB77, 0x452821E7]
_HK2 = [0x38495AB5, 0xA4093823, 0x299F31D1, 0x082EFA99, 0xEC4E6C89,
        0x452821E7, 0x38D01377, 0xBE5466CF, 0x34E90C6D, 0xC97C50DD,
        0x3F84D5B5, 0xB5470917, 0x9216D5D9, 0x8979FB1B, 0xD1310BA7,
        0x98DFB5AD, 0x2FFD72DB, 0xD01ADFB7, 0xB8E1AFED, 0x6A267E97]


def _hash_packed(packed):
    """64-bit key (two multiply-accumulate lanes + avalanche) of packed obs
    words (..., 20) -> (h1, h2), int64 u32 values with the leading shape.
    Products wrap in int64; their low 32 bits are exact."""
    w = u32(packed)
    k1 = torch.tensor(_HK1, dtype=torch.int64, device=w.device)
    k2 = torch.tensor(_HK2, dtype=torch.int64, device=w.device)
    h1 = ((w * k1) & MASK32).sum(-1) & MASK32
    h2 = ((w * k2) & MASK32).sum(-1) & MASK32
    return _mix32(h1), _mix32(h2)


# ---------------------------------------------------------------------------
# obs-table insert
# ---------------------------------------------------------------------------

def _write_obs(trees: Tree, o, packed, end, new):
    """obs_end[o] = end and obs_bits[:, o] = packed where `new` (B,)."""
    b = _rows(o)
    oc = o.long()
    trees.obs_end[b, oc] = torch.where(new, end, trees.obs_end[b, oc])
    trees.obs_bits[b, :, oc] = torch.where(
        new[:, None], packed, trees.obs_bits[b, :, oc])


def _insert_obs(trees: Tree, packed, end, ok, cfg: TreeConfig):
    """Find-or-create one obs slot per tree (the reference `_insert_obs`).
    packed (B, 20) int32, end/ok (B,) bool. Returns obs ids (B,) int32;
    0 when not created and not found. The probe looks at PROBE_ROUNDS slots
    from the key's home slot in one gather; a key with neither a match nor
    an empty slot there gets 0, as the insert kernel gives when its rounds
    run out."""
    T = cfg.table_size
    h1, h2 = _hash_packed(packed)
    b = _rows(h1)[:, None]
    slots = (h1[:, None] + torch.arange(PROBE_ROUNDS, device=h1.device)) & (T - 1)
    tid = trees.tbl_obs[b, slots]
    match = (u32(trees.tbl_h1[b, slots]) == h1[:, None]) & (
        u32(trees.tbl_h2[b, slots]) == h2[:, None]) & (tid != 0)
    stop = (tid == 0) | match
    j = stop.to(torch.int8).argmax(1, keepdim=True)        # first stop
    hit = stop.gather(1, j)[:, 0]
    slot = slots.gather(1, j)[:, 0]
    found = match.gather(1, j)[:, 0]
    new = ok & hit & ~found & (trees.n_obs < cfg.max_obs)
    o = torch.where(found, tid.gather(1, j)[:, 0],
                    torch.where(new, trees.n_obs, 0)).to(torch.int32)
    bb = b[:, 0]
    for tbl, val in ((trees.tbl_h1, i32(h1)), (trees.tbl_h2, i32(h2)),
                     (trees.tbl_obs, o)):
        tbl[bb, slot] = torch.where(new, val, tbl[bb, slot])
    trees.n_obs += new.to(torch.int32)
    _write_obs(trees, o, packed, end, new)
    return o


def insert_obs7_batched(trees: Tree, packed7, end7, ok, cfg: TreeConfig):
    """Find-or-create obs slots for the 7 children of every tree, in
    lockstep rounds (the reference `insert_obs7_batched` and its kernel
    `insert7_walk`). This is the plain form the insert kernel is held
    against (`ops/tree_walk.insert_obs7`).

    Per round: keys that match a slot take its id; at an empty slot the
    group representative (the lowest action with that key) writes its key,
    and when distinct keys contend for one slot the LAST contending action
    wins, as in the reference kernel's unrolled writes; winners get ids
    n_obs + their rank in action order; keys that meet an empty slot with
    the pool full get obs 0; the rest advance one slot. At most
    PROBE_ROUNDS rounds run; a key still unplaced then keeps obs 0.

    packed7 (B, 7, 20) int32, end7 (B, 7) bool, ok (B,) bool.
    Returns obs7 (B, 7) int32; the tree is updated in place."""
    B = packed7.shape[0]
    T = cfg.table_size
    dev = packed7.device
    h1, h2 = _hash_packed(packed7)                            # (B, 7)
    h1i, h2i = i32(h1), i32(h2)
    a7 = torch.arange(N_ACTIONS, device=dev)
    same = (h1[:, :, None] == h1[:, None, :]) & (h2[:, :, None] == h2[:, None, :])
    rep = ~(same & (a7[:, None] > a7[None, :])).any(2)
    b = _rows(h1)[:, None]
    slot = h1 & (T - 1)
    placed = (~ok)[:, None].expand(B, N_ACTIONS).clone()
    obs = torch.zeros(B, N_ACTIONS, dtype=torch.int32, device=dev)
    n_obs0 = trees.n_obs.clone()
    th1, th2, tobs = trees.tbl_h1, trees.tbl_h2, trees.tbl_obs

    def write(tbl, mask, val):
        # action by action, so the last writer to a slot wins
        for a in range(N_ACTIONS):
            s = slot[:, a]
            tbl[b[:, 0], s] = torch.where(mask[:, a], val[:, a], tbl[b[:, 0], s])

    for _ in range(PROBE_ROUNDS):
        if bool(placed.all()):
            break
        tid = tobs[b, slot]
        occupied = tid != 0
        match = (th1[b, slot] == h1i) & (th2[b, slot] == h2i) & occupied
        hit = ~placed & match
        obs = torch.where(hit, tid, obs)
        placed |= hit
        full = (trees.n_obs >= cfg.max_obs)[:, None]
        at_empty = ~placed & ~occupied
        placed |= at_empty & full
        attempt = at_empty & ~full & rep
        write(th1, attempt, h1i)
        write(th2, attempt, h2i)
        won = attempt & (th1[b, slot] == h1i) & (th2[b, slot] == h2i)
        wi = won.to(torch.int32)
        ids = trees.n_obs[:, None] + wi.cumsum(1, dtype=torch.int32) - wi
        won &= ids < cfg.max_obs
        write(tobs, won, ids)
        obs = torch.where(won, ids, obs)
        placed |= won
        trees.n_obs += won.sum(1, dtype=torch.int32)
        slot = torch.where(~placed & occupied & ~match, (slot + 1) & (T - 1), slot)

    first = ok[:, None] & (obs >= n_obs0[:, None]) & rep
    for a in range(N_ACTIONS):
        _write_obs(trees, obs[:, a], packed7[:, a], end7[:, a], first[:, a])
    return obs


# ---------------------------------------------------------------------------
# leaf replay and expansion front half (the VP and policy paths)
# ---------------------------------------------------------------------------

# levels between two checks of "every lane is done" (a host read) in the
# VP walks; done lanes are no-ops, so the check only saves levels and
# never changes a result
WALK_EXIT_EVERY = 4


def env_kw(cfg: TreeConfig):
    """`packed_step`'s env keyword arguments of the config."""
    e = cfg.env
    return dict(actions_per_drop=e.actions_per_drop, scoring=e.scoring,
                randomizer=e.randomizer)


def replay_leaf(trees: Tree, actions, lengths, cfg: TreeConfig, levels=None):
    """Packed leaf states (B, 44) of action paths from the roots (the
    reference `replay_leaf_batched`): lane b steps its root env by
    actions[b, t] for t < lengths[b] - 1, all lanes in lockstep. `levels`
    bounds the loop (the levels the select walk ran, >= max(lengths));
    without it the loop stops once every lane is done, checked every
    WALK_EXIT_EVERY levels. Bounded by max_depth either way."""
    env = trees.root_env
    kw = env_kw(cfg)
    last = lengths.long() - 1
    n = cfg.max_depth - 1 if levels is None else min(levels, cfg.max_depth) - 1
    for t in range(max(n, 0)):
        if levels is None and t % WALK_EXIT_EVERY == 0 and not bool((t < last).any()):
            break
        do = t < last
        env = torch.where(do[:, None], EP.packed_step(env, actions[:, t], **kw), env)
    return env


def expand_children(leaf_env, cfg: TreeConfig):
    """The 7 child steps of every leaf (the reference `expand_children`),
    as one packed step of the B x 7 (leaf, action) pairs. leaf_env (B, 44)
    -> (child env (B, 7, 44), packed obs (B, 7, 20), score (B, 7) int32,
    end (B, 7) bool)."""
    B = leaf_env.shape[0]
    a7 = torch.arange(N_ACTIONS, device=leaf_env.device)
    ch = EP.packed_step(leaf_env.repeat_interleave(N_ACTIONS, 0), a7.repeat(B),
                        **env_kw(cfg))
    return (ch.reshape(B, N_ACTIONS, -1), EP.packed_obs(ch).reshape(B, N_ACTIONS, 20),
            ch[:, 36].reshape(B, N_ACTIONS), (ch[:, 43] != 0).reshape(B, N_ACTIONS))


def headroom(trees: Tree, cfg: TreeConfig):
    """(B,) True while one more expansion surely fits in both pools."""
    return (trees.n_nodes + N_ACTIONS <= cfg.max_nodes) & (
        trees.n_obs + N_ACTIONS <= cfg.max_obs)


def children_of(trees: Tree, idx):
    """(B, 7) int64 child node ids of nodes idx (B,): cbase + action, 0s
    where the node is unexpanded."""
    c = trees.cbase[_rows(idx), idx.long()].long()[:, None]
    return torch.where(c != 0, c + torch.arange(N_ACTIONS, device=c.device), 0)


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def expand_commit(trees: Tree, score7, end7, obs7, leaf, ok):
    """Write the 7 contiguous child rows of `leaf` (score, end, obs) where
    ok (B,), and link them from the leaf (the reference `expand_commit`)."""
    b = _rows(leaf)
    base = torch.where(ok, trees.n_nodes, 0)
    ids = (base[:, None] + torch.arange(N_ACTIONS, device=leaf.device)).long()
    okc = ok[:, None]
    bc = b[:, None]
    trees.nstat[bc, 0, ids] = torch.where(okc, score7.float(), trees.nstat[bc, 0, ids])
    trees.nstat[bc, 1, ids] = torch.where(okc, obs7.float(), trees.nstat[bc, 1, ids])
    trees.end[bc, ids] = torch.where(okc, end7, trees.end[bc, ids])
    trees.n_nodes += torch.where(ok, N_ACTIONS, 0).to(torch.int32)
    lc = leaf.long()
    trees.cbase[b, lc] = torch.where(ok, base, trees.cbase[b, lc])


def alloc_node(trees: Tree, env, ok, cfg: TreeConfig):
    """Allocate a node for packed state env (B, 44) where ok, projecting it
    onto an obs slot. Returns node ids (B,) int32, 0 where not allocated."""
    ok = ok & (trees.n_nodes < cfg.max_nodes)
    idx = torch.where(ok, trees.n_nodes, 0)
    end = env[:, 43] != 0
    o = _insert_obs(trees, EP.packed_obs(env), end, ok, cfg)
    b = _rows(idx)
    ic = idx.long()
    trees.nstat[b, 0, ic] = torch.where(ok, env[:, 36].float(), trees.nstat[b, 0, ic])
    trees.nstat[b, 1, ic] = torch.where(ok, o.float(), trees.nstat[b, 1, ic])
    trees.end[b, ic] = torch.where(ok, end, trees.end[b, ic])
    trees.n_nodes += ok.to(torch.int32)
    return idx


def new_episode_root(trees: Tree, env, ok, cfg: TreeConfig):
    """Where ok (B,): re-root into the same pool at packed state env (B, 44)
    without wiping the tree (the reference `new_episode_root`): the finished
    game's subtree stays in the pool until the next harvest-and-reset, and
    obs statistics persist across episodes. A full pool gives root 0, which
    the next move's `root == 0` trigger turns into a harvest-and-reset."""
    idx = alloc_node(trees, env, ok, cfg)
    trees.root = torch.where(ok, idx, trees.root)
    trees.root_env = torch.where(ok[:, None], env, trees.root_env)


def init_tree(env, cfg: TreeConfig) -> Tree:
    """Fresh trees rooted at packed states env (B, 44) int32."""
    B = env.shape[0]
    N, M, T = cfg.max_nodes, cfg.max_obs, cfg.table_size
    kw = dict(device=env.device)
    i32z = lambda *s: torch.zeros(*s, dtype=torch.int32, **kw)
    f32z = lambda *s: torch.zeros(*s, dtype=torch.float32, **kw)
    trees = Tree(
        cbase=i32z(B, N), nstat=f32z(B, 2, N),
        end=torch.zeros(B, N, dtype=torch.bool, **kw),
        n_nodes=i32z(B) + 1, root_env=env.clone(),
        visits=f32z(B, M), values=f32z(B, M), vars_=f32z(B, M),
        obs_end=torch.zeros(B, M, dtype=torch.bool, **kw),
        obs_bits=i32z(B, 20, M), n_obs=i32z(B) + 1,
        tbl_h1=i32z(B, T), tbl_h2=i32z(B, T), tbl_obs=i32z(B, T),
        root=i32z(B),
    )
    trees.root = alloc_node(trees, env, torch.ones(B, dtype=torch.bool, **kw), cfg)
    return trees


def reset_trees(trees: Tree, env, mask, cfg: TreeConfig):
    """Where mask (B,): wipe the tree and re-root it at env (B, 44), as
    `init_tree` would (the reference's harvest+reset of the move program)."""
    for f in fields(trees):
        x = getattr(trees, f.name)
        if f.name in ("n_nodes", "n_obs"):
            x.masked_fill_(mask, 1)
        elif f.name == "root_env":
            x.copy_(torch.where(mask[:, None], env, x))
        elif f.name != "root":
            x.masked_fill_(mask.view(-1, *([1] * (x.dim() - 1))), 0)
    idx = alloc_node(trees, env, mask, cfg)
    trees.root = torch.where(mask, idx, trees.root)


# ---------------------------------------------------------------------------
# unique children, policy bounds
# ---------------------------------------------------------------------------

def _kids_stats(trees: Tree, idx):
    """Unique-by-obs children of node idx (B,) (`get_unique_child_obs`):
    returns (kids (B, 7) int64, score (B, 7), obs (B, 7) int64 with -1 for
    invalid, kept (B, 7) bool: the earliest child with its obs group's max
    score)."""
    b = _rows(idx)[:, None]
    c = trees.cbase[b[:, 0], idx.long()].long()
    valid = (c != 0)[:, None].expand(-1, N_ACTIONS)
    a7 = torch.arange(N_ACTIONS, device=idx.device)
    kids = torch.where(valid, c[:, None] + a7, 0)
    sc = trees.nstat[b, 0, kids]
    obs = torch.where(valid, trees.nstat[b, 1, kids].long(), -1)
    same = (obs[:, :, None] == obs[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    beats = (sc[:, :, None] > sc[:, None, :]) | (
        (sc[:, :, None] == sc[:, None, :]) & (a7[:, None] <= a7[None, :]))
    kept = valid & (~same | beats).all(2)
    return kids, sc, obs, kept


def seq_sum(x):
    """The sum over the last axis taken in order, term by term, as XLA's CPU
    code sums a short minor axis; the same on the card and the CPU."""
    s = x[..., 0]
    for a in range(1, x.shape[-1]):
        s = s + x[..., a]
    return s


def first_max(q):
    """Index of the first maximum over the last axis (all -inf -> 0)."""
    a7 = torch.arange(q.shape[-1], device=q.device)
    return torch.where(q == q.max(-1, keepdim=True).values, a7, q.shape[-1]).amin(-1)


def explore_bonus(policy: str, visits, var, n_total, q_base, rnd, kept=None,
                  vmax_kids=None):
    """Exploration term of the selection rule (the reference
    `tree.explore_bonus`). `rnd` is the per-child randomness of the mc and
    random rules; `max` (UCB1 scaled by the largest `vmax` of the kept
    children) reads `kept` and `vmax_kids`."""
    nv = visits.clamp_min(1.0)
    if policy == "clt":
        return norm_quantile(n_total) * torch.sqrt(var / nv)
    if policy == "bayes":
        return bayes_quantile(nv - 1.0, n_total) * torch.sqrt(
            var / (nv - 1.0).clamp_min(1.0))
    if policy == "gauss":
        return norm_quantile(n_total) * torch.sqrt(var)
    if policy == "ucbv":
        return torch.sqrt(var * torch.log(n_total.clamp_min(2.0)))
    if policy == "max":
        q_max = torch.where(kept, vmax_kids, -torch.inf).amax(-1, keepdim=True)
        return q_max * torch.sqrt(torch.log(n_total.clamp_min(2.0)) / nv)
    if policy == "mc":
        return rnd * torch.sqrt(var)
    if policy == "random":
        return rnd * 1e9 - q_base
    if policy == "greedy":
        return torch.zeros_like(q_base)
    raise ValueError(f"unknown or unported selection policy {policy!r}")


# ---------------------------------------------------------------------------
# backup (the plain form of the LP-backup kernel)
# ---------------------------------------------------------------------------

def lp_seed(trees: Tree, traces, lengths, v_nn, var_nn, expanded,
            cfg: TreeConfig):
    """Seed the leaf's fresh unique child obs with the NN estimates (0 for
    terminal children) and return the averaged value to back up
    (`backup_trace_obs_LP`, the reference `lp_seed`). Children are visited
    in action order and summed sequentially, as the kernels do.
    Returns (v0, var0), each (B,) float32."""
    gamma = float(cfg.gamma)
    leaf = traces.gather(1, (lengths.long() - 1).clamp_min(0)[:, None])[:, 0]
    kids, sc, obs, kept = _kids_stats(trees, leaf)
    kept = kept & expanded[:, None]
    b = _rows(leaf)
    o = obs.clamp_min(0)
    end_k = trees.end[b[:, None], kids]
    v_sum = torch.zeros(b.shape[0], device=leaf.device)
    var_sum = torch.zeros_like(v_sum)
    for a in range(N_ACTIONS):
        oa, ka = o[:, a], kept[:, a]
        first = ka & (trees.visits[b, oa] == 0.0)
        trees.visits[b, oa] = torch.where(first, trees.visits[b, oa] + 1.0,
                                          trees.visits[b, oa])
        trees.values[b, oa] = torch.where(
            first, torch.where(end_k[:, a], 0.0, v_nn[:, a]), trees.values[b, oa])
        trees.vars_[b, oa] = torch.where(
            first, torch.where(end_k[:, a], 0.0, var_nn[:, a]), trees.vars_[b, oa])
        v_sum = torch.where(ka, v_sum + (sc[:, a] + gamma * trees.values[b, oa]), v_sum)
        var_sum = torch.where(ka, var_sum + trees.vars_[b, oa], var_sum)
    k = kept.sum(1).clamp_min(1).float()
    leaf_score = trees.nstat[b, 0, leaf.long()]
    v0 = torch.where(expanded, v_sum / k, leaf_score)
    var0 = torch.where(expanded, var_sum * gamma * gamma / k, 0.0)
    return v0, var0


def _levels(trees: Tree, traces, lengths):
    """The steps of a reverse walk up every trace: step k yields (live (B,),
    node score s (B,), obs o (B,) int64) of level length-1-k of every lane,
    strictly in order, since one trace can hold the same obs twice. Lanes
    past their root have live False and repeat their level 0."""
    b = _rows(lengths)
    lengths = lengths.long()
    for k in range(int(lengths.max())):
        t = lengths - 1 - k
        idx = traces[b, t.clamp_min(0)].long()
        yield t >= 0, trees.nstat[b, 0, idx], trees.nstat[b, 1, idx].long()


def backup_batched(trees: Tree, traces, lengths, v0, var0, cfg: TreeConfig):
    """Reverse Welford+γ walk up every trace (`backup_trace_obs`, the
    reference `backup_batched`). A first visit sets (v_rel, var0); later
    ones run the Welford update. Under `--policy max` it also keeps vmax[o]
    = max(vmax[o], v_rel). Updates visits/values/vars_ (and vmax) in
    place."""
    gamma = float(cfg.gamma)
    track_vmax = cfg.policy == "max"
    b = _rows(lengths)
    v = v0.float().clone()
    for live, s, o in _levels(trees, traces, lengths):
        n, valo, varo = trees.visits[b, o], trees.values[b, o], trees.vars_[b, o]
        v_rel = v - s
        first = n == 0.0
        delta = v_rel - valo
        val_new = torch.where(first, v_rel, valo + delta / (n + 1.0))
        delta2 = v_rel - val_new
        var_new = torch.where(first, var0, varo + (delta * delta2 - varo) / (n + 1.0))
        trees.visits[b, o] = torch.where(live, n + 1.0, n)
        trees.values[b, o] = torch.where(live, val_new, valo)
        trees.vars_[b, o] = torch.where(live, var_new, varo)
        if track_vmax:
            vm = trees.vmax[b, o]
            trees.vmax[b, o] = torch.where(live, torch.maximum(vm, v_rel), vm)
        v = torch.where(live, gamma * v_rel + s, v)


def backup_exp_moving(trees: Tree, traces, lengths, v0, var0, cfg: TreeConfig,
                      alpha: float = 0.1):
    """The exponential-moving-average backup (`backup_trace_obs_exp_moving`,
    the reference `backup_exp_moving`, batched): value += α·δ, var = (1-α)
    (var + α·δ²); a first visit sets (v_rel, var0). No agent path runs it.
    Updates visits/values/vars_ in place."""
    gamma = float(cfg.gamma)
    a = np.float32(alpha)
    keep = float(np.float32(1.0) - a)  # (1 - α) in float32, as the reference
    a = float(a)
    b = _rows(lengths)
    v = v0.float().clone()
    for live, s, o in _levels(trees, traces, lengths):
        n, valo, varo = trees.visits[b, o], trees.values[b, o], trees.vars_[b, o]
        v_rel = v - s
        first = n == 0.0
        d = v_rel - valo
        val_new = torch.where(first, v_rel, valo + a * d)
        var_new = torch.where(first, var0, keep * (varo + a * d * d))
        trees.visits[b, o] = torch.where(live, n + 1.0, n)
        trees.values[b, o] = torch.where(live, val_new, valo)
        trees.vars_[b, o] = torch.where(live, var_new, varo)
        v = torch.where(live, gamma * v_rel + s, v)


def backup_mixture(trees: Tree, traces, lengths, v0, var0, cfg: TreeConfig):
    """The Gaussian-mixture backup (`backup_trace_mixture_obs`, the reference
    `backup_mixture`, batched): each backup is a component, var += (Δvar +
    Δ(v²))/n − (Δv/n)(v_old + v_new). The incoming variance decays by γ a
    level, as in the reference's numba core (its C++ twin decays by γ²).
    No agent path runs it. Updates visits/values/vars_ in place."""
    gamma = float(cfg.gamma)
    b = _rows(lengths)
    v = v0.float().clone()
    in_var = var0.float().clone()
    for live, s, o in _levels(trees, traces, lengths):
        n, valo, varo = trees.visits[b, o], trees.values[b, o], trees.vars_[b, o]
        v_rel = v - s
        n_new = n + 1.0
        v_diff = v_rel - valo
        v_sq_diff = v_rel * v_rel - valo * valo
        val_new = valo + v_diff / n_new
        var_new = varo + (in_var - varo + v_sq_diff) / n_new - (v_diff / n_new) * (
            valo + val_new)
        trees.visits[b, o] = torch.where(live, n_new, n)
        trees.values[b, o] = torch.where(live, val_new, valo)
        trees.vars_[b, o] = torch.where(live, var_new, varo)
        v = torch.where(live, gamma * v_rel + s, v)
        in_var = torch.where(live, gamma * in_var, in_var)


# ---------------------------------------------------------------------------
# root stats / advance
# ---------------------------------------------------------------------------

def compute_stats(trees: Tree):
    """(B, 3, 7) [visit, Q, variance] per root action
    (`TreeAgent.compute_stats`)."""
    b = _rows(trees.root)[:, None]
    root = trees.root.long()
    kids = children_of(trees, trees.root)
    valid = kids != 0
    obs = trees.nstat[b, 1, kids].long()
    visit = torch.where(valid, trees.visits[b, obs], 0.0)
    q = torch.where(valid, trees.values[b, obs] + trees.nstat[b, 0, kids]
                    - trees.nstat[b[:, 0], 0, root][:, None], -torch.inf)
    var = torch.where(valid, trees.vars_[b, obs], 0.0)
    return torch.stack([visit, q, var], 1)


def best_action(stats):
    """Greedy first-max over root Q (`get_action`), (B,) int32."""
    return stats[:, 1].argmax(1).to(torch.int32)


def visit_probs(stats):
    """Visit-proportional policy (`get_prob`), (B, 7)."""
    return stats[:, 0] / stats[:, 0].sum(1, keepdim=True).clamp_min(1.0)


def root_value(trees: Tree):
    b = _rows(trees.root)
    o = trees.nstat[b, 1, trees.root.long()].long()
    return trees.values[b, o], trees.vars_[b, o]


def advance_root(trees: Tree, action, env, cfg: TreeConfig):
    """Move each root to child[action] after the real env step, allocating
    the node if that move was never expanded (`update_root`). The root env
    becomes the post-move packed state env (B, 44)."""
    b = _rows(action)
    cb = trees.cbase[b, trees.root.long()]
    c = torch.where(cb != 0, cb + action, 0)
    need = c == 0
    fresh = alloc_node(trees, env, need, cfg)
    trees.root = torch.where(need, fresh, c).to(torch.int32)
    trees.root_env = env.clone()


# ---------------------------------------------------------------------------
# training-data harvest
# ---------------------------------------------------------------------------

def harvest(trees: Tree, min_visits: int):
    """Training rows of every tree (the reference `harvest`): each obs slot
    with visits >= min_visits that is in use and not terminal. Returns
    (packed (B, M, 20) int32 u32 bits, value (B, M), var (B, M), weight =
    visits (B, M), mask (B, M) bool); the boards stay packed."""
    B, M = trees.visits.shape
    slots = torch.arange(M, device=trees.visits.device)
    mask = ((slots >= 1) & (slots < trees.n_obs[:, None])
            & (trees.visits >= min_visits) & ~trees.obs_end)
    return (trees.obs_bits.permute(0, 2, 1), trees.values, trees.vars_,
            trees.visits, mask)
