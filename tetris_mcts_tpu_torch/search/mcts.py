"""Batched MCTS moves with the leaf-parallel, leaf and rollout evaluators,
and the on-device replay ring that online self-play trains from.

Counterpart of the reference package's `search/mcts.py`. One simulation
for all B trees:

    select kernel (walk + inline env stepping + the leaf's 7 child steps)
    -> insert kernel (obs ids of the 7 children) -> expand_commit
    -> evaluator -> backup

Evaluators (`SearchConfig.evaluator`), each `ev(packed7, leaf_env) ->
(v, var)` on the select kernel's packed child boards (B, 7, 20) and its
leaf env (B, 44):

- "lp" (ValueSimLP): the net on the B x 7 child boards, then the LP-backup
  kernel (seed the unique children, average, walk up).
- "leaf" (ValueSim, ValueSimOnline, ValueSimBayes): the net on the leaf's
  board only, imaged from the kernel's leaf env; the backup kernel walks
  up v0 = leaf score + v.
- "rollout" (Vanilla, VanillaC, Random): a uniform-random playout of at
  most `rollout_cap` steps from the leaf env; the backup kernel walks up
  v0 = the playout's final score with variance `rollout_variance`.

A lane that did not expand (a terminal leaf, or no room) backs up
(leaf score, 0) in the leaf and rollout modes.

One move is `sims` simulations, the greedy root action, the real env step,
the root advance, and the harvest-and-reset of every lane that is done,
whose pool is full, or whose root could not be allocated: that lane's whole
tree is wiped and re-rooted at its (soft-reset) env. With `store=True` the
harvest first appends the lane's training rows (every obs with at least
`min_visits_store` visits that is not terminal) to the replay ring
(`Replay`); `store_drop=True` drops each such row with the ring's
`drop_prob`. With `episode_reuse=True` a lane whose game ended keeps its
tree and re-roots in it; only a full pool or a lost root resets it. The
harvest and the store run masked on every move, so the lp and leaf moves
stay on the device: they never read a value back to the host, and the
driver's one read per move is the only synchronisation. The rollout reads
one flag every `ROLLOUT_EXIT_EVERY` playout steps, to stop once every
playout has ended.

Randomness: the select walk takes pre-drawn (B, D, 7) gumbel planes (and
per-child planes for the mc/random policies), the rollout one action draw
per step, and the store drop one uniform a harvested row. `TorchPlanes`
draws all of them from a `torch.Generator` on the device; a test can pass
any other source, for example one that replays the JAX key schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.ops import tree_walk
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search.tree import Tree, TreeConfig

N_ACTIONS = T.N_ACTIONS


EVALUATORS = ("lp", "leaf", "rollout")
# playout steps between two checks of "every playout has ended" (a host
# read); ended lanes are no-ops under packed_step, so the check only saves
# steps and never changes a result
ROLLOUT_EXIT_EVERY = 16


class SearchConfig(NamedTuple):
    tree: TreeConfig = TreeConfig()
    sims: int = 100
    evaluator: str = "lp"          # "lp" | "leaf" | "rollout"
    rollout_cap: int = 512         # max random-playout length (rollout mode)
    rollout_variance: float = 1e3  # fixed rollout variance (Vanilla.py:54)


class MoveStats(NamedTuple):
    action: torch.Tensor       # int32 (B,)
    probs: torch.Tensor        # float32 (B, 7) visit-proportional policy
    child_stats: torch.Tensor  # float32 (B, 3, 7)
    root_value: torch.Tensor   # float32 (B,)
    root_var: torch.Tensor     # float32 (B,)
    score: torch.Tensor        # (B,) score after the move
    lines: torch.Tensor        # (B,)
    done: torch.Tensor         # bool (B,) episode ended on this move
    reset: torch.Tensor        # bool (B,) tree was wiped and re-rooted
    n_nodes: torch.Tensor      # int32 (B,) nodes allocated before any reset


class TorchPlanes:
    """Per-simulation randomness from a torch.Generator: the select walk's
    gumbels (B, D, 7), and normal (mc) or gumbel (random) per-child planes
    for those policies, zeros otherwise (`__call__`); and the rollout's
    uniform action draws (`actions`)."""

    def __init__(self, seed: int, device, policy: str = "clt"):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device
        self.policy = policy

    def _gumbel(self, shape):
        e = torch.empty(shape, device=self.device).exponential_(generator=self.gen)
        return -torch.log(e)

    def __call__(self, B: int, D: int):
        shape = (B, D, N_ACTIONS)
        g = self._gumbel(shape)
        if self.policy == "mc":
            rnd = torch.randn(shape, generator=self.gen, device=self.device)
        elif self.policy == "random":
            rnd = self._gumbel(shape)
        else:
            rnd = torch.zeros(shape, device=self.device)
        return g, rnd

    def actions(self, B: int, step: int):
        """Uniform actions (B,) for playout step `step` of a rollout."""
        return torch.randint(0, N_ACTIONS, (B,), generator=self.gen,
                             device=self.device)

    def drop(self, shape):
        """Uniform [0, 1) draws of the store drop, one a harvested row."""
        return torch.rand(shape, generator=self.gen, device=self.device)


def nn_child_evaluator(net_fn: Callable):
    """Evaluate the 7 children of every leaf in one forward pass.
    net_fn: float images (n, 1, 20, 10) -> (v (n,), var (n,))."""

    def ev(packed7, leaf_env):
        B = packed7.shape[0]
        imgs = engine.unpack_obs(packed7).reshape(B * N_ACTIONS, 1, 20, 10)
        v, var = net_fn(imgs.float())
        return v.reshape(B, N_ACTIONS), var.reshape(B, N_ACTIONS)

    return ev


def nn_leaf_evaluator(net_fn: Callable):
    """Evaluate the leaf's board only (ValueSim single-leaf semantics),
    imaged from the select kernel's leaf env."""

    def ev(packed7, leaf_env):
        imgs = engine.unpack_obs(EP.packed_obs(leaf_env))[:, None]
        return net_fn(imgs.float())  # (B,), (B,)

    return ev


def rollout_evaluator(cfg: SearchConfig, draw: Callable):
    """Uniform-random playout from the leaf env to game end, at most
    cfg.rollout_cap steps (the Vanilla agent's evaluator): value = the
    playout's final score, variance cfg.rollout_variance. All B playouts
    advance in lockstep; ended lanes are no-ops. draw(B, step) gives the
    actions (B,) of each step (`TorchPlanes.actions`). `ev.steps` holds the
    number of steps the last call ran."""
    env_kw = dict(actions_per_drop=cfg.tree.env.actions_per_drop,
                  scoring=cfg.tree.env.scoring, randomizer=cfg.tree.env.randomizer)

    def ev(packed7, leaf_env):
        B = leaf_env.shape[0]
        env = leaf_env
        step = 0
        while step < cfg.rollout_cap:
            if step % ROLLOUT_EXIT_EVERY == 0 and bool((env[:, 43] != 0).all()):
                break
            env = EP.packed_step(env, draw(B, step), **env_kw)
            step += 1
        ev.steps = step
        v = env[:, 36].to(torch.float32)
        return v, torch.full((B,), cfg.rollout_variance, device=v.device)

    ev.steps = 0
    return ev


def make_run_sims(evaluator: Callable, cfg: SearchConfig, planes: Callable):
    """`run(trees)`: cfg.sims simulations on B trees, in place."""
    tcfg = cfg.tree
    if cfg.evaluator not in EVALUATORS:
        raise ValueError(f"unknown or unported evaluator {cfg.evaluator!r}")

    def sim_once(trees: Tree):
        B = trees.root.shape[0]
        gumbels, rnd = planes(B, tcfg.max_depth)
        (traces, lengths, leafs, leaf_env, packed7, child_sc7,
         child_end7) = tree_walk.select_walk(trees, gumbels, rnd, tcfg)
        b = torch.arange(B, device=leafs.device)
        lc = leafs.long()
        childless = trees.cbase[b, lc] == 0
        headroom = (trees.n_nodes + N_ACTIONS <= tcfg.max_nodes) & (
            trees.n_obs + N_ACTIONS <= tcfg.max_obs)
        can = ~trees.end[b, lc] & childless & headroom
        end7 = child_end7 != 0
        obs7 = tree_walk.insert_obs7(trees, packed7, end7, can, tcfg)
        T.expand_commit(trees, child_sc7, end7, obs7, leafs, can)
        v, var = evaluator(packed7, leaf_env)
        v, var = v.float().contiguous(), var.float().contiguous()
        if cfg.evaluator == "lp":
            tree_walk.lp_backup(trees, traces, lengths, v, var, can, tcfg)
            return
        leaf_score = trees.nstat[b, 0, lc]
        # leaf: absolute value = leaf score + net value; rollout: the
        # playout's absolute final score. Lanes that did not expand back up
        # (leaf score, 0) (`agents/ValueSim.py:83-93`).
        v0 = torch.where(can, leaf_score + v if cfg.evaluator == "leaf" else v,
                         leaf_score)
        var0 = torch.where(can, var, 0.0)
        tree_walk.backup(trees, traces, lengths, v0, var0, tcfg)

    def run(trees: Tree):
        for _ in range(cfg.sims):
            sim_once(trees)

    return run


def capacity_guard_for(sims: int, tcfg: TreeConfig) -> int:
    """Node headroom one full move needs; raises when the pools cannot hold
    one move (the reference `capacity_guard_for`; its `allow_clamp` opt-in
    to a degraded search is not ported)."""
    need = N_ACTIONS * (sims + 1) + 2
    if need > min(tcfg.max_nodes, tcfg.max_obs) - N_ACTIONS - 1:
        raise ValueError(
            f"max_nodes={tcfg.max_nodes}/max_obs={tcfg.max_obs} cannot hold "
            f"one {sims}-sim move (~{need} nodes): the tree would harvest+"
            "reset every move and sims beyond the pool would expand nothing "
            "— raise max_nodes/max_obs or lower sims")
    return need


def make_move_fn(evaluator: Callable, cfg: SearchConfig, planes,
                 min_visits_store: int = 10, store: bool = False,
                 store_drop: bool = False, episode_reuse: bool = False):
    """`move(trees, envs, replay=None) -> (envs, MoveStats)`: one batched
    move. envs are packed (B, 44) int32 states; trees (and the replay ring,
    which `store=True` requires) are updated in place. `store=False` is
    benchmark mode: nothing is harvested into a ring (the reference's
    default is `store=True`). `planes` gives the select walk's planes
    (`planes(B, D)`) and, for `store_drop`, the drop draws
    (`planes.drop(shape)`)."""
    tcfg = cfg.tree
    run_sims = make_run_sims(evaluator, cfg, planes)
    guard = capacity_guard_for(cfg.sims, tcfg)
    env_kw = dict(actions_per_drop=tcfg.env.actions_per_drop,
                  scoring=tcfg.env.scoring, randomizer=tcfg.env.randomizer)

    def move(trees: Tree, envs, replay: "Replay | None" = None):
        if store and replay is None:
            raise ValueError("a move with store=True needs the replay ring")
        run_sims(trees)
        stats = T.compute_stats(trees)
        action = T.best_action(stats)
        probs = T.visit_probs(stats)
        rv, rvar = T.root_value(trees)
        envs2 = EP.packed_step(envs, action, **env_kw)
        T.advance_root(trees, action, envs2, tcfg)
        done = envs2[:, 43] != 0
        full = (trees.n_nodes + guard > tcfg.max_nodes) | (
            trees.n_obs + guard > tcfg.max_obs)
        trigger = full | (trees.root == 0)
        if not episode_reuse:
            trigger = trigger | done
        n_nodes_before = trees.n_nodes.clone()
        fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), tcfg.env))
        envs3 = torch.where(done[:, None], fresh, envs2)
        if store:
            # the trigger lanes' rows, before their trees are wiped
            packed, val, var, w, mask = T.harvest(trees, min_visits_store)
            mask = mask & trigger[:, None]
            if store_drop:
                kept = mask & (planes.drop(mask.shape) >= replay.drop_prob)
                replay_add(replay, packed, val, var, w, kept, mask_candidates=mask)
            else:
                replay_add(replay, packed, val, var, w, mask)
        T.reset_trees(trees, envs3, trigger, tcfg)
        if episode_reuse:
            # a finished game that kept its tree re-roots in the same pool
            T.new_episode_root(trees, envs3, done & ~trigger, tcfg)
        out = MoveStats(
            action=action, probs=probs, child_stats=stats, root_value=rv,
            root_var=rvar, score=envs2[:, 36], lines=envs2[:, 38], done=done,
            reset=trigger, n_nodes=n_nodes_before,
        )
        return envs3, out

    return move


# ---------------------------------------------------------------------------
# replay ring (device-resident, packed boards)
# ---------------------------------------------------------------------------

# Rows past the ring's capacity R that a scatter writes its dropped rows to,
# in place of the reference's out-of-range index with mode="drop": row j of
# a scatter's input goes to R + j % REPLAY_SINK, so the dropped rows of a
# harvest (most of its B x M rows) do not all store to one address.
REPLAY_SINK = 1024


@dataclass
class Replay:
    """The training-memory ring (the reference `Replay`). Boards are packed
    (int32 u32 bits, as the tree's `obs_bits`); `engine.unpack_obs` makes
    images of them for training. The row arrays hold `capacity` ring rows
    and then REPLAY_SINK rows that are never read. The counters are int32
    device scalars: `idx` the next write slot, `count` the rows held
    (<= capacity), `total` the rows ever written and `cand` the store
    candidates ever seen before the stochastic drop (both monotone);
    `drop_prob` is that drop's probability, set by the host."""

    capacity: int
    boards: torch.Tensor   # int32 (R + sink, 20)
    value: torch.Tensor    # float32 (R + sink,)
    var: torch.Tensor
    weight: torch.Tensor
    idx: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor
    cand: torch.Tensor
    drop_prob: torch.Tensor

    def rows(self):
        """The ring rows (boards, value, var, weight), sink excluded."""
        R = self.capacity
        return self.boards[:R], self.value[:R], self.var[:R], self.weight[:R]


def init_replay(capacity: int, device="cuda") -> Replay:
    n = capacity + REPLAY_SINK
    zi = lambda: torch.zeros((), dtype=torch.int32, device=device)
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=device)
    return Replay(capacity=capacity,
                  boards=torch.zeros(n, 20, dtype=torch.int32, device=device),
                  value=zf(n), var=zf(n), weight=zf(n), idx=zi(), count=zi(),
                  total=zi(), cand=zi(), drop_prob=zf(()))


def _sink(R, n, device):
    return R + torch.arange(n, device=device) % REPLAY_SINK


def _scatter_rows(rep: Replay, dst, cols):
    for a, x in zip((rep.boards, rep.value, rep.var, rep.weight), cols):
        a.index_put_((dst,), x)


def replay_add(rep: Replay, packed, value, var, weight, mask, mask_candidates=None):
    """Append the masked rows (any leading shape, flattened) at the ring's
    head, in place. When one call holds more than `capacity` rows only the
    newest `capacity` are kept. `mask_candidates` (default `mask`) is
    counted into `cand`."""
    R = rep.capacity
    mask = mask.reshape(-1)
    cols = (packed.reshape(-1, 20), value.reshape(-1), var.reshape(-1),
            weight.reshape(-1))
    cand = mask if mask_candidates is None else mask_candidates.reshape(-1)
    pos = torch.cumsum(mask, 0) - 1
    n = mask.sum()
    keep = mask & (pos >= n - R)
    dst = torch.where(keep, (rep.idx + pos) % R, _sink(R, mask.shape[0], mask.device))
    _scatter_rows(rep, dst, cols)
    rep.idx.copy_((rep.idx + n) % R)
    rep.count.copy_(torch.clamp_max(rep.count + n, R))
    rep.total.add_(n.to(torch.int32))
    rep.cand.add_(cand.sum().to(torch.int32))


def _logical(rep: Replay):
    """(order, valid): the ring slots oldest first, and which hold rows."""
    ar = torch.arange(rep.capacity, device=rep.boards.device)
    return (rep.idx - rep.count + ar) % rep.capacity, ar < rep.count


def _replay_compact(rep: Replay, keep_logical):
    """Move the kept rows (in age order) to the front of the ring, in place;
    `keep_logical` (R,) is in logical order, oldest first. Returns the rows
    dropped (a device scalar); idx = count = the rows kept."""
    R = rep.capacity
    order, valid = _logical(rep)
    keep = keep_logical & valid
    pos = torch.cumsum(keep, 0) - 1
    kept = keep.sum().to(torch.int32)
    cols = [a[order] for a in (rep.boards, rep.value, rep.var, rep.weight)]
    for a in (rep.boards, rep.value, rep.var, rep.weight):
        a.zero_()
    _scatter_rows(rep, torch.where(keep, pos, _sink(R, R, rep.boards.device)), cols)
    dropped = rep.count - kept
    rep.idx.copy_(kept % R)
    rep.count.copy_(kept)
    return dropped


def replay_trim_weighted(rep: Replay, percentile: float):
    """`weighted_trimming`: drop every row whose weight is <= the
    `percentile` quantile of the stored weights (ties drop together),
    keeping the rest in age order, in place. Returns the rows dropped."""
    R = rep.capacity
    order, valid = _logical(rep)
    w = rep.weight[order]
    ws = torch.sort(torch.where(valid, w, torch.inf)).values
    k = (rep.count.float() * percentile).to(torch.int64)
    return _replay_compact(rep, w > ws[k.clamp(0, R - 1)])


def replay_trim_random(rep: Replay, fraction: float, u):
    """`random_trimming`: drop floor(count * fraction) stored rows, those
    with the smallest of the uniform draws u (R,) (in logical order),
    keeping the rest in age order, in place. Returns the rows dropped."""
    R = rep.capacity
    _, valid = _logical(rep)
    m = (rep.count.float() * fraction).to(torch.int64)
    uu = torch.where(valid, u, torch.inf)
    thr = torch.sort(uu).values[(m - 1).clamp(0, R - 1)]
    return _replay_compact(rep, ~(valid & (uu <= thr) & (m > 0)))


def replay_clear(rep: Replay):
    """`memory_index = 0` after a training session: the ring is emptied;
    the monotone counters stay."""
    rep.idx.zero_()
    rep.count.zero_()


def init_batch(seed: int, batch: int, cfg: SearchConfig, device="cuda"):
    """(trees, envs) for B fresh games; envs packed (B, 44) int32."""
    envs = engine.pack_state(engine.reset_batch(seed, batch, cfg.tree.env, device))
    return T.init_tree(envs, cfg.tree), envs
