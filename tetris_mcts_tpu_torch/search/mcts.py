"""Batched MCTS moves with the leaf-parallel, leaf and rollout evaluators.

Counterpart of the reference package's `search/mcts.py` on the path of
frozen-net self-play (`store=False`, `episode_reuse=False`). One
simulation for all B trees:

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
tree is wiped and re-rooted at its (soft-reset) env. The lp and leaf moves
stay on the device: they never read a value back to the host, so the
driver's one read per move is the only synchronisation. The rollout reads
one flag every `ROLLOUT_EXIT_EVERY` playout steps, to stop once every
playout has ended.

Randomness: the select walk takes pre-drawn (B, D, 7) gumbel planes (and
per-child planes for the mc/random policies), and the rollout one action
draw per step. `TorchPlanes` draws both from a `torch.Generator` on the
device; a test can pass any other source, for example one that replays the
JAX key schedule.
"""

from __future__ import annotations

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


def make_move_fn(evaluator: Callable, cfg: SearchConfig, planes: Callable):
    """`move(trees, envs) -> (envs, MoveStats)`: one batched move in
    benchmark mode (no replay store, a fresh tree per episode). envs are
    packed (B, 44) int32 states; trees are updated in place."""
    tcfg = cfg.tree
    run_sims = make_run_sims(evaluator, cfg, planes)
    guard = capacity_guard_for(cfg.sims, tcfg)
    env_kw = dict(actions_per_drop=tcfg.env.actions_per_drop,
                  scoring=tcfg.env.scoring, randomizer=tcfg.env.randomizer)

    def move(trees: Tree, envs):
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
        trigger = done | full | (trees.root == 0)
        n_nodes_before = trees.n_nodes.clone()
        fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), tcfg.env))
        envs3 = torch.where(done[:, None], fresh, envs2)
        T.reset_trees(trees, envs3, trigger, tcfg)
        out = MoveStats(
            action=action, probs=probs, child_stats=stats, root_value=rv,
            root_var=rvar, score=envs2[:, 36], lines=envs2[:, 38], done=done,
            reset=trigger, n_nodes=n_nodes_before,
        )
        return envs3, out

    return move


def init_batch(seed: int, batch: int, cfg: SearchConfig, device="cuda"):
    """(trees, envs) for B fresh games; envs packed (B, 44) int32."""
    envs = engine.pack_state(engine.reset_batch(seed, batch, cfg.tree.env, device))
    return T.init_tree(envs, cfg.tree), envs
