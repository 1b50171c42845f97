"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
JAX package's batched trees as the port's, tree comparison, the JAX key
schedule replayed as the port's randomness sources, and a multi-move run of
the JAX move program against the port's.

The JAX move programs run on their kernel path (`tree_walk.use_walk_kernels`
patched to True by the calling test), so the Pallas kernels run
interpreted on the CPU, as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.train.trainer import VVModel, params_from_jax

# TestShardedKernels' tree config and growth (B=8, 9 sims, seeds 31 / 6)
JCFG = JT.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=32)
TCFG = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=32)
B = 8
STAT_TOL = dict(rtol=1e-6, atol=1e-5)


def as_i32(x):
    return np.asarray(x).astype(np.uint32).view(np.int32)


def tree_from_jax(jt) -> T.Tree:
    """A batched JAX Tree as the port's Tree (same arrays, u32 as int32)."""
    t = lambda x, dt=None: torch.as_tensor(np.array(x, dtype=dt))
    return T.Tree(
        cbase=t(jt.cbase, np.int32), nstat=t(jt.nstat, np.float32),
        end=t(jt.end, bool), n_nodes=t(jt.n_nodes, np.int32),
        root_env=t(as_i32(JE.pack_state(jt.root_state))),
        visits=t(jt.visits, np.float32), values=t(jt.values, np.float32),
        vars_=t(jt.vars_, np.float32), obs_end=t(jt.obs_end, bool),
        obs_bits=t(as_i32(jt.obs_bits)), n_obs=t(jt.n_obs, np.int32),
        tbl_h1=t(as_i32(jt.tbl_h1)), tbl_h2=t(as_i32(jt.tbl_h2)),
        tbl_obs=t(jt.tbl_obs, np.int32), root=t(jt.root, np.int32),
    )


def assert_tree_equal(got: T.Tree, jt, stats_tol=STAT_TOL, msg=""):
    want = tree_from_jax(jt)
    for f in ("cbase", "nstat", "end", "n_nodes", "root_env", "visits",
              "obs_end", "obs_bits", "n_obs", "tbl_h1", "tbl_h2", "tbl_obs", "root"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f"{f} {msg}")
    for f in ("values", "vars_"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                   err_msg=f"{f} {msg}", **stats_tol)


def stub_apply(p, u, x):
    return jnp.linspace(1.0, 8.0, x.shape[0]), jnp.full(x.shape[0], 2.5)


def torch_stub(x):
    n = x.shape[0]
    return torch.linspace(1.0, 8.0, n), torch.full((n,), 2.5)


def port_vvmodel(model_j) -> VVModel:
    """The port's VVModel on the CPU with the weights and bounds of the
    JAX package's VVModel `model_j` (`params_from_jax`)."""
    model = VVModel(device="cpu")
    p_np = jax.tree.map(np.asarray, model_j.params)
    model.load_state(*params_from_jax(p_np, model_j.ubound, model_j.lbound))
    return model


def jax_planes(key, B_, D, policy="clt"):
    """The planes `select_batched_pallas` draws from its key: gumbels, and
    normal (mc) or gumbel (random) per-child planes, zeros otherwise."""
    k_low, k_pol = jax.random.split(key)
    g = jax.random.gumbel(k_low, (B_, D, 7))
    if policy == "mc":
        rnd = jax.random.normal(k_pol, (B_, D, 7))
    elif policy == "random":
        rnd = jax.random.gumbel(k_pol, (B_, D, 7))
    else:
        rnd = jnp.zeros((B_, D, 7), jnp.float32)
    return torch.as_tensor(np.array(g)), torch.as_tensor(np.array(rnd))


class JaxKeyPlanes:
    """Replays the JAX driver's key schedule: per move
    `key, sub = split(key)` (SelfPlayDriver.step), `_, k_sims, k_drop =
    split(sub, 3)` (make_move_fn), then per sim `key, k_sel, k_ev =
    split(key, 3)` (make_run_sims), the gumbel draw of
    `select_batched_pallas` from `split(k_sel)[0]`, and the rollout's
    per-step `k, sub = split(k)`; `randint(sub, (B,), 0, 7)` from k_ev
    (`rollout_evaluator`); the store drop's `uniform(k_drop, shape)`."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def next_move(self):
        """The key the JAX driver hands its move program for the next move."""
        self.key, sub = jax.random.split(self.key)
        _, self._k, self._k_drop = jax.random.split(sub, 3)
        return sub

    def drop(self, shape):
        return torch.as_tensor(np.array(jax.random.uniform(self._k_drop, shape)))

    def __call__(self, B_, D):
        self._k, k_sel, self._k_ev = jax.random.split(self._k, 3)
        return jax_planes(k_sel, B_, D)

    def actions(self, B_, step):
        if step == 0:
            self._k_roll = self._k_ev
        self._k_roll, sub = jax.random.split(self._k_roll)
        return torch.as_tensor(np.array(jax.random.randint(sub, (B_,), 0, 7)))


def jax_move_program(ev, jcfg, sims, evaluator, **search_kw):
    """The JAX move program (benchmark mode, no store) for `evaluator`."""
    scfg = JM.SearchConfig(tree=jcfg, sims=sims, evaluator=evaluator, **search_kw)
    return jax.jit(JM.make_move_fn(ev, scfg, store=False))


def run_slice(move_j, params, ubound, move_t, planes, jcfg, tcfg, B_, moves,
              tol, seed=5, start=None, record=None):
    """`moves` moves of the JAX move program and of the port's on the same
    games and randomness: actions, env states, resets, node counts and the
    trees' integer arrays equal; statistics within `tol`; then one more
    select walk on the final trees gives equal traces. `start` gives the
    initial (jtrees, jenvs, ttrees, tenvs) in place of `init_batch(seed)`;
    the port's MoveStats of every move are appended to `record`."""
    if start is None:
        jtrees, jenvs = JM.init_batch(seed, B_, JM.SearchConfig(tree=jcfg))
        ttrees, tenvs = M.init_batch(seed, B_, M.SearchConfig(tree=tcfg), device="cpu")
    else:
        jtrees, jenvs, ttrees, tenvs = start
    replay = JM.init_replay(16)
    assert_tree_equal(ttrees, jtrees)

    for mv in range(moves):
        sub = planes.next_move()
        jtrees, jenvs, replay, jst = move_j(params, ubound, jtrees, jenvs, replay, sub)
        tenvs, tst = move_t(ttrees, tenvs)
        np.testing.assert_array_equal(tst.action.numpy(), np.asarray(jst.action),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(tenvs.numpy(), as_i32(JE.pack_state(jenvs)))
        np.testing.assert_array_equal(tst.reset.numpy(), np.asarray(jst.reset))
        np.testing.assert_array_equal(tst.n_nodes.numpy(), np.asarray(jst.n_nodes))
        np.testing.assert_allclose(tst.child_stats.numpy(), np.asarray(jst.child_stats),
                                   **tol)
        assert_tree_equal(ttrees, jtrees, stats_tol=tol, msg=f"move {mv}")
        if record is not None:
            record.append(tst)

    # traces: one more select walk on the final trees, same planes
    key = jax.random.PRNGKey(21)
    want = JW.select_batched_pallas(jtrees, key, jcfg)
    got = W.select_walk(ttrees, *jax_planes(key, B_, jcfg.max_depth), tcfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return ttrees, jtrees
