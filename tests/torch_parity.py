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
              tol, seed=5, start=None, record=None, final_select=True):
    """`moves` moves of the JAX move program and of the port's on the same
    games and randomness: actions, env states, resets, node counts and the
    trees' integer arrays equal; statistics within `tol`; then, with
    `final_select`, one more select walk on the final trees gives equal
    traces (the eager interpreted select costs ~30 s on the CPU). `start`
    gives the initial (jtrees, jenvs, ttrees, tenvs) in place of
    `init_batch(seed)`; the port's MoveStats of every move are appended to
    `record`."""
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

    if not final_select:
        return ttrees, jtrees
    # traces: one more select walk on the final trees, same planes
    key = jax.random.PRNGKey(21)
    want = JW.select_batched_pallas(jtrees, key, jcfg)
    got = W.select_walk(ttrees, *jax_planes(key, B_, jcfg.max_depth), tcfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    return ttrees, jtrees


# ---------------------------------------------------------------------------
# the VP family: the VP search's key schedule, its trees, a stub VP net
# ---------------------------------------------------------------------------

STUB_LOGIT = np.array([0.03, -0.02, 0.011, 0.005, -0.007, 0.017, -0.002], np.float32)


def vp_stubs(scale=1.0):
    """Stand-ins for the VP net, (JAX apply on NHWC images, port apply on
    NCHW images): from the board's cell sum s (an exact integer), value
    0.5 s and logits s x STUB_LOGIT x scale, so the same board gives
    bit-equal outputs in both packages and the priors differ by board
    (a larger scale, a more peaked policy)."""
    c = (STUB_LOGIT * np.float32(scale)).astype(np.float32)

    def jax_apply(p, x):
        s = jnp.sum(x, axis=(1, 2, 3))
        return (0.5 * s)[:, None], s[:, None] * jnp.asarray(c)

    def torch_apply(x):
        s = x.sum(dim=(1, 2, 3))
        return 0.5 * s, s[:, None] * torch.as_tensor(c, device=x.device)

    return jax_apply, torch_apply


@jax.jit
def _vp_uniforms_jit(k_sel, zeros_bd):
    B, D = zeros_bd.shape
    keys = jax.random.split(k_sel, B)

    def body(keys, _):
        ks = jax.vmap(jax.random.split)(keys)
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(ks[:, 1])
        return ks[:, 0], u

    _, us = jax.lax.scan(body, keys, None, length=D)
    return us.T


def vp_uniforms(k_sel, B_, D):
    """The uniforms (B, D) that the JAX VP `select_batched` draws from the
    keys split(k_sel, B): per level, `keys, sub = split(keys)` a lane and
    `jax.random.choice`'s `uniform(sub, ())`."""
    return torch.as_tensor(np.array(_vp_uniforms_jit(k_sel, jnp.zeros((B_, D)))))


class JaxVPKeyPlanes:
    """Replays the JAX VP driver's key schedule: per move `key, sub =
    split(key)` (VPSelfPlayDriver.step), `_, k_sims = split(sub)`
    (make_vp_move_fn), then per sim `key, k_sel = split(key)` and the select
    walk's uniforms from `split(k_sel, B)` (`vp_uniforms`)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def next_move(self):
        self.key, sub = jax.random.split(self.key)
        _, self._k = jax.random.split(sub)
        return sub

    def uniforms(self, B_, D):
        self._k, k_sel = jax.random.split(self._k)
        return vp_uniforms(k_sel, B_, D)


def vp_tree_from_jax(jvt):
    """A batched JAX VPTree as the port's."""
    from tetris_mcts_tpu_torch.search import vp as VP

    t = lambda x: torch.as_tensor(np.array(x, np.float32))
    return VP.VPTree(tree_from_jax(jvt.base), t(jvt.prior), t(jvt.pol_new))


def assert_vp_tree_equal(got, jvt, tol=STAT_TOL, msg=""):
    """The base tree's integer arrays and visits equal, values within tol,
    pol_new equal, prior within rtol 1e-6 / atol 1e-7 (a softmax in two
    frameworks)."""
    assert_tree_equal(got.base, jvt.base, stats_tol=tol, msg=msg)
    np.testing.assert_array_equal(got.pol_new.numpy(), np.asarray(jvt.pol_new),
                                  err_msg=f"pol_new {msg}")
    np.testing.assert_allclose(got.prior.numpy(), np.asarray(jvt.prior), rtol=1e-6,
                               atol=1e-7, err_msg=f"prior {msg}")


def torch_gumbels_of(planes):
    """`draw(B, step)` for the port's policy playout replaying the JAX
    `policy_rollout_evaluator`'s draws from the simulation's k_ev: per step
    `k, sub = split(k)` and `categorical`'s `gumbel(sub, (B, 7))`."""

    def draw(B_, step):
        if step == 0:
            planes._k_roll = planes._k_ev
        planes._k_roll, sub = jax.random.split(planes._k_roll)
        return torch.as_tensor(np.array(jax.random.gumbel(sub, (B_, 7))))

    return draw


# ---------------------------------------------------------------------------
# the XLA walks' draws: `tree.select_batched` and the distributional
# `select_batched` split a key per lane per level
# ---------------------------------------------------------------------------

@jax.jit
def _xla_walk_gumbels_jit(k_sel, zeros_bd):
    B, D = zeros_bd.shape
    keys = jax.random.split(k_sel, B)

    def body(keys, _):
        ks = jax.vmap(jax.random.split)(keys)
        g = jax.vmap(lambda k: jax.random.gumbel(k, (7,)))(ks[:, 1])
        return ks[:, 0], g

    _, gs = jax.lax.scan(body, keys, None, length=D)
    return jnp.swapaxes(gs, 0, 1)


def xla_walk_gumbels(k_sel, B_, D):
    """The gumbels (B, D, 7) that the JAX package's XLA select walks draw
    from the keys split(k_sel, B) under a rule without per-child draws (clt,
    max, the distributional rule): per level, `keys, sub = split(keys)` a
    lane and `gumbel(sub, (7,))`. Level d's draws do not depend on where
    the walk stops, so all D levels are drawn."""
    return torch.as_tensor(np.array(_xla_walk_gumbels_jit(k_sel, jnp.zeros((B_, D)))))


class JaxXlaWalkKeyPlanes(JaxKeyPlanes):
    """`JaxKeyPlanes` for a JAX move program that selects with the XLA walk
    (`--policy max`, or `select_kernel=False`): the simulation's k_sel feeds
    `xla_walk_gumbels`; no per-child planes."""

    def __call__(self, B_, D):
        self._k, k_sel, self._k_ev = jax.random.split(self._k, 3)
        return xla_walk_gumbels(k_sel, B_, D), torch.zeros(B_, D, 7)


class JaxDistKeyPlanes(JaxVPKeyPlanes):
    """Replays the JAX distributional move's key schedule (the VP one: per
    move `_, k_sims = split(sub)`, per sim `key, k_sel = split(key)`) as the
    select walk's gumbels `xla_walk_gumbels(k_sel)`."""

    def level_gumbels(self, B_, D):
        self._k, k_sel = jax.random.split(self._k)
        return xla_walk_gumbels(k_sel, B_, D)
