"""The port's distributional search (`search/distributional.py`, the
DistValueSim agent) against the JAX package's `search/distributional.py`,
on the CPU.

- `shift_distribution_batched` and `mean_dist` on random distributions
  and shifts (inside the support, across the top and under 0): under the
  shifts x >= 0 the search makes, every bin below the clamped top one
  equal; the bins that collect several terms (the top, and bins 0-1 under
  x < 0) and the mean within rtol 1e-6 / atol 1e-7 (the port sums them in
  a pairwise tree, XLA in order).
- A 4-move slice of the move program (B=4, 6 sims, pools of 128, depth 12,
  16 atoms on [0, 200]) with a stub net whose distributions are bit-equal in
  both packages (`dist_stubs`), fed the same randomness (the JAX key
  schedule replayed, `JaxDistKeyPlanes`): actions, visit policies, env
  states, resets, the trees' integer arrays and visits equal; values and
  m2 within rtol 1e-6 / atol 1e-5; the distributions within DIST_TOL; the
  ring's boards and weights equal, its target rows within DIST_TOL. The
  slice harvests and resets every tree once its pool is full.
- On the slice's grown trees: `select_batched` fed the gumbels the JAX
  key schedule draws (traces, actions and lengths equal); `backup_batched`
  from random leaf distributions and returns (visits equal, values and m2
  within rtol 1e-6 / atol 1e-5, distributions within DIST_TOL); `harvest`
  + `dist_replay_add` into a ring smaller than one add (rows equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.search import distributional as JD
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.search import distributional as DD
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from torch_parity import (STAT_TOL, JaxDistKeyPlanes, as_i32, assert_tree_equal,
                          tree_from_jax, xla_walk_gumbels)

torch.set_num_threads(1)

B, SIMS, MOVES, MIN_VISITS, ATOMS, VMAX = 4, 6, 4, 1, 16, 200.0
# the running-mean distributions: their top bins sum the shifted mass in
# another order than XLA's, and XLA's CPU code may contract (cur * n + new)
# into one FMA; the error stays within a few float32 ulps of 1
DIST_TOL = dict(rtol=1e-6, atol=1e-6)
JCFG = JT.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=12)
TCFG = T.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=12)
JDCFG = JD.DistConfig(atoms=ATOMS, vmax=VMAX, low=5)
DCFG = DD.DistConfig(atoms=ATOMS, vmax=VMAX, low=5)


def dist_stubs(atoms=ATOMS):
    """Stand-ins for the distributional net, (JAX apply on NHWC images, port
    apply on NCHW images): from the board's cell sum s (an exact integer),
    weights w_b = (s + 3 b) mod 5 + 1 over the bins, normalised. Exact
    integer sums and one division: bit-equal in both packages."""
    b = np.arange(atoms, dtype=np.float32) * 3

    def jax_apply(p, x):
        w = jnp.mod(jnp.sum(x, axis=(1, 2, 3))[:, None] + b, 5.0) + 1.0
        return w / jnp.sum(w, axis=1, keepdims=True)

    def torch_apply(x):
        w = torch.remainder(x.sum(dim=(1, 2, 3))[:, None] + torch.as_tensor(b), 5.0) + 1.0
        return w / w.sum(1, keepdim=True)

    return jax_apply, torch_apply


def dist_tree_from_jax(jdt):
    t = lambda x: torch.as_tensor(np.array(x, np.float32))
    return DD.DistTree(tree_from_jax(jdt.base), t(jdt.obs_dist), t(jdt.obs_m2))


def assert_dist_tree_equal(got, jdt, msg=""):
    assert_tree_equal(got.base, jdt.base, msg=msg)
    np.testing.assert_allclose(got.obs_m2.numpy(), np.asarray(jdt.obs_m2),
                               err_msg=f"obs_m2 {msg}", **STAT_TOL)
    np.testing.assert_allclose(got.obs_dist.numpy(), np.asarray(jdt.obs_dist),
                               err_msg=f"obs_dist {msg}", **DIST_TOL)


def ring_rows(rep):
    n = int(rep.count)
    return [np.asarray(x)[:n] for x in (rep.boards, rep.dist, rep.weight)]


def random_dists(rng, n, atoms=ATOMS):
    p = rng.uniform(0, 1, (n, atoms)).astype(np.float32) ** 3
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


def test_shift_and_mean_match_jax():
    rng = np.random.RandomState(0)
    n = 64
    dist = random_dists(rng, n)
    # shifts inside the support, exactly on bin edges, across the top, below 0
    x = np.concatenate([rng.uniform(0, VMAX, 40), np.arange(8) * VMAX / ATOMS,
                        rng.uniform(VMAX, 3 * VMAX, 8), rng.uniform(-VMAX, 0, 8)])
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(JD.shift_distribution_batched, static_argnums=2)(
        jnp.asarray(dist), jnp.asarray(x), JDCFG))
    got = DD.shift_distribution_batched(torch.as_tensor(dist), torch.as_tensor(x), DCFG).numpy()
    # x >= 0: every bin below the top takes one term of each kind
    np.testing.assert_array_equal(got[x >= 0, :-1], want[x >= 0, :-1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    assert (got[:, -1] > 0.5).sum() >= 8 and (got[x < 0, 0] > 0).all()  # clamped ends
    np.testing.assert_allclose(DD.mean_dist(torch.as_tensor(dist), DCFG).numpy(),
                               np.asarray(JD.mean_dist(jnp.asarray(dist), JDCFG)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(DD.centers(DCFG).numpy(), np.asarray(JD.centers(JDCFG)))


@pytest.fixture(scope="module")
def dist_slice():
    """MOVES moves of both move programs from the same games; returns the
    (JAX, port) trees after the move whose trees hold the most nodes."""
    jax_apply, torch_apply = dist_stubs()
    move_j = jax.jit(JD.make_dist_move_fn(jax_apply, JM.SearchConfig(tree=JCFG, sims=SIMS),
                                          JDCFG, min_visits_store=MIN_VISITS))
    planes = JaxDistKeyPlanes(4)
    move_t = DD.make_dist_move_fn(torch_apply, M.SearchConfig(tree=TCFG, sims=SIMS), DCFG,
                                  planes, min_visits_store=MIN_VISITS)
    jdt, jenvs = JD.init_dist_batch(6, B, JM.SearchConfig(tree=JCFG), JDCFG)
    tdt, tenvs = DD.init_dist_batch(6, B, M.SearchConfig(tree=TCFG), DCFG, device="cpu")
    jrep, trep = JD.init_dist_replay(1024, ATOMS), DD.init_dist_replay(1024, ATOMS, "cpu")
    assert_dist_tree_equal(tdt, jdt)
    resets, grown = 0, None
    for mv in range(MOVES):
        sub = planes.next_move()
        jdt, jenvs, jrep, jst = move_j(None, jdt, jenvs, jrep, sub)
        tenvs, tst = move_t(tdt, tenvs, trep)
        np.testing.assert_array_equal(tst.action.numpy(), np.asarray(jst.action),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(tst.probs.numpy(), np.asarray(jst.probs))
        np.testing.assert_allclose(tst.root_value.numpy(), np.asarray(jst.root_value),
                                   **STAT_TOL)
        np.testing.assert_array_equal(tenvs.numpy(), as_i32(JE.pack_state(jenvs)))
        np.testing.assert_array_equal(tst.reset.numpy(), np.asarray(jst.reset))
        resets += int(tst.reset.sum())
        assert_dist_tree_equal(tdt, jdt, msg=f"move {mv}")
        if grown is None or int(tdt.base.n_nodes.min()) > int(grown[1].base.n_nodes.min()):
            grown = (jdt, tdt.clone())
        assert int(trep.total) == int(jrep.total) and int(trep.idx) == int(jrep.idx)
        got, want = ring_rows(trep), ring_rows(jrep)
        np.testing.assert_array_equal(got[0], as_i32(want[0]))
        np.testing.assert_allclose(got[1], want[1], err_msg="ring dist", **DIST_TOL)
        np.testing.assert_array_equal(got[2], want[2])
    # the slice expanded, backed up distributions, stored and reset
    assert resets >= B and int(trep.total) > 0
    n = int(trep.count)
    np.testing.assert_allclose(trep.dist[:n].sum(1).numpy(), 1.0, rtol=1e-5)
    jdt, tdt = grown
    assert float(tdt.obs_m2.max()) > 0 and float(tdt.obs_dist[:, -1].max()) > 0
    return jdt, tdt


def test_dist_slice_matches_jax(dist_slice):
    jdt, tdt = dist_slice
    assert int(tdt.base.n_nodes.min()) > 7 * SIMS // 2  # the trees grew


def test_select_matches_jax(dist_slice):
    jdt, tdt = dist_slice
    k_sel = jax.random.PRNGKey(17)
    want = jax.jit(JD.select_batched, static_argnums=(2, 3))(
        jdt, jax.random.split(k_sel, B), JCFG, JDCFG)
    traces, acts, lengths, levels = DD.select_batched(
        tdt, xla_walk_gumbels(k_sel, B, JCFG.max_depth), TCFG, DCFG)
    np.testing.assert_array_equal(traces.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(acts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[2]))
    assert int(lengths.max()) > 1 and levels >= int(lengths.max())


def test_backup_matches_jax(dist_slice):
    jdt, tdt = dist_slice
    k_sel = jax.random.PRNGKey(29)
    traces, acts, lengths, levels = DD.select_batched(
        tdt, xla_walk_gumbels(k_sel, B, JCFG.max_depth), TCFG, DCFG)
    rng = np.random.RandomState(3)
    b = torch.arange(B)
    leaf_score = tdt.base.nstat[b, 0, traces[b, lengths.long() - 1].long()]
    # returns from the leaf's score to past the support's top
    r = (leaf_score + torch.as_tensor(rng.uniform(0, 2 * VMAX, B), dtype=torch.float32))
    dist = torch.as_tensor(random_dists(rng, B))
    got = tdt.clone()
    DD.backup_batched(got, traces, lengths, r, dist, DCFG, levels)
    want = jax.jit(JD.backup_batched, static_argnums=(5, 6))(
        jdt, jnp.asarray(traces.numpy()), jnp.asarray(lengths.numpy()),
        jnp.asarray(r.numpy()), jnp.asarray(dist.numpy()), JCFG, JDCFG)
    assert_dist_tree_equal(got, want)
    assert float((got.base.visits - tdt.base.visits).sum()) == float(lengths.sum())


def test_harvest_and_replay_add_match_jax(dist_slice):
    jdt, tdt = dist_slice
    jh = jax.vmap(JD.harvest, in_axes=(0, None, None))(jdt, 1, JCFG)
    th = DD.harvest(tdt, 1)
    np.testing.assert_array_equal(th[0].numpy(), as_i32(jh[0]))
    np.testing.assert_allclose(th[1].numpy(), np.asarray(jh[1]), **DIST_TOL)
    for a, c in zip(th[2:], jh[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    # two adds into a ring smaller than one add: latest-wins wrap; the port's
    # rows go in from the JAX harvest, so the rings' rows are equal
    jrows = [torch.as_tensor(np.array(x)) for x in jh]
    jrows[0] = torch.as_tensor(as_i32(jh[0]))
    mask = th[3] & torch.as_tensor([True, False] * (B // 2))[:, None]
    jrep, trep = JD.init_dist_replay(8, ATOMS), DD.init_dist_replay(8, ATOMS, "cpu")
    for _ in range(2):
        jrep = JD.dist_replay_add(jrep, *jh[:3], jnp.asarray(mask.numpy()))
        DD.dist_replay_add(trep, *jrows[:3], mask)
    assert int(mask.sum()) > 8 and int(trep.total) == int(jrep.total) == 2 * int(mask.sum())
    assert int(trep.cand) == 0
    for a, c in zip(trep.rows(), (jrep.boards, jrep.dist, jrep.weight)):
        np.testing.assert_array_equal(a.numpy(), as_i32(c) if a.dtype == torch.int32
                                      else np.asarray(c))
    assert int(trep.idx) == int(jrep.idx) and int(trep.count) == int(jrep.count)
