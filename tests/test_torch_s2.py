"""The port's stochastic-transition search (`search/stochastic.py`, the
ValueSim2 agent) against the JAX package's `search/stochastic.py`, on the
CPU.

- The action statistics (`_action_stats`: Q, U and the never-tried mask)
  on `tests/test_stochastic.py`'s hand tree, at every obs that holds edges
  and at empty ones: the mask and n_a equal, Q equal (sums in the same
  order), U within rtol 1e-6 (XLA's CPU rsqrt and float32 log are within
  an ulp of the port's 1/sqrt and rounded float64 log); both also against
  that file's float64 transcription of the reference (rtol 1e-5).
- A 3-move slice of the move program (B=3, 6 sims, pools of 128, depth 16,
  min_visits 1, so a harvest is stored) with the linspace stub net of
  `torch_parity` and the JAX move on its kernel path (the Pallas insert
  interpreted): actions, edge-count policies, env states, resets, the
  trees' integer arrays and visits, the edge tables and the ring's rows
  equal; values, vars and max_ret within rtol 1e-6 / atol 1e-5. The slice
  resets a tree once its pool is full.
- On the slice's grown trees: one `select_batched` (traces, actions,
  lengths equal) and the `backup_batched` of its traces from random values
  (edge tables and visits equal, values, vars and max_ret within rtol 1e-6
  / atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import stochastic as JS
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import stochastic as S2
from tetris_mcts_tpu_torch.search import tree as T
from test_stochastic import _hand_tree, _np_tmp_select
from torch_parity import STAT_TOL, as_i32, assert_tree_equal, stub_apply, torch_stub, tree_from_jax

torch.set_num_threads(1)

B, SIMS, MOVES = 3, 6, 3
JCFG = JT.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=16)
TCFG = T.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=16)
EDGES = ("edge_child", "edge_count", "edge_dscore")


def s2_from_jax(jvt):
    """A batched JAX S2Tree as the port's: the edge tables (B, 7, C, M)
    laid out (B, M, 7, C)."""
    edge = lambda x, dt: torch.as_tensor(np.ascontiguousarray(np.moveaxis(np.asarray(x, dt),
                                                                          -1, 1)))
    return S2.S2Tree(tree_from_jax(jvt.base), edge(jvt.edge_child, np.int32),
                     edge(jvt.edge_count, np.float32), edge(jvt.edge_dscore, np.float32),
                     torch.as_tensor(np.array(jvt.max_ret, np.float32)))


def assert_s2_equal(got, jvt, msg=""):
    """The base tree's integer arrays and visits equal, values and vars
    within STAT_TOL; the edge tables equal; max_ret within STAT_TOL."""
    assert_tree_equal(got.base, jvt.base, msg=msg)
    want = s2_from_jax(jvt)
    for f in EDGES:
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                      err_msg=f"{f} {msg}")
    np.testing.assert_allclose(got.max_ret.numpy(), want.max_ret.numpy(),
                               err_msg=f"max_ret {msg}", **STAT_TOL)


def ring_rows(rep):
    n = int(rep.count)
    return [np.asarray(x)[:n] for x in (rep.boards, rep.value, rep.var, rep.weight)]


def test_action_stats_match_jax_on_the_hand_tree():
    vt, (ech, ecn, eds, values, visits, max_ret) = _hand_tree()
    s2 = s2_from_jax(jax.tree.map(lambda x: x[None], vt))
    stats = jax.jit(JS._action_stats)
    for o in range(24):  # obs 1-19 hold edges, the others none
        jq, ju, jnever = (np.asarray(x) for x in stats(vt, jnp.int32(o)))
        q, u, never, n_a = (x[0].numpy() for x in S2._action_stats(s2, torch.tensor([o])))
        np.testing.assert_array_equal(never, jnever, err_msg=f"obs {o}")
        np.testing.assert_array_equal(n_a, ecn[:, :, o].sum(1), err_msg=f"obs {o}")
        np.testing.assert_array_equal(q, jq, err_msg=f"obs {o}")
        np.testing.assert_allclose(u, ju, rtol=1e-6, atol=0, err_msg=f"obs {o}")
        qn, un, nn = _np_tmp_select(ech[:, :, o], ecn[:, :, o], eds[:, :, o], values,
                                    visits, max_ret)
        np.testing.assert_allclose(q, qn, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(u, un, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(never, nn)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def s2_slice(monkeypatch_module):
    """MOVES moves of both move programs from the same games; returns the
    (JAX, port) trees after the move whose trees hold the most nodes."""
    monkeypatch_module.setattr(JW, "use_walk_kernels", lambda: True)
    move_j = jax.jit(JS.make_s2_move_fn(stub_apply, JM.SearchConfig(tree=JCFG, sims=SIMS),
                                        min_visits_store=1))
    move_t = S2.make_s2_move_fn(torch_stub, M.SearchConfig(tree=TCFG, sims=SIMS),
                                min_visits_store=1)
    jvt, jenvs = JS.init_s2_batch(4, B, JM.SearchConfig(tree=JCFG))
    tvt, tenvs = S2.init_s2_batch(4, B, M.SearchConfig(tree=TCFG), device="cpu")
    jrep, trep = JM.init_replay(512), M.init_replay(512, "cpu")
    assert_s2_equal(tvt, jvt)
    key = jax.random.PRNGKey(0)  # split and never read: the S2 move draws nothing
    resets, grown = 0, None
    for mv in range(MOVES):
        key, sub = jax.random.split(key)
        jvt, jenvs, jrep, jst = move_j(None, None, jvt, jenvs, jrep, sub)
        tenvs, tst = move_t(tvt, tenvs, trep)
        np.testing.assert_array_equal(tst.action.numpy(), np.asarray(jst.action),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(tst.probs.numpy(), np.asarray(jst.probs))
        np.testing.assert_allclose(tst.root_value.numpy(), np.asarray(jst.root_value),
                                   **STAT_TOL)
        np.testing.assert_array_equal(tenvs.numpy(), as_i32(JE.pack_state(jenvs)))
        np.testing.assert_array_equal(tst.reset.numpy(), np.asarray(jst.reset))
        resets += int(tst.reset.sum())
        assert_s2_equal(tvt, jvt, msg=f"move {mv}")
        if grown is None or int(tvt.base.n_nodes.min()) > int(grown[1].base.n_nodes.min()):
            grown = (jvt, tvt.clone())
        assert int(trep.total) == int(jrep.total) and int(trep.idx) == int(jrep.idx)
        got, want = ring_rows(trep), ring_rows(jrep)
        np.testing.assert_array_equal(got[0], as_i32(want[0]))
        np.testing.assert_array_equal(got[3], want[3])
        for a, c in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(a, c, **STAT_TOL)
    # the slice expanded, recorded edges, stored and reset
    assert resets >= 1 and int(trep.total) > 0
    jvt, tvt = grown
    assert int(tvt.edge_count.sum()) > 0 and float(tvt.max_ret.max()) > 0
    return jvt, tvt


def test_s2_slice_matches_jax(s2_slice):
    jvt, tvt = s2_slice
    assert int(tvt.base.n_nodes.min()) > 7 * SIMS // 2  # the trees grew
    assert int((tvt.edge_child > 0).sum(-1).max()) >= 1


def test_select_and_backup_match_jax(s2_slice):
    jvt, tvt = s2_slice
    want = jax.jit(JS.select_batched, static_argnums=1)(jvt, JCFG)
    traces, acts, lengths, levels = S2.select_batched(tvt, TCFG)
    for a, c in zip((traces, acts, lengths), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert int(lengths.max()) > 1 and levels >= int(lengths.max())
    values = torch.as_tensor(np.random.RandomState(3).uniform(0, 60, B), dtype=torch.float32)
    got = tvt.clone()
    S2.backup_batched(got, traces, acts, lengths, values, levels)
    jout = jax.jit(JS.backup_batched, static_argnums=5)(
        jvt, jnp.asarray(traces.numpy()), jnp.asarray(acts.numpy()),
        jnp.asarray(lengths.numpy()), jnp.asarray(values.numpy()), JCFG)
    assert_s2_equal(got, jout)
    assert float((got.base.visits - tvt.base.visits).sum()) == float(lengths.sum())
    assert float((got.edge_count - tvt.edge_count).sum()) == float((lengths - 1).sum())
