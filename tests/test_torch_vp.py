"""The port's VP search (`search/vp.py`, the ApproxPolicyIter agent) against
the JAX package's `search/vp.py`, on the CPU.

- A 3-move slice of the move program (B=8, 12 sims, pools of 256, depth
  24) with a stub VP net whose outputs are bit-equal in both packages
  (`torch_parity.vp_stubs`), fed the same randomness (the JAX VP key
  schedule replayed, `JaxVPKeyPlanes`): actions, root policies, env states,
  resets, the trees' integer arrays, visits and improvement counts equal;
  values within rtol 1e-6 / atol 1e-5, priors (a softmax in each
  framework) within rtol 1e-6 / atol 1e-7; the ring's rows equal.
- On the slice's final trees: `select_batched` fed the uniforms the JAX
  key schedule draws (traces, actions and lengths equal); `replay_leaf`
  and `expand_children` (packed states equal); `backup_value_policy_batched`
  (visits and pol_new equal, values within rtol 1e-6 / atol 1e-5);
  `harvest` + `vp_replay_add` (rows equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.search import vp as JVP
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.search import vp as VP
from torch_parity import (STAT_TOL, JaxVPKeyPlanes, as_i32, assert_vp_tree_equal,
                          vp_stubs, vp_uniforms)

torch.set_num_threads(1)

B, SIMS, MOVES, MIN_VISITS = 8, 12, 3, 2
VP_STUB_SCALE = 10.0  # priors peaked enough for paths of several levels
N_PER_MOVE = 7 * SIMS // 2  # nodes a move at least: half the sims expand
JCFG = JT.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=24)
TCFG = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=24)


def ring_rows(rep):
    n = int(rep.count)
    return [np.asarray(x)[:n] for x in (rep.boards, rep.value, rep.policy, rep.weight)]


@pytest.fixture(scope="module")
def vp_slice():
    """MOVES moves of both move programs from the same games; returns the
    (JAX, port) trees after the move whose trees hold the most nodes (the
    walks' tests run on them; a later move resets them)."""
    vp_stub_apply, torch_vp_stub = vp_stubs(VP_STUB_SCALE)
    move_j = jax.jit(JVP.make_vp_move_fn(vp_stub_apply, JM.SearchConfig(tree=JCFG, sims=SIMS),
                                         min_visits_store=MIN_VISITS))
    planes = JaxVPKeyPlanes(4)
    move_t = VP.make_vp_move_fn(torch_vp_stub, M.SearchConfig(tree=TCFG, sims=SIMS), planes,
                                min_visits_store=MIN_VISITS)
    jvt, jenvs = JVP.init_vp_batch(6, B, JM.SearchConfig(tree=JCFG))
    tvt, tenvs = VP.init_vp_batch(6, B, M.SearchConfig(tree=TCFG), device="cpu")
    jrep, trep = JVP.init_vp_replay(512), VP.init_vp_replay(512, "cpu")
    assert_vp_tree_equal(tvt, jvt)
    resets, grown = 0, None
    for mv in range(MOVES):
        sub = planes.next_move()
        jvt, jenvs, jrep, jst = move_j(None, jvt, jenvs, jrep, sub)
        tenvs, tst = move_t(tvt, tenvs, trep)
        np.testing.assert_array_equal(tst.action.numpy(), np.asarray(jst.action),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(tst.probs.numpy(), np.asarray(jst.probs))
        np.testing.assert_allclose(tst.root_value.numpy(), np.asarray(jst.root_value),
                                   **STAT_TOL)
        np.testing.assert_array_equal(tenvs.numpy(), as_i32(JE.pack_state(jenvs)))
        np.testing.assert_array_equal(tst.reset.numpy(), np.asarray(jst.reset))
        resets += int(tst.reset.sum())
        assert_vp_tree_equal(tvt, jvt, msg=f"move {mv}")
        if grown is None or int(tvt.base.n_nodes.min()) > int(grown[1].base.n_nodes.min()):
            grown = (jvt, tvt.clone())
        assert int(trep.total) == int(jrep.total) and int(trep.idx) == int(jrep.idx)
        for name, a, b in zip(("boards", "value", "policy", "weight"),
                              ring_rows(trep), ring_rows(jrep)):
            np.testing.assert_allclose(a, b if name != "boards" else as_i32(b), err_msg=name,
                                       **STAT_TOL)
    # the slice expanded, sampled from net priors, backed up, and reset
    # every tree once its pool could not hold another move
    assert resets == B and int(trep.total) > 0
    jvt, tvt = grown
    assert float(tvt.prior.sum()) > 0 and float(tvt.pol_new.sum()) > SIMS
    return jvt, tvt


def test_vp_slice_matches_jax(vp_slice):
    jvt, tvt = vp_slice
    assert int(tvt.base.n_nodes.min()) > 2 * N_PER_MOVE  # trees grew over two moves


def test_select_matches_jax(vp_slice):
    jvt, tvt = vp_slice
    k_sel = jax.random.PRNGKey(17)
    want = jax.jit(JVP.select_batched, static_argnums=2)(jvt, jax.random.split(k_sel, B), JCFG)
    traces, acts, lengths, levels = VP.select_batched(tvt, vp_uniforms(k_sel, B, 24), TCFG)
    np.testing.assert_array_equal(traces.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(acts.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[2]))
    assert int(lengths.max()) > 2 and levels >= int(lengths.max())
    assert levels % T.WALK_EXIT_EVERY == 0 and levels < TCFG.max_depth


def test_replay_leaf_and_expand_children_match_jax(vp_slice):
    jvt, tvt = vp_slice
    k_sel = jax.random.PRNGKey(23)
    traces, acts, lengths = jax.jit(JVP.select_batched, static_argnums=2)(
        jvt, jax.random.split(k_sel, B), JCFG)
    jleaf = jax.jit(JT.replay_leaf_batched, static_argnums=3)(jvt.base, acts, lengths, JCFG)
    t_acts, t_len = torch.as_tensor(np.array(acts)), torch.as_tensor(np.array(lengths))
    for levels in (None, int(t_len.max())):
        leaf = T.replay_leaf(tvt.base, t_acts, t_len, TCFG, levels)
        np.testing.assert_array_equal(leaf.numpy(), as_i32(JE.pack_state(jleaf)))
    assert int(t_len.max()) > 2
    ch, packed7 = jax.vmap(JT.expand_children, in_axes=(0, 0, None))(jvt.base, jleaf, JCFG)
    env7, tpacked7, score7, end7 = T.expand_children(leaf, TCFG)
    np.testing.assert_array_equal(env7.numpy(), as_i32(jax.vmap(JE.pack_state)(ch)))
    np.testing.assert_array_equal(tpacked7.numpy(), as_i32(packed7))
    np.testing.assert_array_equal(score7.numpy(), np.asarray(ch.score))
    np.testing.assert_array_equal(end7.numpy(), np.asarray(ch.end))
    np.testing.assert_array_equal(T.headroom(tvt.base, TCFG).numpy(),
                                  np.asarray(jax.vmap(JT.headroom, in_axes=(0, None))(
                                      jvt.base, JCFG)))
    np.testing.assert_array_equal(
        T.children_of(tvt.base, tvt.base.root).numpy(),
        np.asarray(jax.vmap(JT.children_of)(jvt.base, jvt.base.root)))


def test_backup_value_policy_matches_jax(vp_slice):
    jvt, tvt = vp_slice
    k_sel = jax.random.PRNGKey(29)
    traces, acts, lengths, levels = VP.select_batched(tvt, vp_uniforms(k_sel, B, 24), TCFG)
    values = torch.as_tensor(np.random.RandomState(3).uniform(0, 60, B).astype(np.float32))
    got = tvt.clone()
    VP.backup_value_policy_batched(got, traces, lengths, values, levels)
    want = jax.jit(JVP.backup_value_policy_batched, static_argnums=4)(
        jvt, jnp.asarray(traces.numpy()), jnp.asarray(lengths.numpy()),
        jnp.asarray(values.numpy()), JCFG)
    assert_vp_tree_equal(got, want)
    assert float((got.pol_new - tvt.pol_new).sum()) == float(lengths.sum())


def test_harvest_and_replay_add_match_jax(vp_slice):
    jvt, tvt = vp_slice
    jh = jax.vmap(JVP.harvest, in_axes=(0, None, None))(jvt, 1, JCFG)
    th = VP.harvest(tvt, 1)
    np.testing.assert_array_equal(th[0].numpy(), as_i32(jh[0]))
    for a, b in zip(th[1:], jh[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # two adds into a ring smaller than one add: latest-wins wrap
    mask = th[4] & torch.as_tensor([True, False] * (B // 2))[:, None]
    jrep, trep = JVP.init_vp_replay(32), VP.init_vp_replay(32, "cpu")
    for _ in range(2):
        jrep = JVP.vp_replay_add(jrep, *jh[:4], jnp.asarray(mask.numpy()))
        VP.vp_replay_add(trep, *th[:4], mask)
    assert int(mask.sum()) > 32 and int(trep.total) == int(jrep.total) == 2 * int(mask.sum())
    assert int(trep.cand) == 0
    for a, b in zip(trep.rows(), (jrep.boards, jrep.value, jrep.policy, jrep.weight)):
        np.testing.assert_array_equal(a.numpy(), as_i32(b) if a.dtype == torch.int32
                                      else np.asarray(b))
    assert int(trep.idx) == int(jrep.idx) and int(trep.count) == int(jrep.count)
