"""The port's policy playouts (HybridSim, FiniteSim, FullSim:
`mcts.policy_rollout_evaluator`) and the HybridSim move program against the
JAX package, on the CPU, with a stub VP net whose outputs are bit-equal in
both packages (`torch_parity.vp_stubs`).

- The evaluator alone on leaf states of live games, fed the gumbels the
  JAX evaluator draws from its key (`torch_gumbels_of`): HybridSim's depth
  30 with the value bootstrap, FiniteSim's 50, and FullSim's to the game's
  end under the cap of 512. Values equal. The port tests "every playout has
  ended" once every `ROLLOUT_EXIT_EVERY` steps instead of every step; ended
  lanes are no-ops, so it stops later than the JAX loop and returns the
  same values.
- A 3-move HybridSim slice (4 sims) against the JAX move program on its
  kernel path (`tree_walk.use_walk_kernels` patched to True, so the Pallas
  select and backup run interpreted): actions, env states, resets, node
  counts and the trees' integer arrays equal, statistics within rtol 1e-6 /
  atol 1e-5 (the select kernel's traces on grown trees are held by
  tests/test_torch_rollout.py, on the same kernel path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu_torch.search import mcts as M
from torch_parity import (B, JCFG, STAT_TOL, TCFG, JaxKeyPlanes, as_i32, jax_move_program,
                          run_slice, torch_gumbels_of, vp_stubs)

torch.set_num_threads(1)

SLICE_SIMS, SLICE_MOVES = 4, 3
vp_stub_apply, torch_vp_stub = vp_stubs()  # a flat policy: the gumbels decide


def live_leaves(seed=9, moves=12):
    states = JE.reset_batch(seed, B, JCFG.env)
    rng = np.random.RandomState(0)
    for _ in range(moves):  # a few random moves into each game
        states = JE.step_batch(states, jnp.asarray(rng.randint(0, 7, B), jnp.int32), JCFG.env)
    return states


@pytest.mark.parametrize("evaluator", ["hybrid", "finite", "full"])
def test_policy_playout_matches_jax(evaluator):
    depth, bootstrap = M.POLICY_PLAYOUTS[evaluator]
    jcfg = JM.SearchConfig(tree=JCFG, evaluator=evaluator)
    tcfg = M.SearchConfig(tree=TCFG, evaluator=evaluator)
    depth = M.playout_depth(tcfg)
    assert depth == {"hybrid": 30, "finite": 50, "full": 512}[evaluator]
    key = jax.random.PRNGKey(3)
    states = live_leaves()
    v_j, var_j = jax.jit(JM.policy_rollout_evaluator(vp_stub_apply, jcfg, depth, bootstrap))(
        None, None, None, states, key)
    planes = JaxKeyPlanes(0)
    planes._k_ev = key  # the evaluator's key, as a simulation would hand it
    ev = M.policy_rollout_evaluator(torch_vp_stub, tcfg, depth, bootstrap,
                                    torch_gumbels_of(planes))
    env = torch.as_tensor(as_i32(JE.pack_state(states)))
    v, var = ev(None, env)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(var.numpy(), np.asarray(var_j))
    assert not bool((env[:, 43] != 0).any())
    if evaluator == "full":  # every playout ended before the cap
        assert ev.steps < depth and ev.steps % M.ROLLOUT_EXIT_EVERY == 0
    else:
        assert ev.steps == depth
    if bootstrap:  # the value bootstrap was added on live end states
        no_boot = M.policy_rollout_evaluator(torch_vp_stub, tcfg, depth, False,
                                             torch_gumbels_of(planes))
        assert not torch.equal(no_boot(None, env)[0], v)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_hybrid_slice_matches_jax(monkeypatch_module):
    monkeypatch_module.setattr(JW, "use_walk_kernels", lambda: True)
    jscfg = JM.SearchConfig(tree=JCFG, sims=SLICE_SIMS, evaluator="hybrid")
    move_j = jax_move_program(JM.policy_rollout_evaluator(vp_stub_apply, jscfg, 30, True),
                              JCFG, SLICE_SIMS, "hybrid")
    planes = JaxKeyPlanes(2)
    tscfg = M.SearchConfig(tree=TCFG, sims=SLICE_SIMS, evaluator="hybrid")
    ev = M.policy_rollout_evaluator(torch_vp_stub, tscfg, M.playout_depth(tscfg), True,
                                    torch_gumbels_of(planes))
    move_t = M.make_move_fn(ev, tscfg, planes)
    # the walks' traces on grown trees are held by test_torch_rollout.py's
    # slice, which runs the same select kernel; here the moves' results are
    ttrees, _ = run_slice(move_j, None, None, move_t, planes, JCFG, TCFG, B, SLICE_MOVES,
                          STAT_TOL, final_select=False)
    assert ev.steps == 30  # the playouts ran to their depth
    assert float(ttrees.vars_.max()) > 100.0  # playout variances were backed up
