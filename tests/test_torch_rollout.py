"""The port's rollout evaluator (Vanilla) and its move program against the
JAX package.

- The evaluator alone, at the real cap of 512 steps, on leaf states of live
  games: the same uniform action draws (the JAX `k_ev` schedule replayed)
  give the same final scores. The port tests "every playout has ended" once
  every `ROLLOUT_EXIT_EVERY` steps instead of every step; ended lanes are
  no-ops, so it stops later than the JAX loop and returns the same values.
- A 3-move slice with the rollout evaluator (rollout_cap 16, low 5 as the
  Vanilla agent sets it) against the JAX move program on its kernel path
  (`tree_walk.use_walk_kernels` patched to True, so the Pallas kernels run
  interpreted), fed the same planes and action draws: actions, env states,
  resets, node counts, traces and the trees' integer arrays equal,
  statistics within rtol 1e-6 / atol 1e-5.
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
from torch_parity import (B, JCFG, STAT_TOL, TCFG, JaxKeyPlanes, as_i32,
                          jax_move_program, run_slice)

torch.set_num_threads(1)

SLICE_SIMS, SLICE_MOVES, SLICE_CAP = 6, 3, 16
VANILLA_LOW = 5


def test_rollout_evaluator_matches_jax():
    key = jax.random.PRNGKey(2)
    jcfg = JM.SearchConfig(tree=JCFG)
    states = JE.reset_batch(9, B, JCFG.env)
    rng = np.random.RandomState(0)
    for _ in range(12):  # a few random moves into each game
        states = JE.step_batch(states, jnp.asarray(rng.randint(0, 7, B), jnp.int32),
                               JCFG.env)
    v_j, var_j = jax.jit(JM.rollout_evaluator(jcfg))(None, None, None, states, key)

    draws = JaxKeyPlanes(0)
    draws._k_ev = key  # the evaluator's key, as a simulation would hand it
    ev = M.rollout_evaluator(M.SearchConfig(tree=TCFG, evaluator="rollout"),
                             draws.actions)
    env = torch.as_tensor(as_i32(JE.pack_state(states)))
    v, var = ev(None, env)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(var.numpy(), np.asarray(var_j))
    # the games were live, every playout ended before the cap, and the exit
    # test ran on a multiple of ROLLOUT_EXIT_EVERY steps
    assert not bool((env[:, 43] != 0).any())
    assert 0 < ev.steps < 512 and ev.steps % M.ROLLOUT_EXIT_EVERY == 0


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_rollout_slice_matches_jax(monkeypatch_module):
    monkeypatch_module.setattr(JW, "use_walk_kernels", lambda: True)
    jcfg, tcfg = JCFG._replace(low=VANILLA_LOW), TCFG._replace(low=VANILLA_LOW)
    jscfg = JM.SearchConfig(tree=jcfg, sims=SLICE_SIMS, evaluator="rollout",
                            rollout_cap=SLICE_CAP)
    move_j = jax_move_program(JM.rollout_evaluator(jscfg), jcfg, SLICE_SIMS, "rollout",
                              rollout_cap=SLICE_CAP)
    planes = JaxKeyPlanes(2)
    tscfg = M.SearchConfig(tree=tcfg, sims=SLICE_SIMS, evaluator="rollout",
                           rollout_cap=SLICE_CAP)
    ev = M.rollout_evaluator(tscfg, planes.actions)
    move_t = M.make_move_fn(ev, tscfg, planes)
    ttrees, _ = run_slice(move_j, None, None, move_t, planes, jcfg, tcfg, B,
                          SLICE_MOVES, STAT_TOL)
    assert ev.steps == SLICE_CAP  # the playouts ran to the cap
    assert float(ttrees.vars_.max()) > 100.0  # rollout variances were backed up
