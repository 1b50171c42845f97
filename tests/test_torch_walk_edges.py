"""The plain versions of the insert and backup walks against the JAX
package on edge inputs (tests/torch_walk_cases.py), on the CPU.

The kernels run a warp per tree: both backups walk a trace in chunks of
32 levels, a level a lane, and the insert settles a probe round's claims in
registers. Their plain versions (what `tree_walk.lp_backup`,
`tree_walk.backup` and `tree_walk.insert_obs7` run on the CPU, and what
the kernels are held against on the card in tests/test_torch_cuda.py and
chip_smoke.py) are held here against the JAX wrappers run interpreted, as
the JAX package's own tests run them, on the inputs that stress those
designs:

- `lp_backup_plain` against `lp_backup_batched_pallas` at D=40, above one
  chunk: traces of 1 to 40 levels holding one obs twice within 32 levels
  and 32 or more levels apart, leaf children whose obs lie on the trace,
  leaves without children, lanes not expanded, ended children. Visits are
  equal; values and vars within rtol 1e-6 / atol 1e-5 (XLA on the CPU
  contracts two multiply-adds of the interpreted walk into fused ones,
  tests/test_torch_leaf.py).
- `backup_batched` against `backup_walk` on the same trees and traces from
  (v0, var0) given per lane, one lane with an empty trace; same tolerance.
- `insert_obs7_batched` against `insert_obs7_batched_pallas` over a
  sequence of inserts into a 16-slot table with a 12-id pool: distinct
  keys contend for one slot, lanes hold duplicate keys, probes wrap from
  the last slot to slot 0, and the id pool runs out during a call. Obs
  ids, tables, n_obs, obs_end and obs_bits are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import tree as T
import torch_walk_cases as C
from torch_parity import STAT_TOL, assert_tree_equal, tree_from_jax

torch.set_num_threads(1)

LP_B, LP_D = 12, 40  # one lane of each length in C.LP_LENGTHS, capped at D


@pytest.mark.parametrize("seed", [0, 1])
def test_lp_backup_plain_matches_pallas_long_traces(seed):
    case = C.lp_case(seed, LP_B, LP_D)
    assert C.repeats(case) == (True, True, True)
    jcfg = JT.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M, table_size=128,
                         max_depth=LP_D)
    jt = jax.vmap(JT.init_tree, in_axes=(0, None))(JE.reset_batch(seed, LP_B, jcfg.env),
                                                   jcfg)
    jt = jt._replace(**{k: jnp.asarray(case[k]) for k in
                        ("cbase", "nstat", "end", "visits", "values", "vars_")})
    want = JW.lp_backup_batched_pallas(
        jt, *[jnp.asarray(case[k]) for k in
              ("traces", "lengths", "v_nn", "var_nn", "expanded")], jcfg)
    tt = tree_from_jax(jt)
    W.lp_backup(tt, *C.lp_args(case), T.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M,
                                                   table_size=128, max_depth=LP_D))
    assert_tree_equal(tt, want)
    assert not np.array_equal(tt.visits.numpy(), case["visits"])


@pytest.mark.parametrize("seed", [0, 1])
def test_backup_plain_matches_pallas_long_traces(seed):
    case = C.backup_case(seed, LP_B, LP_D)
    assert C.repeats(case)[:2] == (True, True)
    assert case["lengths"].min() == 0
    cfg = T.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M, table_size=128, max_depth=LP_D)
    want = JW.backup_walk(
        *[jnp.asarray(case[k]) for k in ("traces", "lengths", "v0", "var0")],
        jnp.asarray(case["nstat"][:, 0]), jnp.asarray(case["nstat"][:, 1].astype(np.int32)),
        *[jnp.asarray(case[k]) for k in ("visits", "values", "vars_")],
        gamma=cfg.gamma, interpret=True)
    tt = C.lp_tree(case)
    W.backup(tt, *C.backup_args(case), cfg)
    np.testing.assert_array_equal(tt.visits.numpy(), np.asarray(want[0]))
    for got, w in ((tt.values, want[1]), (tt.vars_, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **STAT_TOL)
    assert not np.array_equal(tt.visits.numpy(), case["visits"])


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_plain_matches_pallas_small_table(seed):
    B = 8
    cfg_j = JT.TreeConfig(max_nodes=C.INSERT_CFG.max_nodes, max_obs=C.INSERT_CFG.max_obs,
                          table_size=C.INSERT_CFG.table_size,
                          max_depth=C.INSERT_CFG.max_depth)
    jt = jax.vmap(JT.init_tree, in_axes=(0, None))(JE.reset_batch(seed, B, cfg_j.env), cfg_j)
    tt = tree_from_jax(jt)
    packed7, end7, ok = C.insert_case(seed, B)
    ran_out = False
    for r in range(C.INSERT_ROUNDS):
        n_before = tt.n_obs.clone()
        jt, want = JW.insert_obs7_batched_pallas(
            jt, jnp.asarray(packed7[r].view(np.uint32)), jnp.asarray(end7[r]),
            jnp.asarray(ok[r]), cfg_j)
        got = W.insert_obs7(tt, torch.as_tensor(packed7[r]), torch.as_tensor(end7[r]),
                            torch.as_tensor(ok[r]), C.INSERT_CFG)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"call {r}")
        assert_tree_equal(tt, jt, msg=f"call {r}")
        ran_out |= C.ran_out(n_before, tt.n_obs, got, torch.as_tensor(ok[r]))
    assert ran_out and C.wrapped(tt)
