"""The port's backup walk and its leaf-evaluator move program against the
JAX package.

- The backup kernel's plain version (`tree.backup_batched`, what
  `tree_walk.backup` runs on the CPU) against the JAX Pallas `backup_walk`
  run interpreted, on grown trees: with the traces of a select walk, and
  with traces that visit every obs twice (one trace updating the same obs
  twice, tests/test_search.py
  TestVectorizedBackup::test_duplicate_obs_in_trace). Visits are equal.
  Values and vars are not bit-equal: XLA on the CPU contracts two
  multiply-adds of the walk (`gamma * v_rel + s` and
  `delta * delta2 - var`) into fused multiply-adds, where the port (and its
  CUDA kernel, built with --fmad=false) rounds each operation. A NumPy
  transcription of the walk pins this down: with those two fused
  multiply-adds it equals the JAX output bit for bit, without them it
  equals the port's bit for bit, and the two stay within rtol 1e-6 /
  atol 1e-5.
- A 3-move slice with the leaf evaluator (ValueSim) against the JAX move
  program on its kernel path (`tree_walk.use_walk_kernels` patched to True,
  so the Pallas kernels run interpreted), fed the same planes: with the
  linspace stub, actions, env states, resets, node counts, traces and the
  trees' integer arrays equal and statistics within rtol 1e-6 / atol 1e-5;
  with the flax VV net (same weights via `params_from_jax`) statistics
  within rtol 1e-4 / atol 1e-3, the tolerances of test_slice_matches_jax.

One JAX move program serves both slice runs: its evaluator switches between
the stub and the net on a traced flag, so the interpreted kernels compile
once in this module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from torch_parity import (B, JCFG, STAT_TOL, TCFG, JaxKeyPlanes, jax_move_program,
                          port_vvmodel, run_slice, stub_apply, torch_stub,
                          tree_from_jax)

torch.set_num_threads(1)

SLICE_SIMS, SLICE_MOVES = 6, 3


@pytest.fixture(scope="module")
def grown():
    scfg = JM.SearchConfig(tree=JCFG, sims=9, evaluator="lp")
    run = JM.make_run_sims(JM.nn_child_evaluator(stub_apply), scfg)
    trees, _ = JM.init_batch(17, B, scfg)
    return jax.jit(run)(None, None, trees, jax.random.PRNGKey(4))


def np_backup(tree, traces, lengths, v0, var0, gamma, fused):
    """NumPy transcription of the reverse Welford+gamma walk, in float32;
    `fused` evaluates `gamma * v_rel + s` and `delta * delta2 - var` as
    fused multiply-adds (one rounding: the float64 product of two float32s
    is exact). Returns (visits, values, vars)."""
    f32 = np.float32
    fma = lambda a, b, c: f32(np.float64(a) * np.float64(b) + np.float64(c))
    score = np.asarray(tree.nstat[:, 0, :])
    obs = np.asarray(tree.nstat[:, 1, :]).astype(np.int64)
    vis, val, var = (np.array(x, np.float32) for x in (tree.visits, tree.values,
                                                        tree.vars_))
    g = f32(gamma)
    for b in range(traces.shape[0]):
        v = f32(v0[b])
        for t in range(lengths[b] - 1, -1, -1):
            i = traces[b, t]
            s, o = score[b, i], obs[b, i]
            n, va, vr = vis[b, o], val[b, o], var[b, o]
            v_rel = f32(v - s)
            delta = f32(v_rel - va)
            val_new = v_rel if n == 0 else f32(va + f32(delta / f32(n + f32(1))))
            delta2 = f32(v_rel - val_new)
            inner = fma(delta, delta2, -vr) if fused else f32(f32(delta * delta2) - vr)
            var_new = var0[b] if n == 0 else f32(vr + f32(inner / f32(n + f32(1))))
            vis[b, o], val[b, o], var[b, o] = n + 1, val_new, var_new
            v = fma(g, v_rel, s) if fused else f32(f32(g * v_rel) + s)
    return vis, val, var


@pytest.mark.parametrize("traces_kind", ["walk", "duplicate_obs"])
def test_backup_plain_matches_pallas(grown, traces_kind):
    traces, _, lengths, _ = jax.vmap(JT.select, in_axes=(0, 0, None))(
        grown, jax.random.split(jax.random.PRNGKey(8), B), JCFG)
    traces, lengths = np.array(traces), np.array(lengths)
    if traces_kind == "duplicate_obs":
        # each trace walked twice over: every obs of it is updated twice
        twice = np.zeros_like(traces)
        for b in range(B):
            n = lengths[b]
            twice[b, :2 * n] = np.concatenate([traces[b, :n], traces[b, :n]])
        traces, lengths = twice, 2 * lengths
    assert int(lengths.max()) > 2
    v0 = np.linspace(3.0, 70.0, B, dtype=np.float32)
    var0 = np.linspace(0.25, 2.0, B, dtype=np.float32)
    want = JW.backup_walk(
        jnp.asarray(traces), jnp.asarray(lengths), jnp.asarray(v0), jnp.asarray(var0),
        grown.nstat[:, 0, :], grown.nstat[:, 1, :].astype(jnp.int32),
        grown.visits, grown.values, grown.vars_, gamma=JCFG.gamma, interpret=True)
    want = [np.asarray(x) for x in want]
    tt = tree_from_jax(grown)
    W.backup(tt, torch.as_tensor(traces), torch.as_tensor(lengths),
             torch.as_tensor(v0), torch.as_tensor(var0), TCFG)
    got = [tt.visits.numpy(), tt.values.numpy(), tt.vars_.numpy()]
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **STAT_TOL)
    for fused, out in ((False, got), (True, want)):
        for x, y in zip(np_backup(grown, traces, lengths, v0, var0, JCFG.gamma, fused),
                        out):
            np.testing.assert_array_equal(x, y, err_msg=f"fused={fused}")
    assert (got[0] != np.asarray(grown.visits)).any()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def jax_leaf_move(monkeypatch_module):
    """The JAX leaf-evaluator move program on its kernel path; its net is
    the linspace stub when params["stub"] is true and the flax VV net
    otherwise."""
    monkeypatch_module.setattr(JW, "use_walk_kernels", lambda: True)
    model = JVVModel(seed=3)
    net_apply = model.apply_fn()

    def apply(p, u, x):
        sv, svar = stub_apply(p, u, x)
        nv, nvar = net_apply(p["net"], u, x)
        return jnp.where(p["stub"], sv, nv), jnp.where(p["stub"], svar, nvar)

    move = jax_move_program(JM.nn_leaf_evaluator(apply), JCFG, SLICE_SIMS, "leaf")
    return move, model


@pytest.mark.parametrize("net", ["stub", "vvnet"])
def test_leaf_slice_matches_jax(jax_leaf_move, net):
    move_j, model_j = jax_leaf_move
    stub = net == "stub"
    params = {"net": model_j.params, "stub": jnp.asarray(stub)}
    if stub:
        ev, tol = M.nn_leaf_evaluator(torch_stub), STAT_TOL
    else:
        ev = M.nn_leaf_evaluator(port_vvmodel(model_j).apply_fn())
        tol = dict(rtol=1e-4, atol=1e-3)
    planes = JaxKeyPlanes(1)
    W.reset_launches()
    move_t = M.make_move_fn(
        ev, M.SearchConfig(tree=TCFG, sims=SLICE_SIMS, evaluator="leaf"), planes)
    ttrees, _ = run_slice(move_j, params, model_j.ubound, move_t, planes, JCFG, TCFG,
                          B, SLICE_MOVES, tol)
    assert int(ttrees.n_nodes.max()) > 1 + 7 * SLICE_SIMS  # the trees grew
    assert sum(W.LAUNCHES.values()) == 0  # CPU trees: the plain versions ran
