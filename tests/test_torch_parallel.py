"""The port's mesh, sharded moves and sharded learner (`parallel/mesh.py`)
against the JAX package's `parallel/mesh.py` on its 8 virtual CPU devices
(tests/conftest.py). The port's ranks are gloo processes on the CPU
(`runtime/distributed.spawn`, the rank functions of tests/torch_ranks.py);
one 2-rank group runs every move case and the 2-rank learner cases, one
4-rank group the 2 x 2 learner.

- `make_mesh`'s grid of ranks is the JAX mesh's grid of device ids, and
  `vv_param_specs` the JAX spec tree, with torch's (out, in) Linear weight
  the transpose of flax's (in, out) kernel.
- The lp, VP and ValueSim2 moves on 2 ranks of 4 lanes each against the
  JAX move program sharded over 8 devices at B=8 (`sharded_move_fn`, and
  the jit over `shard_batch` placements as tests/test_parallel.py runs the
  VP and S2 moves), fed the JAX key schedule as recorded planes, with
  board-wise stand-ins for the nets (a rank's outputs for a board must not
  depend on its batch): every integer array equal (actions, env states,
  trees, rings), statistics within STAT_TOL (tests/torch_parity.py: rtol
  1e-6 / atol 1e-5), the VP priors within rtol 1e-6 / atol 1e-7; the ring
  the same on both ranks, bit for bit.
- Two learner steps on data 2, model 2 (2 ranks) and a 2 x 2 grid (4
  ranks) against the JAX learner (`make_sharded_learner`, whose steps
  chain) on the 8-device mesh (model axis 2 where the port's has one); the
  port's `sharded_train_step` against its own first step. The VV net is
  carried by
  `params_from_jax`: params within PARAM_TOL (rtol 1e-4 / atol 1e-5, the
  train tests' bound), the loss within rtol 1e-5; the whole params
  bit-equal on every rank, each shard bit-equal across the data ranks that
  hold it. The minibatches pass tests/torch_train_cases.py's screen (no
  ReLU input within 1e-6 of zero), so no unit's gradient parts as a whole.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.parallel import mesh as JP
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import stochastic as JS
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.search import vp as JV
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.models.nets import VVNet
from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.runtime import distributed as D
from tetris_mcts_tpu_torch.search import mcts as PM
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.train.trainer import (_state_from_flax, opt_state_from_jax,
                                                 params_from_jax)
from torch_parity import (STAT_TOL, JaxVPKeyPlanes, JaxXlaWalkKeyPlanes, as_i32,
                          assert_tree_equal, assert_vp_tree_equal, vp_stubs)
from torch_ranks import learner_steps, sharded_moves
from torch_train_cases import min_nonzero_preactivation

torch.set_num_threads(1)

B, SIMS, MOVES, RING = 8, 3, 3, 256
POOLS = dict(max_nodes=64, max_obs=64, table_size=128, max_depth=8)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
EWC_LAM = 1.0
N_ROWS, BATCH = 64, 32


def cellsum_apply(params, ubound, imgs):
    """torch_ranks.cellsum_net in JAX (NHWC images)."""
    n = imgs.shape[0]
    return jnp.sum(imgs.reshape(n, -1), 1) * 0.01 + 1.0, jnp.full((n,), 2.5)


def s2_cellsum_apply(params, ubound, imgs):
    return cellsum_apply(params, ubound, imgs)


# ---------------------------------------------------------------------------
# the grid and the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,mp", [(8, 1), (8, 2), (4, 2)])
def test_mesh_grid_matches_jax(n, mp):
    jm = JP.make_mesh(n, model_parallel=mp)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    grid = M.mesh_grid(n, mp)
    np.testing.assert_array_equal(grid, ids - ids.min())
    for r in range(n):
        m = M.Mesh(n, r, mp)  # no process group: the coordinates only
        assert (m.data_size, m.model_size) == (n // mp, mp)
        assert grid.reshape(n // mp, mp)[m.data_index, m.model_index] == r
        assert m.axis_names == jm.axis_names


@pytest.mark.parametrize("mp", [1, 2])
def test_vv_param_specs_match_jax(mp):
    jm = JVVModel(seed=0)
    jspecs = JP.vv_param_specs(JP.make_mesh(8, model_parallel=mp), jm.params)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(jspecs):
        names = [p.key for p in path]
        spec = tuple(sh.spec)
        if names[-1] == "kernel" and spec:
            spec = spec[::-1]  # flax (in, out) -> torch (out, in)
        want[f"{names[-2]}.{'weight' if names[-1] == 'kernel' else 'bias'}"] = spec
    got = M.vv_param_specs(M.Mesh(8, 0, mp), dict(VVNet().named_parameters()))
    assert got == want
    assert sum(bool(s) for s in got.values()) == (2 if mp > 1 else 0)


# ---------------------------------------------------------------------------
# sharded moves and learner steps: one 2-rank group, one 4-rank group
# ---------------------------------------------------------------------------

def _jax_moves(kind):
    """The JAX move program sharded over the 8 devices at B=8, MOVES moves
    from init seed 7; returns (its states after each move, the port's
    recorded global draws, the port's SearchConfig)."""
    jcfg = JM.SearchConfig(tree=JT.TreeConfig(**POOLS), sims=SIMS, evaluator="lp")
    tcfg = PM.SearchConfig(tree=T.TreeConfig(**POOLS), sims=SIMS, evaluator="lp")
    mesh = JP.make_mesh(8)
    draws, states = [], []
    if kind == "lp":
        move = JM.make_move_fn(JM.nn_child_evaluator(cellsum_apply), jcfg, min_visits_store=1)
        smove = JP.sharded_move_fn(move, mesh)
        trees, envs = JM.init_batch(7, B, jcfg)
        ring = JM.init_replay(RING)
        planes = JaxXlaWalkKeyPlanes(11)
        for _ in range(MOVES):
            sub = planes.next_move()
            draws += [planes(B, POOLS["max_depth"]) for _ in range(SIMS)]
            trees, envs, ring, st = smove({}, jnp.zeros(2), trees, envs, ring, sub)
            states.append((trees, envs, ring, st.action))
    elif kind == "vp":
        japply, _ = vp_stubs()
        move = jax.jit(JV.make_vp_move_fn(japply, jcfg, min_visits_store=1))
        trees, envs = JV.init_vp_batch(7, B, jcfg)
        ring = JV.init_vp_replay(RING)
        trees, envs = JP.shard_batch(mesh, trees), JP.shard_batch(mesh, envs)
        ring = JP.replicate(mesh, ring)
        planes = JaxVPKeyPlanes(11)
        for _ in range(MOVES):
            sub = planes.next_move()
            draws += [planes.uniforms(B, POOLS["max_depth"]) for _ in range(SIMS)]
            trees, envs, ring, st = move(None, trees, envs, ring, sub)
            states.append((trees, envs, ring, st.action))
    else:
        move = jax.jit(JS.make_s2_move_fn(s2_cellsum_apply, jcfg, min_visits_store=1))
        trees, envs = JS.init_s2_batch(7, B, jcfg)
        ring = JP.replicate(mesh, JM.init_replay(RING))
        trees, envs = JP.shard_batch(mesh, trees), JP.shard_batch(mesh, envs)
        key = jax.random.PRNGKey(11)
        for _ in range(MOVES):
            key, sub = jax.random.split(key)
            trees, envs, ring, st = move(None, None, trees, envs, ring, sub)
            states.append((trees, envs, ring, st.action))
    return states, draws, tcfg


def _learner_case():
    """The JAX VV net (seed 1), its Yogi state, the columns and two
    screened minibatches (JAX keys)."""
    jm = JVVModel(seed=1)
    rng = np.random.RandomState(2)
    boards = rng.randint(-1, 2, (N_ROWS, 20, 10)).astype(np.float32)
    cols = [rng.uniform(0, 50, N_ROWS), rng.uniform(0.1, 30, N_ROWS), rng.uniform(1, 5, N_ROWS)]
    jdata = (jnp.asarray(boards[..., None]),) + tuple(jnp.asarray(c, jnp.float32) for c in cols)
    tdata = (torch.as_tensor(boards[:, None]),) + tuple(torch.as_tensor(np.float32(c))
                                                          for c in cols)
    p_np = jax.tree.map(np.asarray, jm.params)
    state = (*params_from_jax(p_np, jm.ubound, jm.lbound),
             opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    # two keys whose minibatches hold no ReLU input within 1e-6 of zero
    # under the initial params
    from torch_ranks import vv_model

    net = vv_model(state).net
    keys, k = [], 0
    while len(keys) < 2:
        key = jax.random.PRNGKey(100 + k)
        idx = torch.as_tensor(np.array(jax.random.randint(key, (BATCH,), 0, N_ROWS)))
        if min_nonzero_preactivation(net, tdata[0][idx]) > 1e-6:
            keys.append((key, idx))
        k += 1
    return jm, jdata, tdata, state, keys


def _ewc_case(jm):
    """An EWC penalty for the learner: a Fisher drawn uniform on [0, 2), an
    anchor p0 off the params by N(0, 0.05), lam 1; as the JAX model's trees
    and the port's state dicts."""
    rng = np.random.RandomState(3)
    p_np = jax.tree.map(np.asarray, jm.params)
    fisher = jax.tree.map(lambda x: rng.uniform(0, 2, x.shape).astype(np.float32), p_np)
    p0 = jax.tree.map(lambda x: (x + rng.normal(0, 0.05, x.shape)).astype(np.float32), p_np)
    return (fisher, p0, EWC_LAM), (_state_from_flax(fisher), _state_from_flax(p0), EWC_LAM)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    moves = {kind: _jax_moves(kind) for kind in ("lp", "vp", "s2")}
    cases = {kind: dict(kind=kind, scfg=tcfg, B=B, seed=7, moves=MOVES, ring=RING, draws=draws)
             for kind, (_, draws, tcfg) in moves.items()}
    jm, jdata, tdata, state, keys = _learner_case()
    jewc, tewc = _ewc_case(jm)
    idxs = [idx for _, idx in keys]
    work = str(tmp_path_factory.mktemp("ranks"))
    two = D.spawn(sharded_moves, 2, (cases,), device="cpu", timeout=300, workdir=work)
    learn = {mp: D.spawn(learner_steps, 2, (mp, state, tdata, idxs, tewc), device="cpu",
                         timeout=300, workdir=work) for mp in (1, 2)}
    learn["2x2"] = D.spawn(learner_steps, 4, (2, state, tdata, idxs, tewc), device="cpu",
                           timeout=300, workdir=work)
    return dict(moves=moves, two=two, learn=learn, jm=jm, jdata=jdata, keys=keys, jewc=jewc)


def _rows(tree, r, n=B // 2):
    return jax.tree.map(lambda x: x[r * n:(r + 1) * n], tree)


def _assert_ring_equal(got, want, policy=False):
    cols = ("boards", "value", "policy" if policy else "var", "weight")
    for name, a, b in zip(cols, got.rows(), [getattr(want, c) for c in cols]):
        b = as_i32(b) if name == "boards" else np.asarray(b)
        if name in ("boards", "weight"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, err_msg=name, **STAT_TOL)
    for name in ("idx", "count", "total"):
        assert getattr(got, name).item() == int(getattr(want, name)), name


def _assert_rings_bit_equal(a, b):
    for x, y in zip(a.rows() + (a.idx, a.count, a.total, a.cand),
                    b.rows() + (b.idx, b.count, b.total, b.cand)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["lp", "vp", "s2"])
def test_sharded_moves_match_jax(runs, kind):
    states, _, _ = runs["moves"][kind]
    jtrees, jenvs, jring, _ = states[-1]
    total = 0
    for r, out in enumerate(runs["two"]):
        got = out[kind]
        for mv, (a, (*_, jact)) in enumerate(zip(got["actions"], states)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(jact)[r * 4:(r + 1) * 4],
                                          err_msg=f"{kind} rank {r} move {mv}")
        np.testing.assert_array_equal(got["envs"].numpy(),
                                      as_i32(JE.pack_state(_rows(jenvs, r))))
        if kind == "lp":
            assert_tree_equal(got["trees"], _rows(jtrees, r), msg=f"rank {r}")
        elif kind == "vp":
            assert_vp_tree_equal(got["trees"], _rows(jtrees, r), msg=f"rank {r}")
        else:
            from test_torch_s2 import assert_s2_equal

            assert_s2_equal(got["trees"], _rows(jtrees, r), msg=f"rank {r}")
        _assert_ring_equal(got["ring"], jring, policy=kind == "vp")
        total = got["ring"].total.item()
    _assert_rings_bit_equal(runs["two"][0][kind]["ring"], runs["two"][1][kind]["ring"])
    assert total > 0  # rows harvested from both ranks' lanes


@pytest.mark.parametrize("case", [1, 2, "2x2"], ids=["data2", "model2", "data2_model2"])
def test_sharded_learner_matches_jax(runs, case):
    jm, jdata, keys = runs["jm"], runs["jdata"], runs["keys"]
    mp = 1 if case == 1 else 2
    # the JAX learner (its output shardings pinned, so its steps chain)
    jstate, jstep = JP.make_sharded_learner(jm, JP.make_mesh(8, model_parallel=mp))
    outs = runs["learn"][case]
    for s, (key, _) in enumerate(keys):
        jstate, jmet, _ = jstep(jstate, jm.ubound, jdata, key, jnp.float32(0.0), BATCH)
        want = _state_from_flax(jax.tree.map(np.asarray, jstate.params))
        for o in outs:
            for k, v in o["params"][s].items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=f"{k} step {s}",
                                           **PARAM_TOL)
            np.testing.assert_allclose(o["metrics"][s]["loss"], float(jmet["loss"]), rtol=1e-5)
            np.testing.assert_allclose(o["metrics"][s]["grad_norm"], float(jmet["grad_norm"]),
                                       rtol=1e-5)
    for o in outs[1:]:  # bit-equal across ranks
        for s in range(len(keys)):
            for k, v in o["params"][s].items():
                assert torch.equal(v, outs[0]["params"][s][k]), k
        twin = [p for p in outs if p["coords"][1] == o["coords"][1]][0]
        for k, v in o["shards"].items():
            assert torch.equal(v, twin["shards"][k]), k
    if mp == 2:  # fc1 and fc_out really are split
        assert outs[0]["shards"]["fc1.weight"].shape == (128, 1792)
        assert outs[0]["shards"]["fc_out.weight"].shape == (2, 128)
    # the whole-state step: the first step again, from the gathered outputs
    for k, v in outs[0]["whole"].items():
        torch.testing.assert_close(v, outs[0]["params"][0][k], rtol=0, atol=0)


@pytest.mark.parametrize("case", [1, 2, "2x2"], ids=["data2", "model2", "data2_model2"])
def test_sharded_learner_with_ewc_matches_jax(runs, case):
    """The same two steps under an EWC penalty (a Fisher and an anchor off
    the params, lam 1) against the JAX learner's, within the same bounds;
    the params bit-equal across ranks."""
    mp = 1 if case == 1 else 2
    fisher, p0, lam = runs["jewc"]
    jm = copy.copy(runs["jm"])
    jm.fisher, jm.p0 = fisher, p0
    jstate, jstep = JP.make_sharded_learner(jm, JP.make_mesh(8, model_parallel=mp))
    outs = [o["ewc"] for o in runs["learn"][case]]
    plain = runs["learn"][case][0]["params"]
    for s, (key, _) in enumerate(runs["keys"]):
        jstate, jmet, _ = jstep(jstate, jm.ubound, runs["jdata"], key, jnp.float32(lam), BATCH)
        want = _state_from_flax(jax.tree.map(np.asarray, jstate.params))
        for o in outs:
            for k, v in o["params"][s].items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=f"{k} step {s}",
                                           **PARAM_TOL)
                assert torch.equal(v, outs[0]["params"][s][k]), k
            np.testing.assert_allclose(o["metrics"][s]["loss"], float(jmet["loss"]), rtol=1e-5)
            np.testing.assert_allclose(o["metrics"][s]["grad_norm"], float(jmet["grad_norm"]),
                                       rtol=1e-5)
    # the penalty moved the steps
    assert any(not torch.equal(outs[0]["params"][1][k], plain[1][k]) for k in plain[1])
