"""The port's walk kernels (their plain versions, which are what runs on
the CPU) and its move program against the JAX package.

- Each kernel's plain version against the JAX wrapper run interpreted on
  the CPU (`select_batched_pallas` with the same pre-drawn planes,
  `insert_obs7_batched_pallas`, `lp_backup_batched_pallas`), on trees grown
  as tests/test_search.py TestShardedKernels._grown grows them.
- The whole slice: a multi-move run of the JAX move program, forced onto its
  kernel path (`tree_walk.use_walk_kernels` patched to True inside the test,
  so the Pallas kernels run interpreted), against the port's move program
  fed the same planes. With the linspace stub evaluator, actions, traces,
  obs ids, visits, tables and env states must match bit for bit; with the
  VV net (same weights via `params_from_jax`) actions and the integer state
  must match and float statistics stay within rtol 1e-4 / atol 1e-3.

Values and vars of the stub runs are held to rtol 1e-6 / atol 1e-5, the
tolerance of tests/test_search.py TestPallasLPBackup.

One JAX move program serves both slice runs: its evaluator switches between
the stub and the net on a traced flag, so the interpreted kernels compile
once in this module.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.env import engine as E
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from torch_parity import (B, JCFG, STAT_TOL, TCFG, JaxKeyPlanes, as_i32,
                          assert_tree_equal, jax_move_program, jax_planes,
                          port_vvmodel, run_slice, stub_apply, torch_stub, tree_from_jax)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grown():
    scfg = JM.SearchConfig(tree=JCFG, sims=9, evaluator="lp")
    run = JM.make_run_sims(JM.nn_child_evaluator(stub_apply), scfg)
    trees, _ = JM.init_batch(31, B, scfg)
    return jax.jit(run)(None, None, trees, jax.random.PRNGKey(6))


# ---------------------------------------------------------------------------
# kernels: plain versions vs the interpreted Pallas wrappers
# ---------------------------------------------------------------------------

def test_wrappers_take_cpu_or_cuda_only():
    """On a CPU tree the wrappers run the plain versions and count nothing;
    any device other than cpu or cuda is refused."""
    W.reset_launches()
    tt = T.init_tree(E.pack_state(E.reset_batch(1, 2, device="cpu")), TCFG)
    W.select_walk(tt, torch.zeros(2, 32, 7), torch.zeros(2, 32, 7), TCFG)
    assert sum(W.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        W._on_cuda(torch.empty(1, device="meta"))


def test_policy_order_matches_kernel():
    """The select kernel reads the policy as its index in W.POLICIES: the
    `Policy` enum of csrc/tree_walk.cu must list the same rules in the same
    order."""
    src = (pathlib.Path(W.__file__).parent.parent / "csrc" / "tree_walk.cu").read_text()
    body = re.search(r"enum Policy \{([^}]*)\}", src).group(1)
    names = [n.split("=")[0].strip() for n in body.split(",")]
    assert names == ["k" + p.capitalize() for p in W.POLICIES]


@pytest.mark.parametrize("policy", W.POLICIES)
def test_select_plain_matches_pallas(grown, policy):
    """Every selection rule, with low=1 so the rule's bound decides each
    level once all kept children are visited (they are after the growth)."""
    key = jax.random.PRNGKey(13)
    jcfg, tcfg = JCFG._replace(policy=policy), TCFG._replace(policy=policy)
    want = JW.select_batched_pallas(grown, key, jcfg)
    gum, rnd = jax_planes(key, B, JCFG.max_depth, policy)
    got = W.select_walk(tree_from_jax(grown), gum, rnd, tcfg)
    traces, lengths, leafs, leaf_env, packed7, sc7, end7 = got
    np.testing.assert_array_equal(traces.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(leafs.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(leaf_env.numpy(), as_i32(JE.pack_state(want[3])))
    np.testing.assert_array_equal(packed7.numpy(), as_i32(want[4]))
    np.testing.assert_array_equal(sc7.numpy(), np.asarray(want[5], np.int32))
    np.testing.assert_array_equal(end7.numpy() != 0, np.asarray(want[6]))
    assert int(lengths.max()) > 2  # the walk went deep enough to matter


def test_insert_plain_matches_pallas(grown):
    """Repeated inserts with a small key space (duplicates within a move,
    repeat hits across moves) until the obs pool overflows, as
    tests/test_search.py TestPallasInsert drives the kernel."""
    cfg_j = JCFG._replace(max_obs=64, table_size=128)
    cfg_t = TCFG._replace(max_obs=64, table_size=128)
    js = JE.reset_batch(11, 4, cfg_j.env)
    jt = jax.vmap(JT.init_tree, in_axes=(0, None))(js, cfg_j)
    tt = tree_from_jax(jt)
    rng = np.random.RandomState(5)
    for it in range(12):
        packed7 = rng.randint(0, 5, (4, 7, 20)).astype(np.uint32)
        end7 = rng.rand(4, 7) < 0.2
        ok = rng.rand(4) < 0.9
        jt, want = JW.insert_obs7_batched_pallas(
            jt, jnp.asarray(packed7), jnp.asarray(end7), jnp.asarray(ok), cfg_j)
        got = W.insert_obs7(tt, torch.as_tensor(packed7.view(np.int32)),
                            torch.as_tensor(end7), torch.as_tensor(ok), cfg_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"iter {it}")
        assert_tree_equal(tt, jt, msg=f"iter {it}")
    assert int(tt.n_obs.max()) == 64  # the pool filled up
    # and on the grown trees, with real child boards
    jt2, want = JW.insert_obs7_batched_pallas(
        grown, *[jnp.asarray(x) for x in _grown_children()], JCFG)
    tt2 = tree_from_jax(grown)
    got = W.insert_obs7(tt2, *[torch.as_tensor(x) for x in _grown_children(True)], TCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_tree_equal(tt2, jt2)


def _grown_children(as_port=False):
    rng = np.random.RandomState(7)
    packed7 = rng.randint(0, 2**20, size=(B, 7, 20)).astype(np.uint32)
    end7 = rng.rand(B, 7) < 0.1
    can = np.arange(B) % 3 != 0
    return (packed7.view(np.int32) if as_port else packed7), end7, can


def test_lp_backup_plain_matches_pallas(grown):
    traces, _, lengths, _ = jax.vmap(JT.select, in_axes=(0, 0, None))(
        grown, jax.random.split(jax.random.PRNGKey(3), B), JCFG)
    v_nn = np.tile(np.linspace(1.0, 7.0, 7, dtype=np.float32), (B, 1))
    var_nn = np.full((B, 7), 3.0, np.float32)
    can = np.arange(B) % 3 != 0
    want = JW.lp_backup_batched_pallas(grown, traces, lengths, jnp.asarray(v_nn),
                                       jnp.asarray(var_nn), jnp.asarray(can), JCFG)
    tt = tree_from_jax(grown)
    W.lp_backup(tt, torch.as_tensor(np.array(traces)),
                torch.as_tensor(np.array(lengths)), torch.as_tensor(v_nn),
                torch.as_tensor(var_nn), torch.as_tensor(can), TCFG)
    assert_tree_equal(tt, want)
    assert int(np.asarray(lengths).max()) > 2


# ---------------------------------------------------------------------------
# the slice: multi-move runs of the move program
# ---------------------------------------------------------------------------

# the kernel tests' shapes, so the interpreted select compiles once here
SLICE_B, SLICE_SIMS, SLICE_MOVES = B, 6, 3
SLICE_JCFG, SLICE_TCFG = JCFG, TCFG


@pytest.fixture(scope="module")
def jax_move(monkeypatch_module):
    """The JAX move program on its kernel path, with an evaluator that is
    the linspace stub when params["stub"] is true and the flax VV net
    otherwise."""
    monkeypatch_module.setattr(JW, "use_walk_kernels", lambda: True)
    model = JVVModel(seed=3)
    net_apply = model.apply_fn()

    def apply(p, u, x):
        sv, svar = stub_apply(p, u, x)
        nv, nvar = net_apply(p["net"], u, x)
        return jnp.where(p["stub"], sv, nv), jnp.where(p["stub"], svar, nvar)

    move = jax_move_program(JM.nn_child_evaluator(apply), SLICE_JCFG, SLICE_SIMS, "lp")
    return move, model


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("evaluator", ["stub", "vvnet"])
def test_slice_matches_jax(jax_move, evaluator):
    move_j, model_j = jax_move
    stub = evaluator == "stub"
    params = {"net": model_j.params, "stub": jnp.asarray(stub)}
    if stub:
        ev = M.nn_child_evaluator(torch_stub)
        tol = STAT_TOL
    else:
        ev = M.nn_child_evaluator(port_vvmodel(model_j).apply_fn())
        tol = dict(rtol=1e-4, atol=1e-3)
    planes = JaxKeyPlanes(0)
    move_t = M.make_move_fn(ev, M.SearchConfig(tree=SLICE_TCFG, sims=SLICE_SIMS), planes)
    run_slice(move_j, params, model_j.ubound, move_t, planes, SLICE_JCFG, SLICE_TCFG,
              SLICE_B, SLICE_MOVES, tol)
