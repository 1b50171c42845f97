"""Double-hash probing (`TMT_PROBE=double`) in the port against the JAX
package, on the CPU.

The JAX package reads its mode once, at import, into
`tetris_mcts_tpu.search.tree._PROBE_DOUBLE`, and its jitted functions read
that flag when they are traced; the tests set it with monkeypatch and call
`jax.clear_caches()` before and after, so each mode is traced afresh and no
other test of the process sees the patched traces. The port carries the
mode in `TreeConfig.probe_double` (its default read from TMT_PROBE once).

- The plain inserts (`tree.insert_obs7_batched`, what the insert kernel is
  held against, and the single-key `_insert_obs` of `alloc_node`) under
  double probing against the JAX package's `insert_obs7_batched`, its
  interpreted Pallas insert and its vmapped `_insert_obs`, on a 128-slot
  table with a small key space (repeats within and across calls, keys that
  share a home slot, a pool that fills): obs ids and tables equal.
- The same inputs under linear probing give the table the port gave
  before the switch existed (the JAX package's linear table), and the two
  modes give different tables.
- A 3-move lp slice (B=8, 6 sims, pools 256, table 512, depth 32, the
  linspace stub net) under double probing against the JAX move program on
  its kernel path: every integer equal, statistics within rtol 1e-6 /
  atol 1e-5.
- TMT_PROBE=double in a fresh process sets both packages' default mode.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from torch_parity import (B, JCFG, STAT_TOL, TCFG, JaxKeyPlanes, assert_tree_equal,
                          jax_move_program, run_slice, stub_apply, torch_stub, tree_from_jax)

torch.set_num_threads(1)

SMALL_J = JCFG._replace(max_obs=64, table_size=128)
SMALL_T = TCFG._replace(max_obs=64, table_size=128)


@pytest.fixture
def probe_mode(monkeypatch):
    """set(double): the JAX package's mode, its traces cleared."""
    def set_(double):
        jax.clear_caches()
        monkeypatch.setattr(JT, "_PROBE_DOUBLE", double)

    yield set_
    jax.clear_caches()


def double_stepped(trees, size):
    """How many keys of the tables sit one double-hash step from their home
    slot: at h1 + (h2 | 1), where that step is not 1 (linear probing puts
    none there but by chance)."""
    h1, h2 = T.u32(trees.tbl_h1), T.u32(trees.tbl_h2)
    off = (torch.arange(size).expand_as(h1) - h1) % size
    step = (h2 | 1) % size
    return int(((trees.tbl_obs != 0) & (off == step) & (step > 1)).sum())


def insert_inputs(n=12, seed=5):
    """Calls of 4 trees: a small key space, so keys repeat within a call
    and across calls, and share home slots (mod 128)."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 5, (4, 7, 20)).astype(np.uint32), rng.rand(4, 7) < 0.2,
             rng.rand(4) < 0.9) for _ in range(n)]


def run_inserts(double, pallas):
    """The JAX package's inserts and the port's plain insert on the same
    calls; returns (port trees, JAX trees)."""
    js = JE.reset_batch(11, 4, SMALL_J.env)
    jt = jax.vmap(JT.init_tree, in_axes=(0, None))(js, SMALL_J)
    tt = tree_from_jax(jt)
    cfg_t = SMALL_T._replace(probe_double=double)
    jins = (JW.insert_obs7_batched_pallas if pallas else
            jax.jit(JT.insert_obs7_batched, static_argnums=4))
    for it, (packed7, end7, ok) in enumerate(insert_inputs()):
        jt, want = jins(jt, jnp.asarray(packed7), jnp.asarray(end7), jnp.asarray(ok), SMALL_J)
        got = W.insert_obs7(tt, torch.as_tensor(packed7.view(np.int32)), torch.as_tensor(end7),
                            torch.as_tensor(ok), cfg_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"call {it}")
        assert_tree_equal(tt, jt, msg=f"call {it}")
    assert int(tt.n_obs.max()) == 64  # the pool filled up
    return tt, jt


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
def test_plain_insert_matches_jax_under_double_probing(probe_mode, pallas):
    probe_mode(True)
    tt, _ = run_inserts(True, pallas)
    assert double_stepped(tt, 128) > 0


def test_linear_probing_gives_the_linear_table(probe_mode):
    """Linear mode: the JAX package's linear table (what the port gave
    before the double mode existed), and unlike the double mode's."""
    probe_mode(False)
    assert not T.TreeConfig().probe_double  # TMT_PROBE is unset here
    lin, _ = run_inserts(False, pallas=False)
    probe_mode(True)
    dbl, _ = run_inserts(True, pallas=False)
    assert not torch.equal(lin.tbl_obs, dbl.tbl_obs)


@pytest.mark.parametrize("double", [False, True], ids=["linear", "double"])
def test_single_key_insert_matches_jax(probe_mode, double):
    """`alloc_node`'s single-key insert (a window of PROBE_ROUNDS slots of
    the key's sequence) against the JAX package's while-loop probe."""
    probe_mode(double)
    js = JE.reset_batch(11, 4, SMALL_J.env)
    jt = jax.vmap(JT.init_tree, in_axes=(0, None))(js, SMALL_J)
    tt = tree_from_jax(jt)
    cfg_t = SMALL_T._replace(probe_double=double)
    jins = jax.jit(jax.vmap(JT._insert_obs, in_axes=(0, 0, 0, 0, None)), static_argnums=4)
    rng = np.random.RandomState(3)
    for it in range(40):
        packed = rng.randint(0, 6, (4, 20)).astype(np.uint32)
        end = rng.rand(4) < 0.2
        ok = rng.rand(4) < 0.9
        jt, want = jins(jt, jnp.asarray(packed), jnp.asarray(end), jnp.asarray(ok), SMALL_J)
        got = T._insert_obs(tt, torch.as_tensor(packed.view(np.int32)), torch.as_tensor(end),
                            torch.as_tensor(ok), cfg_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"call {it}")
        assert_tree_equal(tt, jt, msg=f"call {it}")


def test_lp_slice_matches_jax_under_double_probing(probe_mode, monkeypatch):
    probe_mode(True)
    monkeypatch.setattr(JW, "use_walk_kernels", lambda: True)
    move_j = jax_move_program(JM.nn_child_evaluator(stub_apply), JCFG, 6, "lp")
    planes = JaxKeyPlanes(0)
    tcfg = TCFG._replace(probe_double=True)
    move_t = M.make_move_fn(M.nn_child_evaluator(torch_stub),
                            M.SearchConfig(tree=tcfg, sims=6), planes)
    tt, _ = run_slice(move_j, None, None, move_t, planes, JCFG, tcfg, B, 3, STAT_TOL,
                      final_select=False)
    assert double_stepped(tt, JCFG.table_size) > 10


def test_env_switch_sets_both_packages_default():
    code = ("from tetris_mcts_tpu.search import tree as JT; "
            "from tetris_mcts_tpu_torch.search import tree as T; "
            "print(JT._PROBE_DOUBLE, T.TreeConfig().probe_double)")
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "TMT_PROBE": "double", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True"]
