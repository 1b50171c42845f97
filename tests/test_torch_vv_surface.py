"""The rest of the VV tree's surface in the port against the JAX package, on
the CPU: `--policy max`, `--allow_clamp`, the alternative backups and the
kernel flags.

- `--policy max` (UCB1 scaled by the kept children's `vmax`, tracked by the
  backups): 3 moves of the lp and of the leaf move program against the JAX
  move program, which runs its XLA walks for max; both fed the XLA walk's
  draws (the JAX key schedule replayed, `JaxXlaWalkKeyPlanes`): actions,
  env states, resets, node counts and the trees' integer arrays equal;
  values and vmax within rtol 1e-6 / atol 1e-5; vars (and the root's child
  stats, which hold them) within rtol 1e-5 / atol 1e-5, the bound of the
  earlier multi-move tests (`test_torch_replay.py`): XLA contracts the
  Welford update's `delta * delta2 - var` into a fused multiply-add, and
  over 3 moves of lp max backups that drifts the variances by up to 3.4e-6
  relative (values 8e-7, vmax 1.1e-6).
- `capacity_guard_for(..., allow_clamp=True)` equal to the JAX function
  (and a warning, where the default raises); 3 moves of a clamped lp search
  (pools of 64 for 12 sims: every tree resets every move) against the JAX
  move program, the port on its plain routes (`select_kernel` and
  `insert_kernel` off), with the same tolerances.
- `tree.backup_exp_moving` and `tree.backup_mixture` (batched) against the
  JAX per-tree functions vmapped, lane by lane on grown trees: visits
  equal, values and vars within rtol 1e-6 / atol 1e-5.
- The routes: `--select_kernel 0` runs the plain select walk,
  `--insert_kernel 0` the plain insert, `--policy max` the plain select and
  backups with the insert kernel's wrapper; the CLI parses `--select_kernel
  0|1`, `--insert_kernel 0|1`, `--policy max` and `--allow_clamp` into the
  driver's configuration and logs the plain walks once.
"""

import jax
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.cli import play
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from torch_parity import (STAT_TOL, JaxXlaWalkKeyPlanes, jax_move_program, run_slice,
                          stub_apply, torch_stub, tree_from_jax)

torch.set_num_threads(1)

B, SIMS, MOVES = 4, 6, 3
VAR_TOL = dict(rtol=1e-5, atol=1e-5)  # variances after several moves (FMA drift)
POOLS = dict(max_nodes=256, max_obs=256, table_size=512, max_depth=16)
EVALUATORS = {"lp": (JM.nn_child_evaluator, M.nn_child_evaluator),
              "leaf": (JM.nn_leaf_evaluator, M.nn_leaf_evaluator)}


@pytest.mark.parametrize("evaluator", ["lp", "leaf"])
def test_policy_max_moves_match_jax(evaluator):
    jcfg = JT.TreeConfig(policy="max", **POOLS)
    tcfg = T.TreeConfig(policy="max", **POOLS)
    jev, tev = EVALUATORS[evaluator]
    move_j = jax_move_program(jev(stub_apply), jcfg, SIMS, evaluator)
    planes = JaxXlaWalkKeyPlanes(3)
    move_t = M.make_move_fn(tev(torch_stub),
                            M.SearchConfig(tree=tcfg, sims=SIMS, evaluator=evaluator), planes)
    ttrees, jtrees = run_slice(move_j, None, None, move_t, planes, jcfg, tcfg, B, MOVES,
                               VAR_TOL, final_select=False)
    for f in ("values", "vmax"):
        np.testing.assert_allclose(getattr(ttrees, f).numpy(), np.asarray(getattr(jtrees, f)),
                                   err_msg=f, **STAT_TOL)
    assert float(ttrees.vmax.max()) > 0 and int(ttrees.n_nodes.min()) > 7 * SIMS


def test_allow_clamp_matches_jax(capsys):
    for sims, pool in ((12, 64), (6, 256), (100, 4096)):
        jcfg = JT.TreeConfig(max_nodes=pool, max_obs=pool)
        tcfg = T.TreeConfig(max_nodes=pool, max_obs=pool)
        assert (M.capacity_guard_for(sims, tcfg, allow_clamp=True)
                == JM.capacity_guard_for(sims, jcfg, allow_clamp=True))
    with pytest.raises(ValueError, match="allow_clamp"):
        M.capacity_guard_for(12, T.TreeConfig(max_nodes=64, max_obs=64))
    assert M.capacity_guard_for(12, T.TreeConfig(max_nodes=64, max_obs=64), True) == 56
    assert "warning: max_nodes=64/max_obs=64 cannot hold" in capsys.readouterr().err
    # a clamped search: the port on its plain routes, JAX on its XLA walks
    pools = dict(max_nodes=64, max_obs=64, table_size=128, max_depth=16)
    jcfg = JT.TreeConfig(**pools)
    tcfg = T.TreeConfig(select_kernel=False, insert_kernel=False, **pools)
    move_j = jax_move_program(JM.nn_child_evaluator(stub_apply), jcfg, 12, "lp",
                              allow_clamp=True)
    planes = JaxXlaWalkKeyPlanes(5)
    move_t = M.make_move_fn(M.nn_child_evaluator(torch_stub),
                            M.SearchConfig(tree=tcfg, sims=12, allow_clamp=True), planes)
    record = []
    run_slice(move_j, None, None, move_t, planes, jcfg, tcfg, B, MOVES, STAT_TOL,
              record=record, final_select=False)
    assert all(bool(st.reset.all()) for st in record)  # the pools hold no move
    assert all(int(st.n_nodes.min()) > 64 - 8 for st in record)  # the pools filled


@pytest.fixture(scope="module")
def grown():
    """JAX trees after 9 lp sims (B=8, pools 256), and a select walk's traces."""
    jcfg = JT.TreeConfig(**POOLS)
    scfg = JM.SearchConfig(tree=jcfg, sims=9, evaluator="lp")
    run = JM.make_run_sims(JM.nn_child_evaluator(stub_apply), scfg)
    trees, _ = JM.init_batch(17, 8, scfg)
    trees = jax.jit(run)(None, None, trees, jax.random.PRNGKey(4))
    traces, _, lengths, *_ = jax.jit(JT.select_batched, static_argnums=2)(
        trees, jax.random.split(jax.random.PRNGKey(8), 8), jcfg)
    return jcfg, trees, traces, lengths


@pytest.mark.parametrize("kind", ["exp_moving", "mixture"])
def test_alternative_backups_match_jax(grown, kind):
    jcfg, jtrees, traces, lengths = grown
    tcfg = T.TreeConfig(**POOLS)
    rng = np.random.RandomState(2)
    v0 = rng.uniform(0, 60, 8).astype(np.float32)
    var0 = rng.uniform(0.5, 30, 8).astype(np.float32)
    jfn = {"exp_moving": JT.backup_exp_moving, "mixture": JT.backup_mixture}[kind]
    want = jax.jit(jax.vmap(jfn, in_axes=(0, 0, 0, 0, 0, None)), static_argnums=5)(
        jtrees, traces, lengths, v0, var0, jcfg)
    got = tree_from_jax(jtrees)
    getattr(T, f"backup_{kind}")(got, torch.as_tensor(np.array(traces)),
                                 torch.as_tensor(np.array(lengths)), torch.as_tensor(v0),
                                 torch.as_tensor(var0), tcfg)
    np.testing.assert_array_equal(got.visits.numpy(), np.asarray(want.visits))
    for f in ("values", "vars_"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **STAT_TOL)
    assert int(np.asarray(lengths).min()) > 1  # the walks went below the root
    assert float(np.abs(got.vars_.numpy() - np.asarray(jtrees.vars_)).max()) > 0


class Spy:
    """Counts the calls of a walk wrapper and runs its plain version."""

    def __init__(self, plain):
        self.plain, self.calls = plain, 0

    def __call__(self, *a):
        self.calls += 1
        return self.plain(*a)


@pytest.mark.parametrize("route", ["kernels", "select_kernel_0", "insert_kernel_0",
                                   "policy_max"])
@pytest.mark.parametrize("evaluator", ["lp", "leaf"])
def test_walk_routes(route, evaluator, monkeypatch):
    spies = {"select_walk": Spy(W.select_walk_plain),
             "insert_obs7": Spy(T.insert_obs7_batched),
             "lp_backup": Spy(W.lp_backup_plain), "backup": Spy(T.backup_batched)}
    for name, spy in spies.items():
        monkeypatch.setattr(W, name, spy)
    kw = {"select_kernel_0": dict(select_kernel=False),
          "insert_kernel_0": dict(insert_kernel=False),
          "policy_max": dict(policy="max")}.get(route, {})
    tcfg = T.TreeConfig(max_nodes=128, max_obs=128, table_size=256, max_depth=8, **kw)
    scfg = M.SearchConfig(tree=tcfg, sims=3, evaluator=evaluator)
    move = M.make_move_fn(EVALUATORS[evaluator][1](torch_stub), scfg,
                          M.TorchPlanes(0, "cpu", tcfg.policy))
    trees, envs = M.init_batch(1, 2, scfg, device="cpu")
    move(trees, envs)
    backup = "lp_backup" if evaluator == "lp" else "backup"
    kernel = {"select_walk": route not in ("select_kernel_0", "policy_max"),
              "insert_obs7": route != "insert_kernel_0",
              backup: route != "policy_max"}
    for name, through_wrapper in kernel.items():
        assert spies[name].calls == (3 if through_wrapper else 0), name
    assert M.walk_routes(tcfg) == {
        "select": "kernel" if kernel["select_walk"] else "plain",
        "insert": "kernel" if kernel["insert_obs7"] else "plain",
        "backup": "kernel" if kernel[backup] else "plain"}


TINY = ["--device", "cpu", "--batch", "2", "--mcts_sims", "2", "--max_nodes", "64",
        "--max_obs", "64", "--max_depth", "6", "--ngames", "0"]


@pytest.mark.parametrize("flags,want", [
    ([], (True, True, "clt", False)),
    (["--select_kernel"], (True, True, "clt", False)),
    (["--select_kernel", "0"], (False, True, "clt", False)),
    (["--insert_kernel", "0"], (True, False, "clt", False)),
    (["--select_kernel", "1", "--insert_kernel", "1"], (True, True, "clt", False)),
    (["--policy", "max", "--allow_clamp", "--mcts_sims", "20"], (True, True, "max", True)),
])
def test_play_parses_the_surface_flags(flags, want, capsys):
    driver = play.main(TINY + flags)
    tcfg = driver.search_cfg.tree
    assert (tcfg.select_kernel, tcfg.insert_kernel, tcfg.policy,
            driver.search_cfg.allow_clamp) == want
    err = capsys.readouterr().err
    plain = [s for s, r in M.walk_routes(tcfg).items() if r == "plain"]
    assert err.count("plain walks (no kernel) for:") == (1 if plain else 0)
    if want[3]:  # 20 sims cannot fit pools of 64: clamped, with a warning
        assert "warning: max_nodes=64/max_obs=64" in err and driver.moves == 0


def test_play_refuses_a_kernel_flag_out_of_range(capsys):
    with pytest.raises(SystemExit) as exc:
        play.main(TINY + ["--select_kernel", "2"])
    assert exc.value.code == 2 and "--select_kernel" in capsys.readouterr().err
