"""The port's replay ring, its store move and the online driver's session
schedule against the JAX package's, on the CPU.

- `replay_add` (a partial ring, a wrapped ring, one call over capacity),
  both trims (the random trim with JAX's uniform draws fed in) and
  `replay_clear`: boards, integers and counters bit-exact, floats exact
  copies.
- The store move: test_torch_reset.py's setup (linspace stub, pools of
  128, B=8, a lane on a near-topped board, the JAX key schedule) with
  `store=True`; after each of 4 moves the ring equals the JAX ring (boards,
  weight, idx, count, total and cand exactly; value within rtol 1e-6 /
  atol 1e-5, var within rtol 1e-5 / atol 1e-5), and so do the trees. Also
  with `store_drop=True` on JAX's `k_drop` draws, and with
  `episode_reuse=True`. The JAX move program runs its plain (XLA) walks,
  the JAX package's own CPU path; its interpreted Pallas kernels give the
  same rings to the bit here. The var bound: XLA on the CPU contracts the
  backup walk's `delta * delta2 - var` into an FMA and the port rounds
  each operation (ROADMAP queue 3); on the rows harvested after 4
  moves the largest difference seen is 2.9e-6 relative (4.8e-5 on a var
  of 17.7, one row of 166); value differs by at most 6.4e-7 relative.
- The driver's session schedule for acc_policy -1..3: the JAX driver's
  methods and the port's, on the same scripted rows and episodes, with the
  model replaced by a recorder: the same sessions (rows used, front
  padding, row order), trims, clears, drop probability and log lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.runtime.selfplay import SelfPlayConfig as JSelfPlayConfig
from tetris_mcts_tpu.runtime.selfplay import SelfPlayDriver as JSelfPlayDriver
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
from tetris_mcts_tpu_torch.search import mcts as M
from test_torch_reset import GAME_END, JCFG, TCFG, start_state
from torch_parity import (STAT_TOL, JaxKeyPlanes, as_i32, assert_tree_equal, stub_apply,
                          torch_stub)

torch.set_num_threads(1)

SIMS, MOVES, MIN_VISITS, RING = 6, 4, 2, 48  # start_state() holds B=8 games


def rows(n, seed, density=0.7):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2**20, (n, 20)).astype(np.uint32),
            rng.randn(n).astype(np.float32), rng.rand(n).astype(np.float32),
            rng.randint(1, 40, n).astype(np.float32), rng.rand(n) < density)


def add_both(jrep, prep, n, seed, extra_cand=False, density=0.7):
    boards, value, var, weight, mask = rows(n, seed, density)
    cand = mask | (np.random.RandomState(seed + 1).rand(n) < 0.2) if extra_cand else None
    jrep = JM.replay_add(jrep, jnp.asarray(boards), jnp.asarray(value), jnp.asarray(var),
                         jnp.asarray(weight), jnp.asarray(mask),
                         None if cand is None else jnp.asarray(cand))
    M.replay_add(prep, torch.as_tensor(boards.view(np.int32)), torch.as_tensor(value),
                 torch.as_tensor(var), torch.as_tensor(weight), torch.as_tensor(mask),
                 None if cand is None else torch.as_tensor(cand))
    return jrep


# the store move's statistics (value, var) against the JAX ring
RING_TOL = {"value": STAT_TOL, "var": dict(rtol=1e-5, atol=1e-5)}


def assert_replay_equal(got: M.Replay, want, float_tol=None, msg=""):
    for name, a, b in zip(("boards", "value", "var", "weight"), got.rows(),
                          (want.boards, want.value, want.var, want.weight)):
        if name == "boards":
            np.testing.assert_array_equal(a.numpy(), as_i32(b), err_msg=f"{name} {msg}")
        elif float_tol and name in float_tol:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{name} {msg}",
                                       **float_tol[name])
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {msg}")
    for name in ("idx", "count", "total", "cand", "drop_prob"):
        assert getattr(got, name).item() == np.asarray(getattr(want, name)).item(), \
            f"{name} {msg}"


# (capacity, rows of each add): a partial ring, a ring that wraps, and one
# call that holds more rows than the capacity (the newest win)
ADD_CASES = {"partial": (64, [60]), "wrapped": (32, [30, 30, 30]), "over": (16, [50])}


@pytest.mark.parametrize("case", ADD_CASES)
def test_replay_add_matches_jax(case):
    cap, sizes = ADD_CASES[case]
    jrep, prep = JM.init_replay(cap), M.init_replay(cap, "cpu")
    for i, n in enumerate(sizes):
        jrep = add_both(jrep, prep, n, seed=10 * i + cap, extra_cand=i == 0)
        assert_replay_equal(prep, jrep, msg=f"{case} add {i}")
    assert prep.total.item() > cap or case == "partial"


def filled(cap=40, sizes=(30, 25, 20)):
    jrep, prep = JM.init_replay(cap), M.init_replay(cap, "cpu")
    for i, n in enumerate(sizes):
        jrep = add_both(jrep, prep, n, seed=7 + i)
    assert int(jrep.idx) != 0 and int(jrep.count) == cap  # wrapped
    return jrep, prep


@pytest.mark.parametrize("trim", ["weighted", "random"])
def test_replay_trims_match_jax(trim):
    jrep, prep = filled()
    if trim == "weighted":
        jrep, jdrop = JM.replay_trim_weighted(jrep, 0.25)
        pdrop = M.replay_trim_weighted(prep, 0.25)
    else:
        key = jax.random.PRNGKey(4)
        jrep, jdrop = JM.replay_trim_random(jrep, 0.3, key)
        u = torch.as_tensor(np.array(jax.random.uniform(key, (prep.capacity,))))
        pdrop = M.replay_trim_random(prep, 0.3, u)
    assert pdrop.item() == int(jdrop) > 0
    assert_replay_equal(prep, jrep)
    # and the ring keeps working after the compaction
    jrep = add_both(jrep, prep, 20, seed=99)
    assert_replay_equal(prep, jrep)


def test_replay_clear_matches_jax():
    jrep, prep = filled()
    jrep = JM.replay_clear(jrep)
    M.replay_clear(prep)
    assert_replay_equal(prep, jrep)


# ---------------------------------------------------------------------------
# the store move
# ---------------------------------------------------------------------------

_JAX_MOVES = {}


def jax_store_move(episode_reuse):
    """The JAX move program with store=True and store_drop=True: with
    drop_prob 0 it stores every candidate, as store_drop=False does."""
    if episode_reuse not in _JAX_MOVES:
        scfg = JM.SearchConfig(tree=JCFG, sims=SIMS, evaluator="lp")
        _JAX_MOVES[episode_reuse] = jax.jit(JM.make_move_fn(
            JM.nn_child_evaluator(stub_apply), scfg, min_visits_store=MIN_VISITS,
            store=True, store_drop=True, episode_reuse=episode_reuse))
    return _JAX_MOVES[episode_reuse]


# case -> (port store_drop, episode_reuse, drop_prob)
STORE_CASES = {"store": (False, False, 0.0), "store_drop": (True, False, 0.4),
               "episode_reuse": (False, True, 0.0)}


@pytest.mark.parametrize("case", STORE_CASES)
def test_store_move_matches_jax(case):
    store_drop, reuse, p = STORE_CASES[case]
    move_j = jax_store_move(reuse)
    planes = JaxKeyPlanes(2)
    move_t = M.make_move_fn(M.nn_child_evaluator(torch_stub),
                            M.SearchConfig(tree=TCFG, sims=SIMS), planes,
                            min_visits_store=MIN_VISITS, store=True,
                            store_drop=store_drop, episode_reuse=reuse)
    jtrees, jenvs, ttrees, tenvs = start_state()
    jrep = JM.init_replay(RING)._replace(drop_prob=jnp.float32(p))
    trep = M.init_replay(RING, "cpu")
    trep.drop_prob.fill_(p)
    rerooted = 0
    for mv in range(MOVES):
        sub = planes.next_move()
        jtrees, jenvs, jrep, jst = move_j({}, None, jtrees, jenvs, jrep, sub)
        tenvs, tst = move_t(ttrees, tenvs, trep)
        np.testing.assert_array_equal(tst.action.numpy(), np.asarray(jst.action))
        np.testing.assert_array_equal(tenvs.numpy(), as_i32(JE.pack_state(jenvs)))
        np.testing.assert_array_equal(tst.reset.numpy(), np.asarray(jst.reset))
        assert_tree_equal(ttrees, jtrees, msg=f"move {mv}")
        assert_replay_equal(trep, jrep, float_tol=RING_TOL, msg=f"move {mv}")
        rerooted += int((tst.done & ~tst.reset).sum())
    total, cand = trep.total.item(), trep.cand.item()
    assert total > RING  # the ring wrapped
    if store_drop:
        assert 0 < total < cand  # rows were dropped, candidates counted
    else:
        assert total == cand
    assert bool(tst.done[GAME_END]) or rerooted or not reuse
    if reuse:
        assert rerooted > 0  # a finished game re-rooted in its own pool


def test_store_move_needs_the_ring():
    move = M.make_move_fn(M.nn_child_evaluator(torch_stub),
                          M.SearchConfig(tree=TCFG, sims=SIMS), JaxKeyPlanes(0), store=True)
    _, _, ttrees, tenvs = start_state()
    with pytest.raises(ValueError, match="replay ring"):
        move(ttrees, tenvs)


# ---------------------------------------------------------------------------
# the driver's session schedule
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for the model: records each session's rows."""

    def __init__(self):
        self.sessions = []

    def train_data(self, data, **kw):
        self.sessions.append(np.asarray(data[0]).tolist())
        return [(kw["iters_per_val"], 0.5, 0.5, 0.1, 1.0)]

    def save(self, *a, **k):
        pass


CAP = 256
SCHED = dict(batch=4, memory_size=CAP, memory_growth=64, train_rows_trigger=96,
             train_batch=16, episodes_per_train=4, trim_fraction=0.1, seed=3)


def bare_drivers(acc_policy):
    """The JAX and the port's driver, bookkeeping only (no move program)."""
    jd = JSelfPlayDriver.__new__(JSelfPlayDriver)
    jlog, plog = [], []
    jd._init_bookkeeping(JSelfPlayConfig(acc_policy=acc_policy, **SCHED), jlog.append,
                         None, None, None)
    jd.model, jd.replay = Recorder(), JM.init_replay(CAP)
    jd._training_columns = lambda order: [order]
    pd = SelfPlayDriver.__new__(SelfPlayDriver)
    pd._init_bookkeeping(SelfPlayConfig(acc_policy=acc_policy, **SCHED), plog.append, None)
    pd.model, pd.replay = Recorder(), M.init_replay(CAP, "cpu")
    pd._training_columns = lambda order: [order]
    # the random trim's draws: the JAX driver's own key chain
    key = [jax.random.PRNGKey(SCHED["seed"])]

    def uniforms(n):
        key[0], k = jax.random.split(key[0])
        return torch.as_tensor(np.array(jax.random.uniform(k, (n,))))

    pd._trim_uniforms = uniforms
    return jd, pd, jlog, plog


@pytest.mark.parametrize("acc_policy", [-1, 0, 1, 2, 3])
def test_session_schedule_matches_jax(acc_policy):
    jd, pd, jlog, plog = bare_drivers(acc_policy)
    rng = np.random.RandomState(acc_policy + 10)
    for step in range(60):
        # 48 rows a step (one shape for the JAX ops), 0 to 48 of them stored
        jd.replay = add_both(jd.replay, pd.replay, 48, seed=1000 + step, extra_cand=True,
                             density=rng.choice([0.0, 0.5, 1.0]))
        eps = int(rng.choice([0, 0, 0, 0, 0, 1, 2]))
        jd.episodes += eps
        pd.episodes += eps
        total, cand = int(jd.replay.total), int(jd.replay.cand)
        if acc_policy < 0:
            jd._maybe_train(total)
            pd._maybe_train(total)
        else:
            jd._acc_policy_step(total, cand)
            pd._acc_policy_step(total, cand)
        assert pd.model.sessions == jd.model.sessions, f"step {step}"
        assert (pd.n_trains, pd.trims, pd._mem_rows) == (jd.n_trains, jd.trims, jd._mem_rows)
        assert_replay_equal(pd.replay, jd.replay, msg=f"step {step}")
    same = lambda log: [ln for ln in log if " done in " not in ln]
    assert same(plog) == same(jlog)
    assert pd.n_trains >= 2
    if acc_policy in (0, 1):
        assert pd.trims >= 1
    if acc_policy >= 0:
        # a ring cleared after a session; some session padded at the front
        assert any(len(s) > len(set(s)) for s in pd.model.sessions) or acc_policy == 3
