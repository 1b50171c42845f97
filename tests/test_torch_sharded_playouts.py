"""The port's playout evaluators on several ranks (`search/mcts.py`
`rollout_evaluator` / `policy_rollout_evaluator` with the exit test
`parallel/mesh.Mesh.all_ended`, `ShardedPlanes.actions` / `.gumbels`,
`runtime/distributed.DistributedSelfPlay`) against the JAX package, whose
sharded move compiles each playout loop's `jnp.any(~end)` into a reduction
over the global batch. The ranks are 2 gloo processes on the CPU, spawned
once (`runtime/distributed.spawn`, tests/torch_ranks.sharded_playouts).

- The evaluators alone (Vanilla's rollout, FiniteSim's and FullSim's
  policy playouts on the stub VP net of tests/torch_parity.py) on 8 leaf
  states whose boards numpy stacks from a seed: rank 0's 4 lanes all end
  within 16 steps, rank 1's play on. Both ranks run the steps of one
  process on all 8 lanes, which is at least 16 more than rank 0 alone
  would run, and the values are the JAX evaluators' on the same draws.
- Vanilla, HybridSim, FiniteSim and FullSim moves on 2 ranks of 4 lanes
  against the JAX move program sharded over the 8 virtual devices at B=8
  (`sharded_move_fn`), on stacked boards, fed the JAX key schedule
  (recorded draws, each playout's by step): actions, envs, trees and rings
  equal in every integer, statistics within STAT_TOL (rtol 1e-6 / atol
  1e-5); the rings bit-equal across ranks and the playout steps equal.
- `DistributedSelfPlay(evaluator="rollout")` on 2 ranks against the JAX
  move program on the concatenation of the ranks' games (what the
  reference's two-controller run computes), fed its key schedule; and on
  its own `TorchPlanes` (one generator, drawn in sequence) bit-equal to
  one process at B=8 on those games, with an exit test in the run where
  rank 0's lanes had all ended and rank 1's had not.
- Without a group: `ShardedPlanes.actions` / `.gumbels` are a rank's rows
  of the global draw, and `parallel/mesh.model_tensors` of the VP model
  (the policy playouts' net) holds its Adam-amsgrad state.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.parallel import mesh as JP
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu_torch.parallel import mesh as M
from tetris_mcts_tpu_torch.runtime import distributed as D
from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig
from tetris_mcts_tpu_torch.search import mcts as PM
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.train.trainer import VPModel
from test_torch_parallel import _assert_ring_equal, _assert_rings_bit_equal, _rows
from torch_parity import (JaxKeyPlanes, JaxXlaWalkKeyPlanes, as_i32, assert_tree_equal,
                          torch_gumbels_of, vp_stubs)
from torch_ranks import PlayoutDraws, _one_process, playout_evaluator, sharded_playouts

torch.set_num_threads(1)

B, SIMS, MOVES, RING, SEED = 8, 3, 3, 256, 5
POOLS = dict(max_nodes=64, max_obs=64, table_size=128, max_depth=8)
CAP = 48  # the moves' rollout cap (Vanilla, FullSim): three exit tests
EVAL_CAP = 512  # the evaluators' cap, the reference's
EVALS = ("rollout", "finite", "full")
MOVE_KINDS = ("rollout", "hybrid", "finite", "full")
# rank 0's lanes stacked to row 4 (their games end within a few steps),
# rank 1's to row 12; the moves' lanes one height each
EVAL_TOPS = (4, 4, 4, 4, 12, 12, 12, 12)
MOVE_TOPS = (4, 6, 8, 10, 12, 14, 16, 18)
DRIVE = SelfPlayConfig(batch=B, sims=SIMS, evaluator="rollout", low=5, min_visits_store=1,
                       memory_size=RING, train_rows_trigger=10**9, seed=SEED, **POOLS)
jax_vp, _ = vp_stubs()


def stacked(seed, tops):
    """Fresh games (`reset_batch(seed)`) on boards stacked from row
    tops[b] down: each row's cells filled with probability 0.7 and one
    column left open, so no line is full."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((len(tops), 20), np.uint32)
    for b, top in enumerate(tops):
        for r in range(top, 20):
            cells = rng.rand(10) < 0.7
            cells[rng.randint(10)] = False
            rows[b, r] = int((cells * (1 << np.arange(10))).sum())
    return JE.reset_batch(seed, len(tops))._replace(rows=jnp.asarray(rows))


def _configs(kind, cap):
    jcfg = JM.SearchConfig(tree=JT.TreeConfig(**POOLS), sims=SIMS, evaluator=kind,
                           rollout_cap=cap)
    tcfg = PM.SearchConfig(tree=T.TreeConfig(**POOLS), sims=SIMS, evaluator=kind,
                           rollout_cap=cap)
    return jcfg, tcfg


def _jax_evaluator(jcfg, tcfg):
    if jcfg.evaluator == "rollout":
        return JM.rollout_evaluator(jcfg)
    return JM.policy_rollout_evaluator(jax_vp, jcfg, PM.playout_depth(tcfg),
                                       PM.POLICY_PLAYOUTS[jcfg.evaluator][1])


def _playout_draws(planes, kind, n):
    """The n per-step draws of the simulation whose select draw `planes`
    made last (its k_ev): uniform actions, or a policy playout's gumbels."""
    if kind == "rollout":
        return [planes.actions(B, s) for s in range(n)]
    draw = torch_gumbels_of(planes)
    return [draw(B, s) for s in range(n)]


def _eval_case(kind):
    """The port's case: the stacked leaves and the draws by step of the
    evaluator's key (3); and a thunk giving the JAX evaluator's values and
    variances on them."""
    jcfg, tcfg = _configs(kind, EVAL_CAP)
    states = stacked(9, EVAL_TOPS)
    key = jax.random.PRNGKey(3)
    planes = JaxKeyPlanes(0)
    planes._k_ev = key  # the evaluator's key, as a simulation would hand it
    steps = _playout_draws(planes, kind, PM.playout_depth(tcfg) if kind != "rollout" else
                           EVAL_CAP)
    env = torch.as_tensor(as_i32(JE.pack_state(states)))

    def run():
        v, var = jax.jit(_jax_evaluator(jcfg, tcfg))(None, None, None, states, key)
        return np.asarray(v), np.asarray(var)

    return dict(scfg=tcfg, env=env, steps=steps), run


def _move_case(kind):
    """The port's case: the stacked games and MOVES moves' recorded draws
    of the key schedule of seed 11; and a thunk running the JAX move
    program sharded over the 8 devices at B=8 on them, giving its states
    after the last move and every move's actions."""
    jcfg, tcfg = _configs(kind, CAP)
    states = stacked(7, MOVE_TOPS)
    envs = torch.as_tensor(as_i32(JE.pack_state(states)))
    planes = JaxXlaWalkKeyPlanes(11)
    n = PM.playout_depth(tcfg) if kind != "rollout" else CAP
    subs, draws, playouts = [], [], []
    for _ in range(MOVES):
        subs.append(planes.next_move())
        for _ in range(SIMS):
            draws.append(planes(B, POOLS["max_depth"]))
            playouts.append(_playout_draws(planes, kind, n))

    def run():
        jtrees = jax.vmap(JT.init_tree, in_axes=(0, None))(states, jcfg.tree)
        smove = JP.sharded_move_fn(JM.make_move_fn(_jax_evaluator(jcfg, tcfg), jcfg,
                                                   min_visits_store=1), JP.make_mesh(8))
        ring, jenvs, actions = JM.init_replay(RING), states, []
        for sub in subs:
            jtrees, jenvs, ring, st = smove({}, jnp.zeros(2), jtrees, jenvs, ring, sub)
            actions.append(np.asarray(st.action))
        return jtrees, jenvs, ring, actions

    return dict(scfg=tcfg, trees=T.init_tree(envs, tcfg.tree), envs=envs, moves=MOVES,
                ring=RING, draws=draws, playouts=playouts), run


def _drive_case():
    """The recorded draws (select, playouts) of MOVES moves of the key
    schedule of seed SEED; and a thunk running the JAX rollout move program
    in one process on the concatenation of `init_batch(SEED + 7919 r, 4)`,
    r = 0, 1, on them, giving its last states."""
    jcfg = JM.SearchConfig(tree=JT.TreeConfig(low=DRIVE.low, **POOLS), sims=SIMS,
                           evaluator="rollout")
    planes, subs, draws, playouts = JaxXlaWalkKeyPlanes(SEED), [], [], []
    for _ in range(MOVES):
        subs.append(planes.next_move())
        for _ in range(SIMS):
            draws.append(planes(B, POOLS["max_depth"]))
            playouts.append(_playout_draws(planes, "rollout", jcfg.rollout_cap))

    def run():
        move = jax.jit(JM.make_move_fn(JM.rollout_evaluator(jcfg), jcfg, min_visits_store=1))
        halves = [JM.init_batch(D.host_seed(SEED, r), B // 2, jcfg) for r in (0, 1)]
        trees, envs = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), *halves)
        ring = JM.init_replay(DRIVE.memory_size)
        for sub in subs:
            trees, envs, ring, st = move(None, None, trees, envs, ring, sub)
        return trees, envs, ring, st

    return (draws, playouts), run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs, spawned first, and the JAX programs meanwhile."""
    evals = {k: _eval_case(k) for k in EVALS}
    moves = {k: _move_case(k) for k in MOVE_KINDS}
    recorded, drive_jax = _drive_case()
    drives = {"jax": (DRIVE, MOVES, recorded), "own": (DRIVE, MOVES, None)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(D.spawn, sharded_playouts, 2,
                            ({k: c for k, (c, _) in evals.items()},
                             {k: c for k, (c, _) in moves.items()}, drives),
                            device="cpu", timeout=300,
                            workdir=str(tmp_path_factory.mktemp("ranks")))
        jax_out = dict(evals={k: run() for k, (_, run) in evals.items()},
                       moves={k: run() for k, (_, run) in moves.items()}, drive=drive_jax())
        outs = ranks.result()
    return dict(evals={k: c for k, (c, _) in evals.items()},
                moves={k: c for k, (c, _) in moves.items()}, jax=jax_out, outs=outs)


@pytest.mark.parametrize("kind", EVALS)
def test_sharded_playout_evaluator_matches_jax(runs, kind):
    case, (v_j, var_j) = runs["evals"][kind], runs["jax"]["evals"][kind]
    got = [o["evals"][kind] for o in runs["outs"]]
    np.testing.assert_array_equal(torch.cat([g["v"] for g in got]).numpy(), v_j)
    np.testing.assert_array_equal(torch.cat([g["var"] for g in got]).numpy(), var_j)
    # one process on all 8 lanes, and rank 0's 4 lanes on their own exit test
    one = playout_evaluator(case["scfg"], PlayoutDraws(case["steps"]))
    one(None, case["env"])
    alone = playout_evaluator(case["scfg"], M.ShardedPlanes(PlayoutDraws(case["steps"]),
                                                            M.Mesh(2, 0)))
    alone(None, case["env"][:B // 2])
    assert got[0]["steps"] == got[1]["steps"] == one.steps
    assert one.steps - alone.steps >= PM.ROLLOUT_EXIT_EVERY
    # rank 0's lanes had all ended at a test where rank 1's played on; both
    # ranks made the same tests with the same answers
    assert (True, False) in got[0]["checks"]
    assert [g for _, g in got[0]["checks"]] == [g for _, g in got[1]["checks"]]


@pytest.mark.parametrize("kind", MOVE_KINDS)
def test_sharded_playout_moves_match_jax(runs, kind):
    jtrees, jenvs, jring, jactions = runs["jax"]["moves"][kind]
    got = [o["moves"][kind] for o in runs["outs"]]
    for r, g in enumerate(got):
        for mv, a in enumerate(g["actions"]):
            np.testing.assert_array_equal(a.numpy(), jactions[mv][r * 4:(r + 1) * 4],
                                          err_msg=f"{kind} rank {r} move {mv}")
        np.testing.assert_array_equal(g["envs"].numpy(), as_i32(JE.pack_state(_rows(jenvs, r))))
        assert_tree_equal(g["trees"], _rows(jtrees, r), msg=f"{kind} rank {r}")
        _assert_ring_equal(g["ring"], jring)
    _assert_rings_bit_equal(got[0]["ring"], got[1]["ring"])
    assert got[0]["steps"] == got[1]["steps"] and len(got[0]["steps"]) == MOVES * SIMS
    assert got[0]["ring"].total.item() > 0
    assert any(s > PM.ROLLOUT_EXIT_EVERY for s in got[0]["steps"])


def test_distributed_rollout_selfplay_matches_the_jax_two_controller_run(runs):
    jtrees, jenvs, jring, jst = runs["jax"]["drive"]
    outs = [o["drives"]["jax"] for o in runs["outs"]]
    for r, o in enumerate(outs):
        rows = jax.tree.map(lambda x: x[4 * r:4 * r + 4], (jtrees, jenvs, jst.action))
        np.testing.assert_array_equal(o["actions"].numpy(), np.asarray(rows[2]))
        np.testing.assert_array_equal(o["envs"].numpy(), as_i32(JE.pack_state(rows[1])))
        assert_tree_equal(o["trees"], rows[0], msg=f"rank {r}")
        _assert_ring_equal(o["ring"], jring)
    a, b = outs
    assert (a["moves"], a["episodes"], a["lines"], a["log"], a["steps"]) == \
        (b["moves"], b["episodes"], b["lines"], b["log"], b["steps"])
    _assert_rings_bit_equal(a["ring"], b["ring"])
    assert a["ring"].total.item() > 0 and a["moves"] == MOVES


def test_distributed_rollout_selfplay_on_its_own_planes_is_one_process(runs):
    outs = [o["drives"]["own"] for o in runs["outs"]]
    one = _one_process(DRIVE, 2, "cpu")
    one.run(MOVES)
    for r, o in enumerate(outs):
        for f in ("cbase", "nstat", "end", "n_nodes", "root_env", "visits", "values", "vars_",
                  "obs_bits", "n_obs", "tbl_obs", "root"):
            assert torch.equal(getattr(o["trees"], f), getattr(one.trees, f)[4 * r:4 * r + 4]), f
        assert torch.equal(o["envs"], one.envs[4 * r:4 * r + 4])
        _assert_rings_bit_equal(o["ring"], one.replay)
    assert outs[0]["steps"] == outs[1]["steps"] == one.evaluator.steps
    # the run had an exit test where rank 0's lanes alone would have stopped
    assert (True, False) in outs[0]["checks"]


def test_sharded_planes_draw_a_ranks_rows():
    whole = PM.TorchPlanes(4, "cpu")
    want_a, want_g = whole.actions(B, 0), whole.gumbels(B, 1)
    for r in (0, 1):
        planes = M.ShardedPlanes(PM.TorchPlanes(4, "cpu"), M.Mesh(2, r))
        assert torch.equal(planes.actions(B // 2, 0), want_a[4 * r:4 * r + 4])
        assert torch.equal(planes.gumbels(B // 2, 1), want_g[4 * r:4 * r + 4])
    # without a group the exit test is this process's
    env = torch.as_tensor(as_i32(JE.pack_state(stacked(9, EVAL_TOPS))))
    env[:, 43] = torch.tensor([1, 1, 1, 1, 0, 1, 1, 1])
    assert not M.Mesh(1, 0).all_ended(env) and not PM.lanes_ended(env)
    env[4, 43] = 1
    assert M.Mesh(1, 0).all_ended(env) and PM.lanes_ended(env)


def test_model_tensors_cover_the_vp_model():
    m = VPModel(seed=0, device="cpu")
    held = {t.data_ptr() for t in M.model_tensors(m)}
    params = list(m.net.parameters())
    assert len(held) == 4 * len(params)  # the params and the three moments
    for t in params + m.opt.mu + m.opt.nu + m.opt.nu_max:
        assert t.data_ptr() in held
