"""The port's measurement entry points (`bench_torch.py`,
`scripts/agent_bench_torch.py`, `scripts/profile_mcts_torch.py`,
`scripts/scaling_bench_torch.py`) against the JAX package's, on the CPU.

- `bench_env` at bench.py's CPU size (B=512, 64 steps, 2 reps), fed the
  JAX program's `randint` draws: the packed env states after the warm-up
  and the timed runs equal those of bench.py's program (`jax_bench_env`, a
  copy of bench.py:44-81 that returns the states: bench.py returns only the
  rate), and lanes ended and were soft-reset on the way.
- `bench_mcts` at bench.py's CPU size (B=16, 16 sims, 2 moves; one warm-up
  run and one timed run, so the key restarts once), float32 net
  (TMT_NN_F32=1) with the JAX VVModel(seed=0)'s weights, against the JAX
  move program built as bench.py:101-113 builds it (store on,
  min_visits_store 25, a ring of 100000) on its kernel path (the Pallas
  kernels interpreted) and the key schedule of bench.py's scan (a split a
  move from PRNGKey(seed), restarted each run) through
  `torch_parity.JaxKeyPlanes`: after every move the actions, env states,
  node counts and lines equal; the ring's counters and boards equal, its
  value within the nets' rtol 1e-4 / atol 1e-3 and var within rtol 1e-4 /
  atol 1e-2 (the ring holds tree statistics of the nets' values). A second
  case starts one lane on a near-topped board (tests/test_torch_reset.py's)
  so that its game ends and its tree's rows enter the ring.
- `bench_torch.main(["--device", "cpu"])`: one JSON line whose keys are
  bench.py's (read from its source) minus `bench_torch.LEFT_OUT`.
- `agent_bench_torch`: a row per agent family at a tiny size, with the JAX
  script's keys and `device`; the configs equal the JAX script's.
- `profile_mcts_torch` prints every phase of `profile_mcts.py`.
- `scaling_bench_torch` on 1 and 2 gloo ranks: a row per size with
  `scaling_bench.py`'s keys, the global batch doubling with the ranks.
- `obs/card.device_label`, the card's label in every line.
"""

import ast
import importlib
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.runtime.dqn import DQNConfig as JDQNConfig
from tetris_mcts_tpu.runtime.selfplay import SelfPlayConfig as JSelfPlayConfig
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
import bench_torch
from tetris_mcts_tpu_torch.env import engine as TE
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from test_torch_reset import near_top_board
from torch_parity import JaxKeyPlanes, as_i32, port_vvmodel

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def script(name):
    """A module of scripts/ (the scripts are not a package)."""
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    return importlib.import_module(name)

SEED = 0
NET_TOL = {"value": dict(rtol=1e-4, atol=1e-3), "var": dict(rtol=1e-4, atol=1e-2)}


# ---------------------------------------------------------------------------
# bench_env
# ---------------------------------------------------------------------------

def jax_bench_env(batch, steps, reps, seed=SEED):
    """bench.py's `bench_env` (bench.py:44-81), returning the final states."""
    cfg = JE.EnvConfig()
    envs = JE.reset_batch(seed, batch, cfg)
    vreset = jax.vmap(lambda s: JE.soft_reset(s, cfg))

    def body(carry, _):
        s, key = carry
        key, sub = jax.random.split(key)
        a = jax.random.randint(sub, (batch,), 0, 7)
        s = JE.step_batch(s, a, cfg)
        fresh = vreset(s)
        s = jax.tree.map(
            lambda f, t: jnp.where(s.end.reshape((-1,) + (1,) * (f.ndim - 1)), f, t),
            fresh, s)
        return (s, key), None

    @jax.jit
    def run(envs, key):
        (envs, _), _ = jax.lax.scan(body, (envs, key), length=steps)
        return envs

    key = jax.random.PRNGKey(seed)
    for _ in range(1 + reps):  # the warm-up run, then the timed ones
        envs = run(envs, key)
    return envs


def jax_draws(batch, steps, seed=SEED):
    """The (steps, batch) actions of one bench.py env run."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (batch,), 0, 7)))
    return np.stack(out)


def test_bench_env_matches_bench_py():
    size = bench_torch.SIZES["cpu"]["env"]
    batch, steps, reps = size["batch"], size["steps"], size["reps"]
    draws = jax_draws(batch, steps)
    rate, envs = bench_torch.bench_env(batch, steps, reps, seed=SEED, device="cpu",
                                       actions=lambda i: torch.as_tensor(draws[i]))
    want = jax_bench_env(batch, steps, reps)
    np.testing.assert_array_equal(envs.numpy(), as_i32(JE.pack_state(want)))
    assert rate > 0
    # games ended on the way and were soft-reset: the same draws without the
    # reset end lanes (the port's engine, held to the JAX one in
    # test_torch_env.py), and no lane of the bench's final states is ended
    plain = TE.reset_batch(SEED, batch, device="cpu")
    for a in draws:
        plain = TE.step(plain, torch.as_tensor(a))
    assert int(plain.end.sum()) > batch // 4
    assert not (envs[:, 43] != 0).any()


# ---------------------------------------------------------------------------
# bench_mcts
# ---------------------------------------------------------------------------

class BenchKeyPlanes(JaxKeyPlanes):
    """bench.py's scan keys replayed for the port's move program: a run
    starts from PRNGKey(seed), each move takes `key, sub = split(key)`;
    the first simulation of each move advances the move (`next_move`)."""

    def __init__(self, seed, sims, moves):
        super().__init__(seed)
        self.seed, self.sims, self.moves, self.n = seed, sims, moves, 0
        self.subs = []

    def __call__(self, B_, D):
        if self.n % self.sims == 0:
            if self.n % (self.sims * self.moves) == 0:
                self.key = jax.random.PRNGKey(self.seed)
            self.subs.append(self.next_move())
        self.n += 1
        return super().__call__(B_, D)


_JAX_MOVE = {}


def jax_bench_move(sims):
    """The move program of bench.py:101-113 (float32 net), jitted once."""
    if sims not in _JAX_MOVE:
        cfg = JM.SearchConfig(
            tree=JT.TreeConfig(max_nodes=bench_torch.POOL, max_obs=bench_torch.POOL,
                               table_size=bench_torch.TABLE_SIZE,
                               max_depth=bench_torch.DEPTH,
                               insert_kernel=bench_torch.INSERT_KERNEL),
            sims=sims, evaluator="lp")
        model = JVVModel(seed=SEED)
        move = JM.make_move_fn(JM.nn_child_evaluator(model.apply_fn(jnp.float32)), cfg,
                               min_visits_store=bench_torch.MIN_VISITS_STORE)
        _JAX_MOVE[sims] = (jax.jit(move), cfg, model)
    return _JAX_MOVE[sims]


def near_topped_start(jcfg, batch, lane):
    """`init_batch(SEED)` of both packages with lane `lane` on a stack of 17
    rows, rows 4-19 full but for one hole each (tests/test_torch_reset.py's
    board), row 3 but for five cells: on the JAX keys its game ends on the
    third move (the first after the key's restart), when its tree holds
    obs of 25 visits or more."""
    rows = near_top_board(3)
    rows[3] = 0x3FF & ~(0x1F << 4)
    jtrees, jenvs = JM.init_batch(SEED, batch, jcfg)
    jenvs = jenvs._replace(rows=jenvs.rows.at[lane].set(rows))
    jtrees = jax.vmap(JT.init_tree, in_axes=(0, None))(jenvs, jcfg.tree)
    tenvs = torch.as_tensor(as_i32(JE.pack_state(jenvs)))
    return (jtrees, jenvs), lambda seed, b, cfg, device: (T.init_tree(tenvs, cfg.tree), tenvs)


@pytest.mark.parametrize("start", ["init_batch", "game_end"])
def test_bench_mcts_matches_bench_py(monkeypatch, start):
    monkeypatch.setattr(JW, "use_walk_kernels", lambda: True)
    monkeypatch.setenv("TMT_NN_F32", "1")
    size = bench_torch.SIZES["cpu"]["mcts"]
    batch, sims, moves = size["batch"], size["sims"], size["moves"]
    move_j, jcfg, model_j = jax_bench_move(sims)
    if start == "game_end":
        (jtrees, jenvs), port_init = near_topped_start(jcfg, batch, lane=4)
        monkeypatch.setattr(M, "init_batch", port_init)
    else:
        jtrees, jenvs = JM.init_batch(SEED, batch, jcfg)
    jrep = JM.init_replay(bench_torch.RING)
    planes = BenchKeyPlanes(SEED, sims, moves)
    seen = []

    def check(envs, stats, rep):
        nonlocal jtrees, jenvs, jrep
        jtrees, jenvs, jrep, jst = move_j(model_j.params, model_j.ubound, jtrees, jenvs,
                                          jrep, planes.subs[-1])
        mv = len(seen)
        np.testing.assert_array_equal(stats.action.numpy(), np.asarray(jst.action),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(envs.numpy(), as_i32(JE.pack_state(jenvs)),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(stats.n_nodes.numpy(), np.asarray(jst.n_nodes))
        np.testing.assert_array_equal(stats.lines.numpy(), np.asarray(jst.lines))
        for name in ("idx", "count", "total", "cand"):
            assert getattr(rep, name).item() == int(getattr(jrep, name)), f"{name} move {mv}"
        n = rep.count.item()
        boards, value, var, weight = (a[:n].numpy() for a in rep.rows())
        np.testing.assert_array_equal(boards, as_i32(jrep.boards[:n]))
        np.testing.assert_array_equal(weight, np.asarray(jrep.weight[:n]))
        np.testing.assert_allclose(value, np.asarray(jrep.value[:n]), **NET_TOL["value"])
        np.testing.assert_allclose(var, np.asarray(jrep.var[:n]), **NET_TOL["var"])
        seen.append((int(stats.done.sum()), n))

    best, rates = bench_torch.bench_mcts(batch, sims, moves, reps=1, seed=SEED,
                                         device="cpu", planes=planes,
                                         model=port_vvmodel(model_j), on_move=check)
    assert len(seen) == 2 * moves and len(rates) == 1 and best == rates[0] > 0
    if start == "game_end":
        # lane 4's game ended on move 3 and the ring took its rows
        assert seen == [(0, 0), (0, 0), (1, 2), (0, 2)], seen


def bench_py_keys():
    """The keys bench.py's main() can put in its line: those of its `out`
    dict literal and of every `out[...] = ` assignment."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "out" and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            elif (isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name)
                  and tgt.value.id == "out"):
                keys.add(tgt.slice.value)
    return keys


def test_bench_main_line_on_cpu(capsys):
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(bench_torch.LEFT_OUT) <= bench_py_keys()
    assert set(out) == bench_py_keys() - set(bench_torch.LEFT_OUT)
    assert out["device"] == "cpu" and out["metric"] == "mcts_sims_per_s"
    assert len(out["sims_per_s_reps"]) == bench_torch.SIZES["cpu"]["mcts"]["reps"]
    assert out["value"] == max(out["sims_per_s_reps"]) > 0 and out["env_steps_per_s"] > 0


# ---------------------------------------------------------------------------
# agent_bench, profile_mcts, scaling_bench
# ---------------------------------------------------------------------------

def returned_dict_keys(path, fn_name=None, var=None):
    """The keys of the dict literals a script returns from `fn_name`, or
    assigns to `var` (anywhere in the script)."""
    tree = ast.parse((ROOT / path).read_text())
    keys = set()
    for node in ast.walk(tree):
        if fn_name and isinstance(node, ast.FunctionDef) and node.name == fn_name:
            for n in ast.walk(node):
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
                    keys |= {k.value for k in n.value.keys}
        if (var and isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
    assert keys, (path, fn_name, var)
    return keys


def jax_agent_config(batch, sims, nodes, **kw):
    """agent_bench.py:36-41's SelfPlayConfig."""
    return JSelfPlayConfig(
        batch=batch, sims=sims, max_nodes=nodes, max_obs=nodes,
        table_size=max(1 << (2 * nodes - 1).bit_length(), 16),
        max_depth=64, min_visits_store=25, memory_size=100_000,
        train_rows_trigger=10**9, bf16=True, seed=0, **kw)


@pytest.mark.parametrize("nodes", [64, 2048, 3000])
def test_agent_bench_configs_match_jax(nodes):
    ab = script("agent_bench_torch")
    for kw in ({}, {"evaluator": "lp"}):
        got, want = ab.mcts_config(256, 100, nodes, **kw), jax_agent_config(256, 100, nodes, **kw)
        for name, value in want._asdict().items():
            assert getattr(got, name) == value, name
    for dist in (False, True):
        got = ab.dqn_config(1024, dist)
        want = JDQNConfig(batch=1024, seed=0, distributional=dist, memory_size=100_000)
        for name, value in want._asdict().items():
            assert getattr(got, name) == value, name


def test_agent_bench_rows_on_cpu(capsys):
    ab = script("agent_bench_torch")
    rows = ab.main(["--device", "cpu", "--agents", "vv,vp,dist,s2", "--batch", "2",
                    "--sims", "2", "--nodes", "64", "--moves", "1"])
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows
    assert [r["agent"] for r in rows] == ["ValueSimLP", "ApproxPolicyIter", "DistValueSim",
                                          "ValueSim2"]
    keys = returned_dict_keys("scripts/agent_bench.py", "bench_mcts_driver")
    for r in rows:
        assert set(r) == keys | {"device"} and r["device"] == "cpu"
        assert r["sims_per_s"] > 0 and (r["batch"], r["sims"], r["nodes"]) == (2, 2, 64)
    for name, dist in (("DQN", False), ("DistDQN", True)):
        row = ab.bench_dqn(name, dist, 8, 2, torch.device("cpu"))
        assert set(row) == returned_dict_keys("scripts/agent_bench.py", "bench_dqn") | {"device"}
        assert row["agent"] == name and row["env_steps_per_s"] > 0


def jax_profile_phases():
    """The phase names scripts/profile_mcts.py prints: its `timed` calls'
    and the residual's."""
    tree = ast.parse((ROOT / "scripts/profile_mcts.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "timed":
            names.append(node.args[0].value)
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if getattr(k, "value", None) == "phase" and isinstance(v, ast.Constant):
                    names.append(v.value)
    return names


def test_profile_mcts_prints_every_phase(capsys):
    pm = script("profile_mcts_torch")
    out = pm.main(["2", "64", "--sims", "2", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[0] == {"batch": 2, "sims": 2, "device": "cpu"}
    phases = [x["phase"] for x in lines if "phase" in x]
    assert sorted(phases) == sorted(jax_profile_phases()) == sorted(out)
    assert all(set(x) == {"phase", "total_s", "us_per_sim"} for x in lines if "phase" in x)
    assert [x for x in lines if "sims_per_s" in x][0]["sims_per_s"] > 0


def test_scaling_bench_weak_scaling_on_cpu_ranks(capsys, tmp_path):
    sb = script("scaling_bench_torch")
    out = tmp_path / "rows.jsonl"
    assert sb.main(["--device", "cpu", "--virtual", "2", "--sizes", "1,2,4",
                    "--batch_per_device", "2", "--env_batch_per_device", "8", "--sims", "2",
                    "--moves", "1", "--reps", "1", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [json.loads(x) for x in out.read_text().splitlines()] == lines
    row_keys = returned_dict_keys("scripts/scaling_bench.py", var="row")
    assert [r["devices"] for r in rows] == [1, 2]  # 4 ranks dropped: --virtual 2
    assert all(set(r) == row_keys for r in rows)
    assert all(r["virtual"] and r["platform"] == "cpu" for r in rows)
    assert rows[1]["batch"] == 2 * rows[0]["batch"] == 4  # weak scaling
    assert set(summary) == returned_dict_keys("scripts/scaling_bench.py", var="summary")
    assert summary["sizes"] == [1, 2] and summary["sims_efficiency"][0] == 1.0
    assert all(len(summary[k]) == 2 for k in ("sims_efficiency", "env_efficiency",
                                              "train_efficiency"))


def test_device_label(monkeypatch):
    """The label beside every number: "cpu" on the CPU; on a card
    nvidia-smi's line, or the card's name alone when nvidia-smi is missing."""
    from tetris_mcts_tpu_torch.obs import card

    assert card.device_label(torch.device("cpu")) == "cpu"
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(card.subprocess, "run", run)
    assert card.device_label(torch.device("cuda", 1)) == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert calls == [["nvidia-smi", "--id=1", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]]

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(card.subprocess, "run", missing)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    assert card.device_label(torch.device("cuda", 0)) == "card 0"


def test_entry_points_refuse_a_missing_card(capsys):
    """Without a card, --device cuda (the default) exits with an error and
    prints no result: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mains = [bench_torch.main] + [script(n).main for n in (
        "agent_bench_torch", "profile_mcts_torch", "scaling_bench_torch",
        "sweep_mcts_batch_torch")]
    for main in mains:
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 2
    assert capsys.readouterr().out == ""
