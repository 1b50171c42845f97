"""The port's `play`, `train` and `cycle` CLIs and the drivers on the CPU:
a tiny run plays whole episodes and logs them in the reference's
"Episode:" format, for every agent type the port runs; a tiny online run
of each training agent trains, writes its checkpoint and metrics, and
`--load_model` brings the net back; a reference flag the port does not
support is refused by name. The channels and modes of `play`
(`--printboard` and `--interactive` against the JAX package's output,
`--endless`, `--low`, `--save_tree`, `--trace`), `train` on saved rows,
the `cycle` plan against the JAX package's, and one real cycle iteration.
The VP-net agents: ApproxPolicyIter frozen and online (a session, its
checkpoint, reloaded), HybridSim, FiniteSim and FullSim, `train --model vp`
on rows an ApproxPolicyIter run saved, and the VP cycle's plan.
DistValueSim: frozen and online (a session, its checkpoint, reloaded),
`train --model dist` on saved rows against the JAX package's Gaussian
targets, and the dist cycle's plan against the JAX package's. ValueSim2:
a frozen run (its `--save_tree` refused with the reference's message) and
its cycle plan against the JAX package's. DQN and DistDQN: a run that
trains every move, logs episodes with ε, writes its checkpoint and metrics
and reloads them; a `--benchmark --load_model` run that saves nothing; a
`--trace` run; and `cycle`'s refusal of both, in the JAX package's words
and exit code.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tetris_mcts_tpu_torch.cli import play
from tetris_mcts_tpu_torch.obs.metrics import MetricsReader

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--batch", "2", "--mcts_sims", "2", "--max_nodes", "64",
        "--max_obs", "64", "--max_depth", "6", "--seed", "3"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_play_runs_episodes_on_cpu(capsys):
    driver = play.main(TINY + ["--ngames", "1", "--max_moves", "400"])
    err = capsys.readouterr().err
    assert driver.episodes >= 1
    assert driver.cfg.table_size == 128  # power of two, >= 2 x max_obs
    line = re.search(r"Episode:\s+1\s+Score:\s+(\d+)\s+Lines Cleared:\s+(\d+)", err)
    assert line, err[-2000:]
    assert driver.score_tracker.n == driver.episodes


@pytest.mark.parametrize("flag", ["--ensemble=2"])
def test_play_refuses_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        play.main(TINY + [flag])
    assert exc.value.code == 2
    assert flag.split("=")[0] in capsys.readouterr().err


# agent type -> (evaluator, sims of a --mcts_sims 2 run, low, policy), the
# reference CLI's rules
AGENTS = {
    "ValueSim": ("leaf", 2, 1, "clt"),
    "ValueSimOnline": ("leaf", 2, 1, "clt"),
    "ValueSimBayes": ("leaf", 2, 10, "bayes"),
    "Vanilla": ("rollout", 2, 5, "clt"),
    "VanillaC": ("rollout", 2, 5, "clt"),
    "Random": ("rollout", 1, 1, "clt"),
}


@pytest.mark.parametrize("agent", AGENTS)
def test_play_agent_runs_a_game_on_cpu(agent, capsys):
    driver = play.main(TINY + ["--agent_type", agent, "--ngames", "1",
                               "--max_moves", "400"])
    err = capsys.readouterr().err
    evaluator, sims, low, policy = AGENTS[agent]
    assert (driver.cfg.evaluator, driver.cfg.sims, driver.cfg.low,
            driver.cfg.policy) == (evaluator, sims, low, policy)
    assert driver.episodes >= 1
    assert re.search(r"Episode:\s+1\s+Score:\s+\d+\s+Lines Cleared:\s+\d+", err)


ONLINE = ["--online", "--min_visits", "1", "--memory_size", "512", "--memory_growth", "64",
          "--train_rows", "64", "--train_batch", "16", "--train_iters_per_val", "5",
          "--train_max_iters", "10", "--ngames", "1", "--max_moves", "60"]


@pytest.mark.parametrize("agent", ["ValueSimLP", "ValueSim"])
def test_play_online_trains_and_reloads_on_cpu(agent, tmp_path, capsys):
    ckpt, metrics = str(tmp_path / "ck" / "model.pt"), str(tmp_path / "m.jsonl")
    driver = play.main(TINY + ONLINE + ["--agent_type", agent, "--checkpoint", ckpt,
                                        "--metrics", metrics])
    err = capsys.readouterr().err
    assert not driver.cfg.benchmark and driver.cfg.checkpoint_each_train
    assert driver.n_trains >= 1 and "Training session 1: " in err
    reader = MetricsReader(metrics)
    reader.poll()
    sessions = reader.of_kind("train_session")
    assert len(sessions) == driver.n_trains and sessions[0]["iters"] == 10
    # the search reads the trained net: its bounds were rescaled to the data
    assert float(driver.model.ubound[0]) != 100.0
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (16, 1, 20, 10)),
                             dtype=torch.float32)
    again = play.main(TINY + ["--agent_type", agent, "--checkpoint", ckpt, "--load_model",
                              "--ngames", "0"])
    assert again.cfg.benchmark  # no --online: the loaded net only plays
    for a, b in zip(driver.model.apply_fn()(boards), again.model.apply_fn()(boards)):
        assert torch.equal(a, b)
    assert again.model.opt.count == driver.model.opt.count > 0


def test_play_load_model_names_the_converter_for_a_jax_checkpoint(tmp_path):
    """--load_model reads the JAX package's checkpoint (the repo's VV net),
    and names both formats for a file that is neither."""
    ckpt = os.path.join(ROOT, "checkpoints", "model_vv.msgpack")
    driver = play.main(TINY + ["--checkpoint", ckpt, "--load_model", "--ngames", "0"])
    assert torch.equal(driver.model.ubound, torch.tensor([100.0, 1000.0]))
    fresh = play.main(TINY + ["--ngames", "0"]).model.net.conv1.weight
    assert not torch.equal(driver.model.net.conv1.weight, fresh)
    blob = tmp_path / "model_vv.msgpack"
    blob.write_bytes(b"not a torch checkpoint")
    with pytest.raises(ValueError, match="neither a checkpoint of the port .* nor one of "
                                         "the JAX package"):
        play.main(TINY + ["--checkpoint", str(blob), "--load_model"])


def test_play_online_benchmark_channel_and_acc_policy(tmp_path):
    """acc_policy 0 with episode reuse trains on the episode gate and
    clears the ring after each session; the benchmark channel plays its
    rounds on a twin driver that shares the model and stores nothing, and
    writes `benchmark` events."""
    metrics = str(tmp_path / "m.jsonl")
    driver = play.main(TINY + ONLINE[:-4] + [
        "--ngames", "2", "--max_moves", "400", "--acc_policy", "0",
        "--episodes_per_train", "1", "--episode_reuse", "--checkpoint",
        str(tmp_path / "ck.pt"), "--metrics", metrics, "--benchmark_every", "1",
        "--benchmark_games", "1", "--benchmark_sims", "2", "--benchmark_batch", "1",
        "--benchmark_max_moves", "300", "--benchmark_max_nodes", "64"])
    assert driver.cfg.acc_policy == 0 and driver.cfg.episode_reuse
    assert driver.n_trains >= 1 and driver._mem_rows < driver.replay.total.item()
    twin = driver._bench
    assert driver._bench_round >= 1 and twin is not None and twin.cfg.benchmark
    assert twin.model is driver.model and twin.replay.total.item() == 0
    reader = MetricsReader(metrics)
    reader.poll()
    bench = reader.of_kind("benchmark")
    assert len(bench) == driver._bench_round and bench[0]["games"] == 1
    assert len(reader.of_kind("train_session")) == driver.n_trains


# ---------------------------------------------------------------------------
# play's channels and modes
# ---------------------------------------------------------------------------

def test_printboard_prints_the_jax_render_of_the_pre_move_board(tmp_path, capsys):
    from tetris_mcts_tpu.cli.replay import render as jax_render
    from tetris_mcts_tpu_torch.utils.data import DataLoader

    play.main(TINY + ["--printboard", "--save", "--save_dir", str(tmp_path), "--ngames", "1",
                      "--max_moves", "3"])
    out = capsys.readouterr().out
    rows = DataLoader(str(tmp_path / "data0.rec"))
    want = "".join(jax_render(rows.board[i], int(rows.score[i]), int(rows.lines[i]),
                              int(rows.combo[i])) + "\n" for i in range(0, 6, 2))
    assert out == want


def test_interactive_plays_from_stdin_as_jax(monkeypatch, capsys):
    from tetris_mcts_tpu.cli import play as jax_play

    def player():
        """An out-of-range action, three moves, then hard drops until the
        game ends; "y" to "Play more?", then a word that is not an action,
        which ends the loop on the second game's first board."""
        said = {"more": False, "moves": 0}
        script = ["9", "1", "5", "3"]

        def answer(prompt=""):
            if prompt.startswith("Play more"):
                said["more"] = True
                return "y"
            if said["more"]:
                return "x"
            said["moves"] += 1
            return script[said["moves"] - 1] if said["moves"] <= len(script) else "6"
        return answer

    outs = []
    for main in (lambda: play.main(["--interactive", "--device", "cpu", "--seed", "3"]),
                 lambda: jax_play.interactive_loop(
                     jax_play.build_parser().parse_args(["--interactive", "--seed", "3"]))):
        monkeypatch.setattr("builtins.input", player())
        assert main() == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].count("Game over") == 1
    assert outs[0].split("Game over")[1].count("score 0   lines 0") == 1  # a new game


def test_endless_runs_until_interrupted_then_saves(tmp_path, monkeypatch, capsys):
    from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayDriver
    from tetris_mcts_tpu_torch.utils.data import DataLoader

    step = SelfPlayDriver.step
    calls = []

    def interrupted_step(self):
        calls.append(1)
        if len(calls) == 4:
            raise KeyboardInterrupt
        return step(self)

    monkeypatch.setattr(SelfPlayDriver, "step", interrupted_step)
    ckpt = tmp_path / "ck.pt"
    driver = play.main(TINY + ONLINE[:-4] + ["--endless", "--ngames", "0", "--save",
                                             "--save_dir", str(tmp_path), "--checkpoint",
                                             str(ckpt)])
    assert driver.moves == 3 and "interrupted" in capsys.readouterr().err
    assert ckpt.is_file()  # the final save ran
    assert len(DataLoader(str(tmp_path / "data0.rec"))) == 3 * 2


@pytest.mark.parametrize("agent", ["ValueSim", "Vanilla", "ValueSimBayes"])
def test_low_overrides_the_agent_default(agent):
    driver = play.main(TINY + ["--agent_type", agent, "--low", "3", "--ngames", "0"])
    assert driver.cfg.low == 3


def test_value_sim_c_runs_the_lp_evaluator_and_trains(tmp_path):
    driver = play.main(TINY + ONLINE + ["--agent_type", "ValueSimC", "--checkpoint",
                                        str(tmp_path / "ck.pt")])
    assert driver.cfg.evaluator == "lp" and not driver.cfg.benchmark
    assert driver.n_trains >= 1 and (tmp_path / "ck.pt").is_file()


def test_save_tree_dumps_the_trees(tmp_path):
    driver = play.main(TINY + ["--save_tree", "--save_dir", str(tmp_path), "--cycle", "4",
                               "--ngames", "1", "--max_moves", "2"])
    dump = np.load(tmp_path / "tree4.npz")
    n = len(dump["game"])
    assert n > 0 and dump["board"].shape == (n, 20, 10) and dump["board"].dtype == np.int8
    assert set(dump["game"].tolist()) <= {0, 1} and (dump["visit"] >= 1).all()
    from tetris_mcts_tpu_torch.search import tree as T

    assert n == int(T.harvest(driver.trees, 1)[4].sum())


def test_trace_writes_a_chrome_trace_and_no_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / "ck.pt"
    driver = play.main(TINY + ONLINE + ["--trace", str(tmp_path / "tr"), "--trace_moves", "2",
                                        "--checkpoint", str(ckpt)])
    assert driver.moves == 4  # 2 warm-up moves, then the 2 traced
    trace = tmp_path / "tr" / "trace.json"
    assert trace.is_file() and '"traceEvents"' in trace.read_text()
    assert not ckpt.exists()
    assert "Trace of 2 moves written" in capsys.readouterr().err


def test_stall_watchdog_is_on_by_default_and_stopped_after(monkeypatch):
    from tetris_mcts_tpu_torch.runtime import watchdog

    seen, stop = [], watchdog.StallWatchdog.stop
    monkeypatch.setattr(watchdog.StallWatchdog, "stop", lambda self: (
        seen.append((self.stall_timeout, self.startup_timeout)), stop(self)))
    driver = play.main(TINY + ["--ngames", "0"])
    assert seen == [(900.0, 3600.0)] and watchdog.get_active() is None
    assert driver._watchdog is not None
    assert play.main(TINY + ["--ngames", "0", "--stall_timeout", "0"])._watchdog is None


# ---------------------------------------------------------------------------
# train and cycle
# ---------------------------------------------------------------------------

def test_train_on_saved_rows_then_play_the_trained_net(tmp_path, capsys):
    from tetris_mcts_tpu_torch.cli import train
    from tetris_mcts_tpu_torch.utils.data import LossLoader

    play.main(TINY + ["--batch", "4", "--save", "--save_dir", str(tmp_path / "data"),
                      "--ngames", "50", "--max_moves", "10"])
    ckpt = str(tmp_path / "ck" / "m.pt")
    hist = train.main(["--device", "cpu", "--data", str(tmp_path / "data" / "data*.rec"),
                       "--td", "--weighted", "--weighted_mode", "1", "--early_stopping",
                       "--validation", "--iters_per_val", "5", "--max_iters", "20",
                       "--batch_size", "8", "--save_loss", str(tmp_path / "loss"),
                       "--checkpoint", ckpt, "--dump_dir", str(tmp_path / "dump")])
    out = capsys.readouterr().out
    assert "Loaded 40 rows from 1 file(s)" in out and "Saving model..." in out
    loss = LossLoader(str(tmp_path / "loss" / "loss0.rec"))
    assert loss.n == len(hist) and list(loss.iteration) == [h[0] for h in hist]
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (8, 1, 20, 10)),
                             dtype=torch.float32)
    seed_net = play.main(TINY + ["--ngames", "0"]).model.apply_fn()(boards)
    trained = play.main(TINY + ["--ngames", "0", "--load_model", "--checkpoint", ckpt])
    assert not torch.equal(trained.model.apply_fn()(boards)[0], seed_net[0])


@pytest.mark.parametrize("flag", ["--ensemble=2"])
def test_train_refuses_unported_models(flag, capsys):
    from tetris_mcts_tpu_torch.cli import train

    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", flag])
    assert exc.value.code == 2
    assert f"{flag.replace('=', ' ')} is not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["play", "train", "cycle"])
def test_cuda_default_refused_without_a_card(cmd, monkeypatch, capsys):
    from tetris_mcts_tpu_torch.cli import cycle, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        {"play": play.main, "train": train.main, "cycle": cycle.main}[cmd]([])
    assert exc.value.code == 2 and "no CUDA device" in capsys.readouterr().err


def normalised_plan(text):
    """A cycle plan's commands, the port's names mapped to the JAX
    package's: module, file suffix, quoting and the --device flag."""
    text = text.replace("tetris_mcts_tpu_torch.", "tetris_mcts_tpu.").replace(".rec", ".h5")
    text = text.replace("'", "")  # the port quotes a glob for the shell
    return [ln.replace(" --device cpu", "") for ln in text.splitlines()]


@pytest.mark.parametrize("data", [False, True], ids=["fresh", "with_data"])
def test_cycle_dry_run_plan_matches_jax(tmp_path, capsys, data):
    from tetris_mcts_tpu.cli import cycle as jax_cycle
    from tetris_mcts_tpu_torch.cli import cycle

    args = ["--iters", "2", "--n_workers", "2", "--dry_run", "--checkpoint", "ck", "--resume"]
    plans = []
    for main, suffix, extra in ((cycle.main, ".rec", ["--device", "cpu"]),
                                (jax_cycle.main, ".h5", [])):
        d = tmp_path / suffix[1:]
        if data:  # cycle 0 saved: the plan resumes at cycle 1, with training
            (d / "self0").mkdir(parents=True)
            (d / "self0" / f"data0{suffix}").touch()
        main(args + extra + ["--data_dir", str(d)])
        plans.append(normalised_plan(capsys.readouterr().out.replace(str(d), "D")))
    assert plans[0] == plans[1]
    assert sum("cli.play" in ln for ln in plans[0]) == (3 if data else 6)
    assert any("cli.train" in ln for ln in plans[0]) == data


def test_cycle_runs_one_iteration_on_cpu(tmp_path):
    """One real iteration (cycle 1, resumed after a saved cycle 0): train on
    the saved rows, one self-play run that saves, one benchmark run."""
    from tetris_mcts_tpu_torch.cli import cycle
    from tetris_mcts_tpu_torch.utils.data import DataLoader, LossLoader

    data = tmp_path / "data"
    play.main(TINY + ["--batch", "4", "--save", "--save_dir", str(data / "self0"),
                      "--ngames", "50", "--max_moves", "6"])
    assert cycle.last_cycle(str(data)) == 0
    ckpt = tmp_path / "ck.pt"
    res = subprocess.run(
        [sys.executable, "-m", "tetris_mcts_tpu_torch", "cycle", "--device", "cpu",
         "--resume", "--iters", "2", "--data_dir", str(data), "--batch", "2",
         "--train_sims", "2", "--bench_sims", "2", "--bench_games", "1", "--ngames", "50",
         "--checkpoint", str(ckpt),
         "--train_args", "--iters_per_val 5 --max_iters 10 --batch_size 8 --dump_dir "
         + str(tmp_path / "dump"),
         "--play_args", "--max_nodes 64 --max_obs 64 --max_depth 6 --max_moves 4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "=== cycle 1 ===" in res.stdout and "=== cycle 0 ===" not in res.stdout
    assert ckpt.is_file() and LossLoader(str(data / "loss" / "loss1.rec")).n >= 1
    assert len(DataLoader(str(data / "self0" / "data1.rec"))) == 4 * 2
    assert cycle.last_cycle(str(data)) == 1
    assert (data / "bench_metrics.jsonl").is_file()


# ---------------------------------------------------------------------------
# the VP-net agents
# ---------------------------------------------------------------------------

# VP-net agent -> (evaluator, playout steps at most: the agent's depth, FullSim's
# cut to 40 by --rollout_depth here)
VP_AGENTS = {"ApproxPolicyIter": ("vp", None), "HybridSim": ("hybrid", 30),
             "FiniteSim": ("finite", 50), "FullSim": ("full", 40)}


@pytest.mark.parametrize("agent", VP_AGENTS)
def test_play_vp_agent_runs_on_cpu(agent):
    from tetris_mcts_tpu_torch.runtime.selfplay import VPSelfPlayDriver
    from tetris_mcts_tpu_torch.train.trainer import VP_DEFAULT_CKPT, VPModel

    evaluator, depth = VP_AGENTS[agent]
    cut = ["--rollout_depth", "40"] if agent == "FullSim" else []
    driver = play.main(TINY + ["--agent_type", agent, "--ngames", "1", "--max_moves", "3"]
                       + cut)
    assert isinstance(driver.model, VPModel) and driver.cfg.benchmark
    assert driver.model.checkpoint_path == VP_DEFAULT_CKPT
    assert driver.moves == 3 and driver.cfg.evaluator == evaluator
    if agent == "ApproxPolicyIter":
        assert isinstance(driver, VPSelfPlayDriver)
        probs = driver.last_stats.probs  # the root improvement policy
        assert torch.allclose(probs.sum(1), torch.ones(2)) and float(probs.max()) > 1 / 7
    else:
        assert 0 < driver.evaluator.steps <= depth
        # the playouts' variance (1e3) was backed up to the root's children
        assert float(driver.last_stats.child_stats[:, 2].max()) > 100.0


def test_play_vp_online_trains_and_reloads_on_cpu(tmp_path, capsys):
    ckpt, metrics = str(tmp_path / "ck" / "vp.pt"), str(tmp_path / "m.jsonl")
    driver = play.main(TINY + ONLINE + ["--agent_type", "ApproxPolicyIter", "--checkpoint",
                                        ckpt, "--metrics", metrics])
    err = capsys.readouterr().err
    assert not driver.cfg.benchmark and driver.cfg.checkpoint_each_train
    assert driver.n_trains >= 1 and "Training session 1: " in err
    reader = MetricsReader(metrics)
    reader.poll()
    sessions = reader.of_kind("train_session")
    assert len(sessions) == driver.n_trains and sessions[0]["iters"] == 10
    assert sessions[0]["grad_norm"] is None  # the VP session logs no grad norm
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (16, 1, 20, 10)),
                             dtype=torch.float32)
    again = play.main(TINY + ["--agent_type", "ApproxPolicyIter", "--checkpoint", ckpt,
                              "--load_model", "--ngames", "0"])
    assert again.cfg.benchmark
    for a, b in zip(driver.model.apply_fn()(boards), again.model.apply_fn()(boards)):
        assert torch.equal(a, b)
    assert again.model.opt.count == driver.model.opt.count > 0


def test_train_vp_on_rows_saved_by_approx_policy_iter(tmp_path, capsys):
    from tetris_mcts_tpu_torch.cli import train
    from tetris_mcts_tpu_torch.utils.data import DataLoader

    play.main(TINY + ["--agent_type", "ApproxPolicyIter", "--batch", "4", "--save",
                      "--save_dir", str(tmp_path / "data"), "--ngames", "50",
                      "--max_moves", "10"])
    rows = DataLoader(str(tmp_path / "data" / "data0.rec"))
    assert len(rows) == 40 and not rows.child_stats.any() and not rows.variance.any()
    np.testing.assert_allclose(rows.policy.sum(1), 1.0, rtol=1e-6)
    ckpt = str(tmp_path / "ck" / "vp.pt")
    hist = train.main(["--device", "cpu", "--model", "vp", "--data",
                       str(tmp_path / "data" / "data*.rec"), "--td", "--weighted",
                       "--weighted_mode", "1", "--early_stopping", "--validation",
                       "--iters_per_val", "5", "--max_iters", "20", "--batch_size", "8",
                       "--checkpoint", ckpt, "--ewc"])
    out = capsys.readouterr().out
    assert "--ewc applies to the vv model only; ignored" in out and "Saving model..." in out
    assert len(hist[0]) == 4 and hist[-1][0] <= 20
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (8, 1, 20, 10)),
                             dtype=torch.float32)
    base = ["--agent_type", "HybridSim", "--ngames", "0"]
    seed_net = play.main(TINY + base).model.apply_fn()(boards)
    trained = play.main(TINY + base + ["--load_model", "--checkpoint", ckpt])
    assert trained.model.opt.count == hist[-1][0]
    assert not torch.equal(trained.model.apply_fn()(boards)[1], seed_net[1])


def test_cycle_dry_run_trains_the_vp_net_for_the_vp_agents(tmp_path, capsys):
    from tetris_mcts_tpu_torch.cli import cycle

    (tmp_path / "self0").mkdir()
    (tmp_path / "self0" / "data0.rec").touch()
    cycle.main(["--agent_type", "ApproxPolicyIter", "--iters", "1", "--dry_run",
                "--data_dir", str(tmp_path), "--device", "cpu"])
    plan = capsys.readouterr().out
    train_cmd = [ln for ln in plan.splitlines() if "cli.train" in ln]
    assert len(train_cmd) == 1 and "--model vp" in train_cmd[0]
    cycle.main(["--agent_type", "ValueSimLP", "--iters", "1", "--dry_run", "--data_dir",
                str(tmp_path), "--device", "cpu"])
    assert "--model vv" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# DistValueSim
# ---------------------------------------------------------------------------

def test_play_dist_value_sim_runs_on_cpu():
    from tetris_mcts_tpu_torch.runtime.selfplay import DistSelfPlayDriver
    from tetris_mcts_tpu_torch.train.trainer import DIST_DEFAULT_CKPT, DistModel

    driver = play.main(TINY + ["--agent_type", "DistValueSim", "--ngames", "1",
                               "--max_moves", "3"])
    assert isinstance(driver, DistSelfPlayDriver) and isinstance(driver.model, DistModel)
    assert driver.model.checkpoint_path == DIST_DEFAULT_CKPT and driver.cfg.benchmark
    assert (driver.cfg.low, driver.dcfg) == (5, (50, 1000.0, 5))
    assert driver.moves == 3 and int(driver.replay.total) == 0
    probs = driver.last_stats.probs  # visit-proportional
    assert torch.allclose(probs.sum(1), torch.ones(2))


def test_play_dist_online_trains_and_reloads_on_cpu(tmp_path, capsys):
    ckpt, metrics = str(tmp_path / "ck" / "dist.pt"), str(tmp_path / "m.jsonl")
    driver = play.main(TINY + ONLINE + ["--agent_type", "DistValueSim", "--checkpoint", ckpt,
                                        "--metrics", metrics])
    err = capsys.readouterr().err
    assert not driver.cfg.benchmark and driver.cfg.checkpoint_each_train
    assert driver.n_trains >= 1 and "Training session 1: " in err
    reader = MetricsReader(metrics)
    reader.poll()
    sessions = reader.of_kind("train_session")
    assert len(sessions) == driver.n_trains and sessions[0]["iters"] == 10
    assert sessions[0]["grad_norm"] is None  # no grad-norm watch, as the reference
    n = int(driver.replay.count)
    np.testing.assert_allclose(driver.replay.dist[:n].sum(1).numpy(), 1.0, rtol=1e-5)
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (16, 1, 20, 10)),
                             dtype=torch.float32)
    again = play.main(TINY + ["--agent_type", "DistValueSim", "--checkpoint", ckpt,
                              "--load_model", "--ngames", "0"])
    assert again.cfg.benchmark
    assert torch.equal(driver.model.apply_fn()(boards), again.model.apply_fn()(boards))
    assert again.model.opt.count == driver.model.opt.count > 0


def test_train_dist_on_saved_rows_matches_the_jax_targets(tmp_path, capsys):
    from tetris_mcts_tpu.cli.train import gaussian_dist_targets as jax_targets
    from tetris_mcts_tpu_torch.cli import train
    from tetris_mcts_tpu_torch.utils.data import DataLoader

    play.main(TINY + ["--batch", "4", "--save", "--save_dir", str(tmp_path / "data"),
                      "--ngames", "50", "--max_moves", "10"])
    rows = DataLoader(str(tmp_path / "data" / "data0.rec"))
    _, value, variance, _ = train.build_targets(rows, True, True, 1)
    got = train.gaussian_dist_targets(value, variance, 16, 200.0)
    np.testing.assert_array_equal(got, jax_targets(value, variance, 16, 200.0))
    assert got.shape == (40, 16) and float(got.max()) > 0.2
    ckpt = str(tmp_path / "ck" / "dist.pt")
    hist = train.main(["--device", "cpu", "--model", "dist", "--atoms", "16", "--vmax", "200",
                       "--data", str(tmp_path / "data" / "data*.rec"), "--td", "--weighted",
                       "--weighted_mode", "1", "--early_stopping", "--validation",
                       "--iters_per_val", "5", "--max_iters", "20", "--batch_size", "8",
                       "--checkpoint", ckpt, "--loss_type", "mae"])
    out = capsys.readouterr().out
    assert "--loss_type applies to the vv model only; ignored" in out
    assert "Saving model..." in out and len(hist[0]) == 4 and hist[-1][0] <= 20
    from tetris_mcts_tpu_torch.train.trainer import DistModel

    m = DistModel(16, device="cpu", checkpoint_path=ckpt)
    assert m.load() and m.opt.count == hist[-1][0]
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (8, 1, 20, 10)),
                             dtype=torch.float32)
    assert not torch.equal(m.apply_fn()(boards), DistModel(16, device="cpu").apply_fn()(boards))


def test_cycle_dry_run_plan_for_dist_value_sim_matches_jax(tmp_path, capsys):
    from tetris_mcts_tpu.cli import cycle as jax_cycle
    from tetris_mcts_tpu_torch.cli import cycle

    plans = []
    for main, suffix, extra in ((cycle.main, ".rec", ["--device", "cpu"]),
                                (jax_cycle.main, ".h5", [])):
        d = tmp_path / suffix[1:]
        (d / "self0").mkdir(parents=True)
        (d / "self0" / f"data0{suffix}").touch()
        main(["--agent_type", "DistValueSim", "--iters", "1", "--dry_run", "--checkpoint",
              "ck", "--data_dir", str(d)] + extra)
        plans.append(normalised_plan(capsys.readouterr().out.replace(str(d), "D")))
    assert plans[0] == plans[1]
    train_cmd = [ln for ln in plans[0] if "cli.train" in ln]
    assert len(train_cmd) == 1 and "--model dist" in train_cmd[0]


# ---------------------------------------------------------------------------
# ValueSim2
# ---------------------------------------------------------------------------

def test_play_value_sim2_runs_on_cpu(tmp_path, capsys):
    from tetris_mcts_tpu_torch.runtime.selfplay import S2SelfPlayDriver
    from tetris_mcts_tpu_torch.train.trainer import DEFAULT_CKPT, VVModel

    driver = play.main(TINY + ["--agent_type", "ValueSim2", "--ngames", "1", "--max_moves",
                               "4", "--online", "--save_tree", "--save_dir",
                               str(tmp_path)])
    err = capsys.readouterr().err
    assert isinstance(driver, S2SelfPlayDriver) and isinstance(driver.model, VVModel)
    assert driver.model.checkpoint_path == DEFAULT_CKPT
    assert driver.cfg.benchmark and not driver.cfg.checkpoint_each_train  # never trains
    assert driver.moves == 4 and int(driver.replay.total) == 0
    assert "--save_tree: only VV-tree agents store (value, variance) per observation; " \
           "ignored" in err and not os.listdir(tmp_path)
    assert torch.allclose(driver.last_stats.probs.sum(1), torch.ones(2))
    assert int(driver.s2trees.edge_count.sum()) > 0  # edges recorded


def test_cycle_dry_run_plan_for_value_sim2_matches_jax(tmp_path, capsys):
    from tetris_mcts_tpu.cli import cycle as jax_cycle
    from tetris_mcts_tpu_torch.cli import cycle

    plans = []
    for main, suffix, extra in ((cycle.main, ".rec", ["--device", "cpu"]),
                                (jax_cycle.main, ".h5", [])):
        d = tmp_path / suffix[1:]
        (d / "self0").mkdir(parents=True)
        (d / "self0" / f"data0{suffix}").touch()
        main(["--agent_type", "ValueSim2", "--iters", "1", "--dry_run", "--checkpoint", "ck",
              "--data_dir", str(d)] + extra)
        plans.append(normalised_plan(capsys.readouterr().out.replace(str(d), "D")))
    assert plans[0] == plans[1]
    assert sum("--agent_type ValueSim2" in ln for ln in plans[0]) == 2
    assert any("cli.train" in ln and "--model vv" in ln for ln in plans[0])


# ---------------------------------------------------------------------------
# DQN and DistDQN
# ---------------------------------------------------------------------------

DQN_TINY = ["--device", "cpu", "--batch", "4", "--memory_size", "256", "--seed", "3"]


@pytest.mark.parametrize("agent", ["DQN", "DistDQN"])
def test_play_dqn_trains_saves_and_reloads_on_cpu(agent, tmp_path, capsys):
    from tetris_mcts_tpu_torch.runtime.dqn import DQNDriver

    ckpt, metrics = str(tmp_path / "ck" / "dqn.pt"), str(tmp_path / "m.jsonl")
    driver = play.main(DQN_TINY + ["--agent_type", agent, "--ngames", "1", "--max_moves",
                                   "400", "--checkpoint", ckpt, "--metrics", metrics,
                                   "--save"])
    cap = capsys.readouterr()
    assert isinstance(driver, DQNDriver) and driver.cfg.distributional == (agent == "DistDQN")
    assert "--save/--status_dir are not supported for DQN agents" in cap.err
    assert driver.episodes >= 1 and driver.updates == driver.moves == driver.opt.count
    line = re.search(r"Episode:\s+1\s+Score:\s+\d+\s+Lines Cleared:\s+\d+\s+eps:(\S+)",
                     cap.err)
    assert line and 0.01 <= float(line.group(1)) < 1.0
    assert "Saving model..." in cap.out and os.path.isfile(ckpt)
    reader = MetricsReader(metrics)
    reader.poll()
    eps = reader.of_kind("episode")
    assert len(eps) == driver.episodes and "eps" in eps[0]
    boards = torch.as_tensor(np.random.RandomState(0).randint(-1, 2, (16, 1, 20, 10)),
                             dtype=torch.float32)
    again = play.main(DQN_TINY + ["--agent_type", agent, "--checkpoint", ckpt,
                                  "--load_model", "--benchmark", "--ngames", "0"])
    assert again.cfg.benchmark and again.eps == again.cfg.eps_final
    assert torch.equal(driver.net(boards), again.net(boards))
    assert again.opt.count == driver.opt.count


def test_play_dqn_benchmark_and_trace_save_nothing(tmp_path, capsys):
    ckpt = tmp_path / "dqn.pt"
    driver = play.main(DQN_TINY + ["--agent_type", "DQN", "--benchmark", "--ngames", "1",
                                   "--max_moves", "20", "--checkpoint", str(ckpt)])
    assert driver.episodes >= 1 and driver.moves <= 20  # greedy: games end soon
    assert driver.count == 0 and driver.opt.count == 0
    assert int(driver.replay.count) == 0 and not ckpt.exists()
    trace = tmp_path / "trace"
    play.main(DQN_TINY + ["--agent_type", "DistDQN", "--trace", str(trace), "--trace_moves",
                          "2", "--checkpoint", str(ckpt)])
    assert (trace / "trace.json").is_file() and not ckpt.exists()
    assert "Trace of 2 moves written to" in capsys.readouterr().err


@pytest.mark.parametrize("agent", ["DQN", "DistDQN"])
def test_cycle_refuses_dqn_agents_as_jax(agent, tmp_path, capsys):
    from tetris_mcts_tpu.cli import cycle as jax_cycle
    from tetris_mcts_tpu_torch.cli import cycle

    out = []
    for main, extra in ((cycle.main, ["--device", "cpu"]), (jax_cycle.main, [])):
        rc = main(["--agent_type", agent, "--iters", "1", "--dry_run", "--data_dir",
                   str(tmp_path / "d")] + extra)
        out.append((rc, capsys.readouterr()))
    (rc_t, cap_t), (rc_j, cap_j) = out
    assert rc_t == rc_j == 2 and cap_t.err == cap_j.err
    assert "DQN agents train online per step" in cap_t.err and "===" not in cap_t.out
