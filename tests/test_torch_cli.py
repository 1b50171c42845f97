"""The port's `play` CLI and driver on the CPU: a tiny run plays whole
episodes and logs them in the reference's "Episode:" format, for every
agent type the port runs; a tiny online run of each training agent trains,
writes its checkpoint and metrics, and `--load_model` brings the net back;
a reference flag or agent type the port does not support is refused by
name."""

import re

import numpy as np
import pytest
import torch

from tetris_mcts_tpu_torch.cli import play
from tetris_mcts_tpu_torch.obs.metrics import MetricsReader

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--batch", "2", "--mcts_sims", "2", "--max_nodes", "64",
        "--max_obs", "64", "--max_depth", "6", "--seed", "3"]


def test_play_runs_episodes_on_cpu(capsys):
    driver = play.main(TINY + ["--ngames", "1", "--max_moves", "400"])
    err = capsys.readouterr().err
    assert driver.episodes >= 1
    assert driver.cfg.table_size == 128  # power of two, >= 2 x max_obs
    line = re.search(r"Episode:\s+1\s+Score:\s+(\d+)\s+Lines Cleared:\s+(\d+)", err)
    assert line, err[-2000:]
    assert driver.score_tracker.n == driver.episodes


@pytest.mark.parametrize("flag", ["--save", "--status_dir=x"])
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


@pytest.mark.parametrize("agent", ["ApproxPolicyIter", "HybridSim", "DQN"])
def test_play_refuses_unported_agent_types(agent, capsys):
    with pytest.raises(SystemExit) as exc:
        play.main(TINY + ["--agent_type", agent])
    assert exc.value.code == 2
    assert f"--agent_type {agent} is not ported" in capsys.readouterr().err


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
    blob = tmp_path / "model_vv.msgpack"
    blob.write_bytes(b"not a torch checkpoint")
    with pytest.raises(ValueError, match="params_from_jax and opt_state_from_jax"):
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
