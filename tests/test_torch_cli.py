"""The port's `play` CLI and frozen-net driver on the CPU: a tiny run plays
whole episodes and logs them in the reference's "Episode:" format, for
every agent type the port runs; a reference flag or agent type the port
does not support is refused by name."""

import re

import pytest
import torch

from tetris_mcts_tpu_torch.cli import play

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


@pytest.mark.parametrize("flag", ["--online", "--checkpoint=x.msgpack"])
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
