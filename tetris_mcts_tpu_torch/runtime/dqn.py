"""Batched DQN agent (counterpart of the reference package's `runtime/dqn.py`,
the reference's self-contained DQN agent): B envs step in lockstep, and a
move is one step of the whole agent: ε-greedy act, env step, transition
write, a uniform minibatch, one TD (or C51) update with Adam
(`train/optim.Adam`, lr 1e-3).

The reference's semantics:

- one update a move once the ring holds a transition;
- ε anneals linearly from eps_init to eps_final with the ring's fill;
- the target net is a copy of the net, made at the start and every
  `target_update_steps` updates (the reference's `target_params = params`
  is a snapshot because JAX arrays are immutable; here the optimizer
  updates the net in place, so the target must be a copy);
- standard head (`QNet`): y = r + γ max_a Q_target(s', a) (γ·0 past a
  game's end), smooth-L1 of Q(s, a) against it;
- C51 head (`DistQNet`, `atoms` bins on [0, vmax]): the target net's
  distribution of its greedy action, moved to r + γ z and projected onto
  the bins (a point mass on the bin of r past a game's end), cross-entropy
  of the net's distribution of a against it;
- benchmark mode writes nothing to the ring, does not train and pins ε to
  eps_final.

Boards are the engine's 20x10; transitions are stored packed (int32 bit
patterns of the u32 rows, as the search's rings).

Draws are inputs of `dqn_step` (`DQNDraws`): the ε uniforms (B,), the
random actions (B,) and the minibatch's ring rows (train_batch,), drawn
from the rows held after the move's write. `DQNDriver.draws` takes them
from a torch.Generator on the driver's device seeded from seed + 1; a test
can replace it with the reference's key chain.

The C51 projection, the same on the card and the CPU: each bin sums its
terms in `search/distributional.bin_sums`'s fixed order (several atoms
land in one bin, and every atom past vmax in the top one); the bin
position z / Δ - 0.5 is fma(z, 1/Δ, -0.5), as XLA computes the
reference's (the float64 product and difference, rounded once), and the
bin of r is trunc(r · 1/Δ); the greedy action's expectation sums over the
atoms in `distributional.pairwise_sum`'s order.

Checkpoints: `save` writes `torch.save` of both nets and the Adam state
(default `train/trainer.DQN_DEFAULT_CKPT`); `load` reads it back, or a DQN
checkpoint of the JAX package (a pickle of flax bytes of params,
target_params and opt_state, read by `train/flax_msgpack.py`).
"""

from __future__ import annotations

import os
import sys
import zipfile
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tetris_mcts_tpu_torch.env import engine
from tetris_mcts_tpu_torch.env.engine import EnvConfig
from tetris_mcts_tpu_torch.models.nets import DistQNet, QNet, tf32_off
from tetris_mcts_tpu_torch.ops import env_packed as EP
from tetris_mcts_tpu_torch.runtime import watchdog
from tetris_mcts_tpu_torch.search import distributional as DD
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.train.optim import Adam
from tetris_mcts_tpu_torch.train.trainer import (DQN_DEFAULT_CKPT, _read_jax, _save_torch,
                                                 adam_opt_state_from_jax, qnet_params_from_jax)

N_ACTIONS = T.N_ACTIONS


class DQNConfig(NamedTuple):
    batch: int = 64                 # envs in lockstep
    memory_size: int = 100_000
    gamma: float = 0.99
    eps_init: float = 1.0
    eps_final: float = 0.01
    train_batch: int = 32
    target_update_steps: int = 100
    distributional: bool = False
    atoms: int = 50
    vmax: float = 2500.0
    lr: float = 1e-3
    seed: int = 0
    benchmark: bool = False         # greedy play: no training, no ring writes,
                                    # eps pinned to eps_final
    actions_per_drop: int = 1
    scoring: int = 0
    randomizer: int = 0


@dataclass
class DQNReplay:
    """The transition ring: (s, a, r, s', end), boards packed."""

    capacity: int
    si: torch.Tensor     # int32 (R, 20) board before the move
    a: torch.Tensor      # int32 (R,)
    r: torch.Tensor      # float32 (R,) score gained
    sf: torch.Tensor     # int32 (R, 20) board after the move
    end: torch.Tensor    # bool (R,)
    idx: torch.Tensor    # int32 () next write slot
    count: torch.Tensor  # int32 () rows held

    def arrays(self):
        return self.si, self.a, self.r, self.sf, self.end


def init_dqn_replay(capacity: int, device="cuda") -> DQNReplay:
    z = lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt, device=device)
    return DQNReplay(capacity, z(capacity, 20), z(capacity), z(capacity, dt=torch.float32),
                     z(capacity, 20), z(capacity, dt=torch.bool), z(()), z(()))


class DQNDraws(NamedTuple):
    explore: torch.Tensor        # float32 (B,) uniforms: a lane explores where < ε
    rand_a: torch.Tensor         # (B,) the exploring lanes' actions
    bidx: torch.Tensor | None    # (train_batch,) the minibatch's ring rows; None
                                 # in benchmark mode


class DQNStats(NamedTuple):
    action: torch.Tensor   # int32 (B,)
    loss: torch.Tensor     # float32 () the update's loss (0 in benchmark mode)
    done: torch.Tensor     # bool (B,) episode ended on this move
    score: torch.Tensor    # (B,) score after the move
    lines: torch.Tensor


def make_net(cfg: DQNConfig, seed: int = 0):
    return DistQNet(cfg.atoms, seed=seed) if cfg.distributional else QNet(seed=seed)


def _imgs(packed):
    return engine.unpack_obs(packed)[:, None].float()


def _centers(cfg: DQNConfig, device):
    return DD.centers(DD.DistConfig(atoms=cfg.atoms, vmax=cfg.vmax), device)


def q_values(net, packed, cfg: DQNConfig):
    """(n, 7) action values of packed boards (n, 20): the net's, or the
    expectation of its distributions over the bin centers."""
    out = net(_imgs(packed))
    if cfg.distributional:
        return DD.pairwise_sum(out * _centers(cfg, out.device))
    return out


def c51_target(pf, r, end, cfg: DQNConfig):
    """The projected target distributions (TB, atoms) from the target net's
    distributions pf (TB, 7, atoms), rewards r (TB,) and ends (TB,)."""
    TB, _, atoms = pf.shape
    c = _centers(cfg, pf.device)
    p_star = pf[torch.arange(TB, device=pf.device), T.first_max(DD.pairwise_sum(pf * c))]
    z = r[:, None] + (c * float(np.float32(cfg.gamma)))[None, :] * (~end).float()[:, None]
    inv_delta = float(np.float32(1.0) / np.float32(cfg.vmax / atoms))
    b = (z.double() * inv_delta - 0.5).float().clamp(0.0, atoms - 1.0)
    lo = torch.floor(b)
    w_hi = b - lo
    lo = lo.long()
    mass = torch.where(end[:, None], 0.0, p_star)
    y = DD.bin_sums(torch.cat([mass * (1.0 - w_hi), mass * w_hi], 1),
                    torch.cat([lo, (lo + 1).clamp_max(atoms - 1)], 1), atoms)
    r_bin = (r * inv_delta).to(torch.int32).clamp(0, atoms - 1).long()
    return torch.where(end[:, None], F.one_hot(r_bin, atoms).float(), y)


def dqn_loss(net, target_net, batch, cfg: DQNConfig):
    """The minibatch loss: smooth-L1 TD error (standard) or the C51
    cross-entropy; batch = (si, a, r, sf, end) rows of the ring."""
    si, a, r, sf, end = batch
    rows = torch.arange(a.shape[0], device=a.device)
    a = a.long()
    pred = net(_imgs(si))[rows, a]
    with torch.no_grad():
        out_f = target_net(_imgs(sf))
        if cfg.distributional:
            y = c51_target(out_f, r, end, cfg)
        else:
            y = r + (out_f.amax(1) * float(np.float32(cfg.gamma))) * (~end).float()
    if cfg.distributional:
        return -(y * torch.log(pred.clamp_min(1e-12))).sum(-1).mean()
    diff = (pred - y).abs()
    return torch.where(diff < 1.0, 0.5 * (diff * diff), diff - 0.5).mean()


def dqn_step(net, target_net, opt: Adam, envs, replay: DQNReplay, eps: float,
             draws: DQNDraws, cfg: DQNConfig):
    """One move of the agent for every env (the reference's jitted `step`):
    returns (envs after the move, soft-reset where the game ended, DQNStats).
    The ring, the net and the optimizer are updated in place."""
    B = envs.shape[0]
    env_kw = dict(actions_per_drop=cfg.actions_per_drop, scoring=cfg.scoring,
                  randomizer=cfg.randomizer)
    packed_i = EP.packed_obs(envs)
    with torch.no_grad():
        greedy = T.first_max(q_values(net, packed_i, cfg))
    explore = draws.explore < float(np.float32(eps))
    action = torch.where(explore, draws.rand_a.long(), greedy).to(torch.int32)
    envs2 = EP.packed_step(envs, action, **env_kw)
    reward = (envs2[:, 36] - envs[:, 36]).float()
    done = envs2[:, 43] != 0
    loss = torch.zeros((), device=envs.device)
    if not cfg.benchmark:
        R = replay.capacity
        dst = (replay.idx + torch.arange(B, device=envs.device)) % R
        for tbl, val in zip(replay.arrays(),
                            (packed_i, action, reward, EP.packed_obs(envs2), done)):
            tbl[dst] = val
        replay.idx.copy_((replay.idx + B) % R)
        replay.count.copy_(torch.clamp_max(replay.count + B, R))
        params = list(net.parameters())
        with tf32_off():
            loss = dqn_loss(net, target_net, tuple(x[draws.bidx] for x in replay.arrays()),
                            cfg)
            grads = torch.autograd.grad(loss, params)
        opt.step(grads)
        loss = loss.detach()
    env_cfg = EnvConfig(**env_kw)
    fresh = engine.pack_state(engine.soft_reset(engine.unpack_state(envs2), env_cfg))
    return torch.where(done[:, None], fresh, envs2), DQNStats(
        action=action, loss=loss, done=done, score=envs2[:, 36], lines=envs2[:, 38])


class DQNDriver:
    """Owns the net, its target copy, the Adam state, the ring and the B
    envs on `device` (weights made from cfg.seed); `step()` / `run(n)`
    advance the agent. Each move reads one small tensor back (the games'
    done, score and lines) for the episode lines and metrics events; an
    installed stall watchdog is beaten every move and every log line."""

    def __init__(self, cfg: DQNConfig, device="cuda",
                 log=lambda s: print(s, file=sys.stderr, flush=True), metrics=None,
                 checkpoint_path: str = DQN_DEFAULT_CKPT):
        if not cfg.benchmark and cfg.batch > cfg.memory_size:
            raise ValueError(f"batch {cfg.batch} exceeds the replay capacity "
                             f"{cfg.memory_size}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._watchdog = watchdog.get_active()
        if self._watchdog is not None:
            log = self._watchdog.wrap_log(log)
        self.log = log
        self.metrics = metrics
        self.checkpoint_path = checkpoint_path
        self.net = make_net(cfg, cfg.seed).to(self.device)
        self.target = make_net(cfg, cfg.seed).to(self.device)
        self.sync_target()
        self.names = [n for n, _ in self.net.named_parameters()]
        self.opt = Adam(self.net.parameters(), lr=cfg.lr)
        env_cfg = EnvConfig(actions_per_drop=cfg.actions_per_drop, scoring=cfg.scoring,
                            randomizer=cfg.randomizer)
        self.envs = engine.pack_state(engine.reset_batch(cfg.seed, cfg.batch, env_cfg,
                                                         self.device))
        self.replay = init_dqn_replay(cfg.memory_size, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(cfg.seed + 1)
        self.count = 0  # the ring's rows, as the host tracks them
        self.updates = self.episodes = self.moves = 0
        self.last_stats = None

    @property
    def eps(self):
        if self.cfg.benchmark:
            return self.cfg.eps_final
        frac = min(self.count / self.cfg.memory_size, 1.0)
        return self.cfg.eps_init + (self.cfg.eps_final - self.cfg.eps_init) * frac

    def sync_target(self):
        with torch.no_grad():
            for t, p in zip(self.target.parameters(), self.net.parameters()):
                t.copy_(p)

    def draws(self) -> DQNDraws:
        """The move's draws; the minibatch from the rows the ring holds after
        the move's write."""
        cfg, B, dev = self.cfg, self.cfg.batch, self.device
        u = torch.rand(B, generator=self.gen, device=dev)
        rand_a = torch.randint(0, N_ACTIONS, (B,), generator=self.gen, device=dev)
        bidx = None
        if not cfg.benchmark:
            n = max(min(self.count + B, cfg.memory_size), 1)
            bidx = torch.randint(0, n, (cfg.train_batch,), generator=self.gen, device=dev)
        return DQNDraws(u, rand_a, bidx)

    def step(self):
        cfg = self.cfg
        self.envs, stats = dqn_step(self.net, self.target, self.opt, self.envs, self.replay,
                                    self.eps, self.draws(), cfg)
        if not cfg.benchmark:
            self.count = min(self.count + cfg.batch, cfg.memory_size)
        self.moves += 1
        if self._watchdog is not None:
            self._watchdog.beat()
        self.updates += 1
        if self.updates % cfg.target_update_steps == 0:
            self.sync_target()
        self.last_stats = stats
        host = torch.stack([stats.done.long(), stats.score.long(), stats.lines.long()]).cpu()
        done, scores, lines = host.numpy()
        for i in np.nonzero(done)[0]:
            self.episodes += 1
            self.log(f"Episode:{self.episodes:6d}  Score:{int(scores[i]):10d}  "
                     f"Lines Cleared:{int(lines[i]):5d}  eps:{self.eps:5.3f}")
            if self.metrics is not None:
                self.metrics.write("episode", n=self.episodes, lines=int(lines[i]),
                                   score=int(scores[i]), eps=self.eps)
        return stats

    def run(self, n_moves: int):
        for _ in range(n_moves):
            self.step()

    # --------------------------------------------------------- persistence
    def save(self, path: str | None = None, verbose: bool = False):
        """Write both nets and the Adam state to `path` (`torch.save`, through
        a temporary file); refuses to overwrite a file that is not a
        checkpoint of the port."""
        mu, nu, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        _save_torch(path or self.checkpoint_path,
                    {"dqn_net": cpu(self.net.parameters()),
                     "dqn_target": cpu(self.target.parameters()), "adam_mu": cpu(mu),
                     "adam_nu": cpu(nu), "adam_count": count,
                     "distributional": self.cfg.distributional}, verbose)

    def load(self, path: str | None = None) -> bool:
        """Read a checkpoint written by `save`, or a DQN checkpoint of the JAX
        package (converted). Returns False when the file does not exist;
        raises for a checkpoint of another net, or of the other head."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        if not zipfile.is_zipfile(path):
            blob = _read_jax(path, "dqn")
            net = qnet_params_from_jax(blob["params"])
            target = qnet_params_from_jax(blob.get("target_params", blob["params"]))
            mu, nu, count = adam_opt_state_from_jax(blob["opt_state"])
        else:
            blob = torch.load(path, map_location=self.device, weights_only=True)
            if "dqn_net" not in blob:
                raise ValueError(f"{path} is a checkpoint of another of the port's nets, not "
                                 "of a DQN net")
            net, target = blob["dqn_net"], blob["dqn_target"]
            mu, nu, count = blob["adam_mu"], blob["adam_nu"], blob["adam_count"]
        want = self.net.fc_q.weight.shape
        if tuple(net["fc_q.weight"].shape) != tuple(want):
            raise ValueError(f"{path} holds a Q head of {net['fc_q.weight'].shape[0]} outputs, "
                             f"this agent's has {want[0]}")
        self.net.load_state_dict(net)
        self.target.load_state_dict(target)
        self.opt.load([mu[n] for n in self.names], [nu[n] for n in self.names], count)
        return True
