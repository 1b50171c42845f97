"""The port's DQN agent (`runtime/dqn.py`, the DQN and DistDQN agents), its
nets and Adam against the JAX package's, on the CPU.

- `QNet` / `DistQNet` with the flax nets' weights carried by
  `qnet_params_from_jax` / `distqnet_params_from_jax`: outputs within rtol
  1e-4 / atol 1e-3.
- `Adam` over 12 updates against `optax.adam(1e-3)`: params and moments
  within rtol 1e-6 / atol 1e-7, count exact.
- The C51 projection (`c51_target`) against a jnp transcription of the
  reference's (`tetris_mcts_tpu/runtime/dqn.py` loss_fn), on rewards inside
  and past the support and on game ends: within rtol 1e-6 / atol 1e-7 (the
  bins that sum several atoms add them in another order), the bins of one
  term equal.
- 20 steps of `DQNDriver` against the JAX `DQNDriver` from the same weights
  (B=4, a ring of 48 rows that wraps, minibatch 8, target sync every 5),
  the port fed the draws of the JAX key chain, one lane started on a
  near-topped board so games end and the ring holds terminal transitions:
  the loss within rtol 1e-5, env states, episodes and the ring equal every
  step; params, the target net and the Adam moments within rtol 1e-4 /
  atol 1e-5 at the end (standard and C51).
- The target net is a copy: equal to the net right after a sync, unchanged
  by the updates until the next one.
- Benchmark mode: ε pinned to eps_final, nothing written to the ring, the
  net unchanged, and the moves equal to the JAX benchmark driver's.
- Checkpoints: the port's own round trip (and the other head refused), and
  a checkpoint that the JAX `DQNDriver.save` writes read without flax, its
  nets and Adam state equal to the JAX driver's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.models.nets import DistQNet as JDistQNet
from tetris_mcts_tpu.models.nets import QNet as JQNet
from tetris_mcts_tpu.runtime import dqn as JD
from tetris_mcts_tpu_torch.runtime import dqn as D
from tetris_mcts_tpu_torch.train.optim import Adam
from tetris_mcts_tpu_torch.train.trainer import (adam_opt_state_from_jax,
                                                 distqnet_params_from_jax,
                                                 qnet_params_from_jax)
from test_torch_reset import near_top_board
from torch_parity import as_i32

torch.set_num_threads(1)

NET_TOL = dict(rtol=1e-4, atol=1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
STEPS, ENDING_LANE = 20, 1
KW = dict(batch=4, memory_size=48, train_batch=8, target_update_steps=5, seed=2)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.mark.parametrize("dist", [False, True], ids=["qnet", "distqnet"])
def test_nets_match_flax(dist):
    jnet = JDistQNet(atoms=50) if dist else JQNet()
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, 20, 10, 1)))
    net = D.make_net(D.DQNConfig(distributional=dist))
    convert = distqnet_params_from_jax if dist else qnet_params_from_jax
    net.load_state_dict(convert(np_tree(params)))
    boards = np.random.RandomState(1).randint(-1, 2, (64, 20, 10)).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(boards)[..., None]))
    got = net(torch.as_tensor(boards)[:, None]).detach().numpy()
    assert got.shape == want.shape == ((64, 7, 50) if dist else (64, 7))
    np.testing.assert_allclose(got, want, **NET_TOL)


def test_adam_matches_optax():
    rng = np.random.RandomState(3)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    tx = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    opt = Adam(tp)
    for i in range(12):
        grads = [rng.normal(0, 3.0 * 0.5**i, s).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.as_tensor(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        for mine, theirs in ((opt.mu, state[0].mu), (opt.nu, state[0].nu)):
            for a, b in zip(mine, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == int(state[0].count) == 12


def jax_c51_target(pf, r, end, atoms, vmax, gamma):
    """The projection of the JAX `DQNDriver`'s loss_fn, transcribed."""
    TB = pf.shape[0]
    gamma = jnp.float32(gamma)
    delta = vmax / atoms
    centers = (jnp.arange(atoms, dtype=jnp.float32) + 0.5) * delta
    a_star = jnp.argmax(jnp.sum(pf * centers, axis=-1), axis=1)
    p_star = pf[jnp.arange(TB), a_star]
    z = r[:, None] + gamma * centers[None, :] * (~end)[:, None]
    b = jnp.clip(z / delta - 0.5, 0.0, atoms - 1.0)
    lo = jnp.floor(b).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, atoms - 1)
    w_hi = b - lo
    w_lo = 1.0 - w_hi
    mass = jnp.where(end[:, None], 0.0, p_star)
    rows = jnp.arange(TB)[:, None]
    y = jnp.zeros((TB, atoms)).at[rows, lo].add(mass * w_lo).at[rows, hi].add(mass * w_hi)
    r_bin = jnp.clip((r / delta).astype(jnp.int32), 0, atoms - 1)
    return jnp.where(end[:, None], jax.nn.one_hot(r_bin, atoms), y)


def test_c51_projection_matches_jax():
    cfg = D.DQNConfig(distributional=True)
    rng = np.random.RandomState(5)
    n = 64
    logits = rng.normal(0, 2, (n, 7, cfg.atoms)).astype(np.float32)
    pf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    # rewards of line clears, some past the support's top; a third ends
    r = (rng.choice([0, 0, 0, 100, 300, 500, 800, 1200, 3000], n)).astype(np.float32)
    end = rng.rand(n) < 0.3
    want = np.asarray(jax.jit(jax_c51_target, static_argnums=(3, 4, 5))(
        jnp.asarray(pf), jnp.asarray(r), jnp.asarray(end), cfg.atoms, cfg.vmax, cfg.gamma))
    got = D.c51_target(torch.as_tensor(pf), torch.as_tensor(r), torch.as_tensor(end),
                       cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[end], want[end])
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    assert (got[~end & (r > 2000), -1] > 0.5).all()  # the clipped top bin
    # away from the top bin each bin takes one lower and one upper share
    np.testing.assert_array_equal((got[:, :-1] > 0).sum(1)[~end & (r == 0)],
                                  (want[:, :-1] > 0).sum(1)[~end & (r == 0)])


class JaxDraws:
    """The draws of the JAX `DQNDriver.step` (per move `key, k_eps, k_act,
    k_batch = split(key, 4)` from PRNGKey(seed + 1)) as the port driver's
    `draws`."""

    def __init__(self, driver):
        self.d = driver
        self.key = jax.random.PRNGKey(driver.cfg.seed + 1)

    def __call__(self):
        cfg = self.d.cfg
        self.key, k_eps, k_act, k_batch = jax.random.split(self.key, 4)
        t = lambda x: torch.as_tensor(np.array(x))
        bidx = None
        if not cfg.benchmark:
            n = max(min(self.d.count + cfg.batch, cfg.memory_size), 1)
            bidx = t(jax.random.randint(k_batch, (cfg.train_batch,), 0, n)).long()
        return D.DQNDraws(t(jax.random.uniform(k_eps, (cfg.batch,))),
                          t(jax.random.randint(k_act, (cfg.batch,), 0, 7)), bidx)


def driver_pair(dist, benchmark=False, near_top=True):
    """The JAX driver and the port's on the CPU from the JAX driver's
    weights and Adam state, the port fed the JAX draws."""
    jd = JD.DQNDriver(JD.DQNConfig(distributional=dist, benchmark=benchmark, **KW),
                      log=lambda s: None)
    td = D.DQNDriver(D.DQNConfig(distributional=dist, benchmark=benchmark, **KW),
                     device="cpu", log=lambda s: None)
    td.net.load_state_dict(qnet_params_from_jax(np_tree(jd.params)))
    td.target.load_state_dict(qnet_params_from_jax(np_tree(jd.target_params)))
    mu, nu, count = adam_opt_state_from_jax(np_tree(jd.opt_state))
    td.opt.load([mu[n] for n in td.names], [nu[n] for n in td.names], count)
    if near_top:
        jd.envs = jd.envs._replace(rows=jd.envs.rows.at[ENDING_LANE].set(near_top_board(4)))
    td.envs = torch.as_tensor(as_i32(JE.pack_state(jd.envs)))
    td.draws = JaxDraws(td)
    return jd, td


def assert_state_close(td, jd):
    for name, want in (("net", jd.params), ("target", jd.target_params)):
        sd = qnet_params_from_jax(np_tree(want))
        for n, p in getattr(td, name).named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), sd[n].numpy(), err_msg=f"{name} {n}",
                                       **PARAM_TOL)
    mu, nu, count = adam_opt_state_from_jax(np_tree(jd.opt_state))
    for mine, theirs in ((td.opt.mu, mu), (td.opt.nu, nu)):
        for n, a in zip(td.names, mine):
            np.testing.assert_allclose(a.numpy(), theirs[n].numpy(), err_msg=n, **PARAM_TOL)
    assert td.opt.count == count


@pytest.mark.parametrize("dist", [False, True], ids=["dqn", "distdqn"])
def test_steps_match_jax(dist):
    jd, td = driver_pair(dist)
    ends, held_ends = 0, False
    for mv in range(STEPS):
        jst = jd.step()
        tst = td.step()
        np.testing.assert_array_equal(td.envs.numpy(), as_i32(JE.pack_state(jd.envs)),
                                      err_msg=f"move {mv}")
        np.testing.assert_array_equal(tst.done.numpy(), np.asarray(jst["done"]))
        np.testing.assert_allclose(tst.loss.numpy(), np.asarray(jst["loss"]), rtol=1e-5,
                                   err_msg=f"move {mv}")
        jr, tr = jd.replay, td.replay
        for name, a, b in (("si", tr.si, as_i32(jr.si)), ("a", tr.a, jr.a), ("r", tr.r, jr.r),
                           ("sf", tr.sf, as_i32(jr.sf)), ("end", tr.end, jr.end),
                           ("idx", tr.idx, jr.idx), ("count", tr.count, jr.count)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} {mv}")
        assert td.count == int(jr.count) and td.eps == jd.eps
        ends += int(tst.done.sum())
        held_ends = held_ends or bool(tr.end.any())
    assert td.episodes == jd.episodes == ends >= 1 and held_ends
    assert td.updates == jd.updates == STEPS and td.count == KW["memory_size"]
    assert_state_close(td, jd)


def test_target_net_is_a_copy_synced_every_target_update_steps():
    td = D.DQNDriver(D.DQNConfig(**KW), device="cpu", log=lambda s: None)
    params = lambda net: [p.detach().clone() for p in net.parameters()]
    first = params(td.target)
    td.run(KW["target_update_steps"] - 1)
    assert all(torch.equal(a, b) for a, b in zip(params(td.target), first))
    assert not all(torch.equal(a, b) for a, b in zip(params(td.net), first))
    td.step()  # the sync
    synced = params(td.target)
    assert all(torch.equal(a, b) for a, b in zip(synced, params(td.net)))
    td.run(3)
    assert all(torch.equal(a, b) for a, b in zip(params(td.target), synced))
    assert not all(torch.equal(a, b) for a, b in zip(params(td.net), synced))


def test_benchmark_mode_plays_greedy_without_training():
    jd, td = driver_pair(False, benchmark=True, near_top=False)
    before = [p.detach().clone() for p in td.net.parameters()]
    for mv in range(8):
        jd.step()
        tst = td.step()
        np.testing.assert_array_equal(td.envs.numpy(), as_i32(JE.pack_state(jd.envs)),
                                      err_msg=f"move {mv}")
        assert float(tst.loss) == 0.0
    assert td.eps == jd.eps == td.cfg.eps_final
    assert int(td.replay.count) == int(td.replay.idx) == td.count == 0
    assert not bool(td.replay.si.any()) and td.opt.count == 0
    assert all(torch.equal(a, b) for a, b in zip(td.net.parameters(), before))


def test_checkpoint_round_trip_and_the_jax_checkpoint(tmp_path):
    td = D.DQNDriver(D.DQNConfig(**KW), device="cpu", log=lambda s: None)
    td.run(6)
    path = str(tmp_path / "dqn.pt")
    td.save(path)
    back = D.DQNDriver(D.DQNConfig(**{**KW, "seed": 9}), device="cpu", log=lambda s: None)
    assert back.load(path)
    for name in ("net", "target"):
        for a, b in zip(getattr(td, name).parameters(), getattr(back, name).parameters()):
            assert torch.equal(a, b)
    assert back.opt.count == td.opt.count == 6
    other = D.DQNDriver(D.DQNConfig(distributional=True, **KW), device="cpu",
                        log=lambda s: None)
    with pytest.raises(ValueError, match="Q head of 7 outputs"):
        other.load(path)
    assert not back.load(str(tmp_path / "missing.pt"))

    # a checkpoint of the JAX package, written by its DQNDriver on the CPU
    jd = JD.DQNDriver(JD.DQNConfig(distributional=True, **KW), log=lambda s: None)
    jd.run(7)  # a target sync, then updates past it: target and net differ
    jpath = str(tmp_path / "dqn.msgpack")
    jd.save(jpath)
    assert other.load(jpath)
    assert other.opt.count == 7
    assert_state_close(other, jd)
    for name, want in (("net", jd.params), ("target", jd.target_params)):
        sd = qnet_params_from_jax(np_tree(want))
        for n, p in getattr(other, name).named_parameters():
            assert torch.equal(p.detach(), sd[n]), (name, n)
    # the port's VV checkpoint is not a DQN one
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    VVModel(device="cpu").save(str(tmp_path / "vv.pt"))
    with pytest.raises(ValueError, match="another of the port's nets"):
        back.load(str(tmp_path / "vv.pt"))
