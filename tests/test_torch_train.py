"""The port's VV training against the JAX package's, on the CPU: the VV
losses, Yogi, `train_step` (with and without the EWC penalty), a whole
`train_data` session (same index schedule, same stop iteration), the
output-bound rescale and its floor after a load, the zero-gradient guard,
the grad-norm watchdog's dump, `compute_fisher`, and checkpoints (the
port's own round trip; the repo's JAX checkpoint carried over with
`params_from_jax` + `opt_state_from_jax`).

Inputs are made from a seed with numpy. Tolerances, measured on this data:
the losses rtol 1e-6 / atol 1e-6; Yogi rtol 1e-6 / atol 1e-7 on params,
mu and nu (count exact); a train step's loss and grad norm rtol 1e-5, the
params after 1 and after 20 steps rtol 1e-4 / atol 1e-5 (largest seen
2.1e-6 abs after 20 steps); the net's outputs rtol 1e-4 / atol 1e-3 value,
1e-2 variance (tests/test_ops.py's VV-net bounds); the Fisher rtol 1e-3 /
atol 1e-9 (a square of a per-example gradient).
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.models import losses as JL
from tetris_mcts_tpu.train import optim as JO
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.train.optim import Yogi
from tetris_mcts_tpu_torch.train.trainer import (VVModel, _state_from_flax,
                                                 opt_state_from_jax, params_from_jax)
from torch_train_cases import agreeing_minibatch, min_nonzero_preactivation

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "model_vv.msgpack")
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


class JaxIndexSource:
    """The JAX trainer's minibatch key chain: the session seed -> PRNGKey,
    then per step `key, sub = split(key)`, `randint(sub, (bs,), 0, n)`."""

    def __init__(self):
        self.drawn = []

    def start(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n, bs):
        self.key, sub = jax.random.split(self.key)
        idx = np.array(jax.random.randint(sub, (bs,), 0, n))
        self.drawn.append(idx)
        return torch.as_tensor(idx)


def columns(n, seed=0, vmax=50.0):
    rng = np.random.RandomState(seed)
    return [rng.randint(-1, 2, (n, 20, 10)).astype(np.int8),
            rng.uniform(0, vmax, n).astype(np.float32),
            rng.uniform(0, 30, n).astype(np.float32),
            rng.uniform(1, 5, n).astype(np.float32)]


def port_of(jm, seed=3, **kw):
    m = VVModel(seed=seed, device="cpu", **kw)
    m.load_state(*params_from_jax(jax.tree.map(np.asarray, jm.params), jm.ubound, jm.lbound))
    return m


def assert_params_close(m, jparams, **tol):
    want = _state_from_flax(jax.tree.map(np.asarray, jparams))
    for k, v in m.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **(tol or PARAM_TOL))


def as_jax(cols):
    return (jnp.asarray(cols[0], jnp.float32)[..., None], *(jnp.asarray(c) for c in cols[1:]))


def as_port(cols):
    return (torch.as_tensor(cols[0]).float()[:, None], *(torch.as_tensor(c) for c in cols[1:]))


@pytest.mark.parametrize("kind", ["kldiv", "mle", "weak", "mle_approx", "mae", "mse"])
def test_vv_losses_match_jax(kind):
    rng = np.random.RandomState(1)
    vp, v = (rng.uniform(0.1, 40, 256).astype(np.float32) for _ in range(2))
    mp, m = (rng.uniform(0, 80, 256).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.vv_loss(kind)(*map(jnp.asarray, (vp, mp, v, m))))
    got = L.vv_loss(kind)(*map(torch.as_tensor, (vp, mp, v, m))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_yogi_matches_optax_over_20_updates():
    rng = np.random.RandomState(0)
    shapes = [(32, 1, 3, 3), (32,), (256, 1792 // 64), (2,)]
    ps = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = JO.yogi()
    jp = [jnp.asarray(x) for x in ps]
    st = tx.init(jp)
    tp = [torch.tensor(x) for x in ps]
    opt = Yogi(tp)
    for _ in range(20):
        # gradients over five decades, so nu both grows and shrinks
        gs = [(rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32) for s in shapes]
        upd, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = [a + b for a, b in zip(jp, upd)]
        opt.step([torch.tensor(g) for g in gs])
    adam = st[1][0]
    for got, want in zip(tp + opt.mu + opt.nu, jp + list(adam.mu) + list(adam.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert opt.count == int(adam.count) == 20


@pytest.mark.parametrize("ewc", [False, True])
def test_train_step_matches_jax(ewc):
    """1 and 20 steps on the minibatches JAX drew; with `ewc` a non-zero
    lambda, a random Fisher and an anchor p0 away from the params."""
    jm = JVVModel(seed=3)
    m = port_of(jm)
    cols = columns(64)
    jd, td = as_jax(cols), as_port(cols)
    lam = 0.7 if ewc else 0.0
    fisher, p0 = jm.fisher, jm.p0
    if ewc:
        rng = np.random.RandomState(5)
        leaves, tdef = jax.tree.flatten(jm.params)
        fisher = jax.tree.unflatten(tdef, [jnp.asarray(rng.uniform(0, 2, l.shape), jnp.float32)
                                           for l in leaves])
        p0 = jax.tree.unflatten(tdef, [l + jnp.asarray(rng.normal(0, 0.05, l.shape), jnp.float32)
                                       for l in leaves])
        m.fisher = _state_from_flax(jax.tree.map(np.asarray, fisher))
        m.p0 = _state_from_flax(jax.tree.map(np.asarray, p0))
    key = jax.random.PRNGKey(1)
    params, opt = jm.params, jm.opt_state
    for step in range(20):
        key, sub = jax.random.split(key)
        params, opt, met, _ = jm._train_step(params, opt, jm.ubound, jd, sub, fisher, p0,
                                             jnp.float32(lam), 16)
        idx = torch.as_tensor(np.array(jax.random.randint(sub, (16,), 0, 64)))
        loss, per, gnorm = m.train_step(td, idx, lam)
        for got, want in ((loss, met["loss"]), (per.std(correction=0), met["loss_std"]),
                          (gnorm, met["grad_norm"])):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        if step in (0, 19):
            assert_params_close(m, params)
    assert m.opt.count == int(opt[1][0].count) == 20


def test_train_step_backward_runs_without_tf32(monkeypatch):
    """A train step keeps cuDNN's and cuBLAS's TF32 off through its
    backward, which autograd runs after the forward's own `tf32_off` block
    has exited, and restores both settings after. A pass-through autograd
    node behind every conv and linear output records the flags when its
    backward runs, just before that op's own backward."""
    seen = []

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return g

    F = torch.nn.functional
    for name in ("conv2d", "linear"):
        op = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _op=op, **k: Spy.apply(_op(*a, **k)))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    m = VVModel(seed=1, device="cpu")
    m.train_step(as_port(columns(16)), torch.arange(8))
    assert seen == [(False, False)] * 5  # three convs, two linears
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_agreeing_minibatch_rejects_draws_whose_relus_differ():
    """The card-vs-CPU train-step checks pick their minibatch with
    `agreeing_minibatch`. Here `other` is the same net with conv1's
    channel-0 bias of opposite sign (+-1e-3): on the all-empty board that
    channel's ReLU input is the bias alone at each of its 18 x 8 places,
    so the board crosses over; on the all-locked board it is the weights'
    sum plus the bias, far from 0, so no conv1 input crosses there."""
    net = VVModel(seed=2, device="cpu").net
    other = copy.deepcopy(net)
    with torch.no_grad():
        net.conv1.bias[0], other.conv1.bias[0] = 1e-3, -1e-3
    assert abs(float(net.conv1.weight[0].detach().sum())) > 1e-2
    empty, locked = torch.zeros(1, 1, 20, 10), torch.ones(1, 1, 20, 10)
    states = torch.cat([empty, locked])
    idx, draws, crossed = agreeing_minibatch(net, copy.deepcopy(net), states, 4)
    assert (draws, crossed) == (1, 0)
    idx, draws, crossed = agreeing_minibatch(net, other, states, 1, seed=3)
    assert idx.tolist() == [1] and draws > 1 and crossed >= 18 * 8 * (draws - 1)
    with pytest.raises(AssertionError, match="no minibatch of 64 draws"):
        agreeing_minibatch(net, other, empty, 1)


def test_train_data_session_matches_jax(tmp_path):
    """A whole session (shuffle, rescale, early stopping, best-params
    restore, the grad-norm watchdog) with the same index schedule: the same
    stop iteration and best window, the history within tolerance, the
    restored params and the bounds equal, and the watchdog's dump holds the
    same rows."""
    jm = JVVModel(seed=3)
    m = port_of(jm, seed=3, index_source=JaxIndexSource())
    cols = columns(160, seed=3)
    args = dict(batch_size=16, iters_per_val=10, max_iters=300, shuffle=True,
                early_stopping_patience=2, early_stopping_threshold=0.0,
                grad_norm_warn=30.0)
    jlog, plog = [], []
    jh = jm.train_data(cols, log=jlog.append, dump_dir=str(tmp_path / "j"), **args)
    ph = m.train_data(cols, log=plog.append, dump_dir=str(tmp_path / "p"), **args)
    assert [h[0] for h in ph] == [h[0] for h in jh]
    assert ph[-1][0] < 300, "early stopping never fired"
    np.testing.assert_allclose(np.array(ph)[:, 1:], np.array(jh)[:, 1:], rtol=1e-4, atol=1e-5)
    # the best window (its "*") is the same, so the same params come back
    stars = lambda log: [ln.endswith("*") for ln in log if ln.startswith("Iteration")]
    assert stars(plog) == stars(jlog) and not stars(plog)[-1]
    assert_params_close(m, jm.params)
    np.testing.assert_array_equal(m.ubound.numpy(), np.asarray(jm.ubound))

    warn = lambda log: [ln for ln in log if ln.startswith("Large gradient")]
    assert len(warn(plog)) == len(warn(jlog)) > 0
    want = np.load(tmp_path / "j" / "dump_grad.npz")
    got = np.load(tmp_path / "p" / "dump_grad.npz")
    np.testing.assert_array_equal(got["states"], want["states"])
    for k in ("value", "variance"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-6)
    np.testing.assert_allclose(got["pred_value"], want["pred_value"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["pred_variance"], want["pred_variance"], rtol=1e-4,
                               atol=1e-2)


def test_zero_gradient_guard_ends_the_session(tmp_path):
    """Output heads saturated on every row (sigmoid == 1.0 exactly): the
    first window's gradients are all zero and the session ends there, in
    both packages."""
    jm = JVVModel(seed=2)
    params = jax.tree.map(lambda x: x, jm.params)
    params["params"]["fc_out"]["bias"] = jnp.full(2, 1e3, jnp.float32)
    jm.params = params
    m = port_of(jm, seed=2)
    cols = columns(64, seed=2)
    args = dict(batch_size=16, iters_per_val=5, max_iters=100)
    jlog, plog = [], []
    jh = jm.train_data(cols, log=jlog.append, dump_dir=str(tmp_path / "j"), **args)
    ph = m.train_data(cols, log=plog.append, dump_dir=str(tmp_path / "p"), **args)
    assert len(ph) == len(jh) == 1 and ph[0][4] == jh[0][4] == 0.0
    assert plog[-1].startswith("Zero-gradient window at iteration 5")
    assert jlog[-1].startswith("Zero-gradient window at iteration 5")


def test_ubound_rescale_and_floor_after_load(tmp_path):
    """A fresh net rescales ubound to the data's max either way; after a
    load the rescale never goes below the loaded bounds, and a raised bound
    becomes the new floor."""
    jm = JVVModel(seed=1)
    assert jm.load(CKPT)
    m = port_of(jm, seed=1)
    m.load_opt_state(*opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    path = str(tmp_path / "m.pt")
    m.save(path)
    fresh = VVModel(seed=1, device="cpu")
    assert m.load(path)
    args = dict(batch_size=16, iters_per_val=2, max_iters=2, early_stopping=False)
    seen = []
    for vmax in (20.0, 300.0, 50.0):
        cols = columns(64, seed=4, vmax=vmax)
        for model in (jm, m, fresh):
            model.train_data(cols, log=lambda s: None, dump_dir=str(tmp_path / "dump"), **args)
        np.testing.assert_array_equal(m.ubound.numpy(), np.asarray(jm.ubound))
        np.testing.assert_array_equal(fresh.ubound.numpy()[0], cols[1].max())
        seen.append(float(m.ubound[0]))
    assert seen[0] == 100.0 and seen[1] == seen[2] == columns(64, seed=4, vmax=300.0)[1].max()


def test_compute_fisher_matches_jax():
    jm = JVVModel(seed=6)
    m = port_of(jm, seed=6)
    cols = columns(8, seed=6)
    jm.compute_fisher(cols)
    m.compute_fisher(cols)
    want = _state_from_flax(jax.tree.map(np.asarray, jm.fisher))
    for k, v in m.fisher.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-9,
                                   err_msg=k)
    for k, v in m.net.state_dict().items():
        assert torch.equal(m.p0[k], v)


def test_checkpoint_round_trip(tmp_path):
    m = VVModel(seed=4, device="cpu")
    cols = as_port(columns(32, seed=4))
    for i in range(3):
        m.train_step(cols, torch.arange(i, 16 + i))
    m.ubound = torch.tensor([123.5, 456.25])
    path = str(tmp_path / "ck" / "model.pt")
    m.save(path)
    r = VVModel(seed=9, device="cpu")
    assert r.load(path)
    for a, b in zip(m.net.parameters(), r.net.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(m.opt.mu + m.opt.nu, r.opt.mu + r.opt.nu):
        assert torch.equal(a, b)
    assert r.opt.count == m.opt.count == 3
    assert torch.equal(r.ubound, m.ubound) and torch.equal(r.lbound, m.lbound)
    assert torch.equal(r._ubound_floor, m.ubound)
    assert not VVModel(device="cpu").load(str(tmp_path / "missing.pt"))


def test_jax_checkpoint_carried_into_the_port(tmp_path):
    """checkpoints/model_vv.msgpack (read only) through params_from_jax +
    opt_state_from_jax: the same inference as the JAX package's loaded
    model, and the same next Yogi step."""
    jm = JVVModel(seed=0)
    assert jm.load(CKPT)
    m = port_of(jm, seed=0)
    mu, nu, count = opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state))
    m.load_opt_state(mu, nu, count)
    boards = columns(64, seed=8)[0]
    jv, jvar = jm.inference(boards)
    v, var = m.inference(boards)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(var, jvar, rtol=1e-4, atol=1e-2)
    cols = columns(64, seed=9)
    # A pre-activation within float32 rounding of 0 may fall on either side
    # of its ReLU in two float32 computations, and its unit's gradient then
    # differs as a whole (minibatches of keys 1-3 hold one at 6.4e-9, in
    # fc1); key 0's minibatch holds none nearer than 1e-6 (checked here).
    sub = jax.random.PRNGKey(0)
    idx = torch.as_tensor(np.array(jax.random.randint(sub, (32,), 0, 64)))
    assert min_nonzero_preactivation(m.net, as_port(cols)[0][idx]) > 1e-6
    params, opt, _, _ = jm._train_step(jm.params, jm.opt_state, jm.ubound, as_jax(cols), sub,
                                       jm.fisher, jm.p0, jnp.float32(0), 32)
    m.train_step(as_port(cols), idx)
    assert_params_close(m, params)
    adam = opt[1][0]
    mu_w, nu_w = _state_from_flax(jax.tree.map(np.asarray, adam.mu)), _state_from_flax(
        jax.tree.map(np.asarray, adam.nu))
    for n, a, b in zip(m.names, m.opt.mu, m.opt.nu):
        np.testing.assert_allclose(a.numpy(), mu_w[n].numpy(), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), nu_w[n].numpy(), rtol=1e-4, atol=1e-9)
    assert m.opt.count == int(adam.count) == count + 1


def test_load_refuses_a_jax_checkpoint_and_save_never_overwrites_one(tmp_path):
    """The JAX blob is not the port's format: load reads it through the
    numpy-only reader and the converters (the same params, Yogi state and
    bounds as params_from_jax and opt_state_from_jax give), and save
    refuses to write over it (the tracked file is only read)."""
    blob = tmp_path / "model_vv.msgpack"
    with open(CKPT, "rb") as f:
        data = f.read()
    blob.write_bytes(data)
    m = VVModel(device="cpu", checkpoint_path=str(blob))
    assert m.load()
    jm = JVVModel(seed=0)
    assert jm.load(CKPT)
    want = port_of(jm, seed=0)
    for k, v in want.net.state_dict().items():
        assert torch.equal(m.net.state_dict()[k], v), k
    mu, nu, count = opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state))
    for n, a, b in zip(m.names, m.opt.mu, m.opt.nu):
        assert torch.equal(a, mu[n]) and torch.equal(b, nu[n])
    assert m.opt.count == count and torch.equal(m._ubound_floor, want.ubound)
    with pytest.raises(ValueError, match="refusing to overwrite"):
        m.save()
    assert blob.read_bytes() == data
    assert pickle.loads(data).keys() == {"params", "opt_state", "ubound", "lbound"}
