"""The port's VP net, losses, optimizer and model against the JAX package's,
on the CPU, and the JAX checkpoints read without flax.

- `VPNet` forward against flax's `VPNet` with the weights carried by
  `vp_params_from_jax`: float32 within rtol 1e-4 / atol 1e-3 on the value
  and the logits (the VV net's bounds); the bf16 body, which rounds to
  bfloat16 (8 significant bits) in both frameworks at different places,
  within 2% of the float32 output's largest magnitude, as the VV test
  holds its bf16 outputs to 2% of their range.
- `smooth_l1` and `kl_div_policy` within rtol 1e-6 / atol 1e-6.
- `AdamAmsgrad` over 12 updates against `optax.amsgrad` (shrinking
  gradients, so the running maximum of the corrected second moment holds
  entries that a later step does not raise): params and moments within
  rtol 1e-6 / atol 1e-7, count exact; torch's own amsgrad gives another
  update.
- `VPModel.train_step` against the JAX step on the JAX key chain (loss and
  grad norm rtol 1e-5; params and moments rtol 1e-4 / atol 1e-5), and one
  `train_data` session of 3 windows with early stopping (history rtol 1e-4
  / atol 1e-5, the same best window, params rtol 1e-4 / atol 1e-5).
- Checkpoints: the port's own round trip; the repo's VV checkpoint and a
  VP checkpoint that the JAX `VPModel.save` writes read by
  `train/flax_msgpack.py` with every leaf bit-equal to
  `flax.serialization.msgpack_restore`'s, and loaded by `VVModel.load` /
  `VPModel.load` into the same inference as the JAX models'.
"""

import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tetris_mcts_tpu.models import losses as JL
from tetris_mcts_tpu.models.nets import VPNet as JVPNet
from tetris_mcts_tpu.train.trainer import VPModel as JVPModel
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.train import flax_msgpack
from tetris_mcts_tpu_torch.train.optim import AdamAmsgrad
from tetris_mcts_tpu_torch.train.trainer import (VPModel, VVModel, vp_opt_state_from_jax,
                                                 vp_params_from_jax)
from test_torch_train import JaxIndexSource

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "model_vv.msgpack")
NET_TOL = dict(rtol=1e-4, atol=1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def columns(n, seed=0):
    rng = np.random.RandomState(seed)
    pol = rng.uniform(0, 1, (n, 7)).astype(np.float32) ** 3
    return [rng.randint(-1, 2, (n, 20, 10)).astype(np.int8),
            rng.uniform(0, 40, n).astype(np.float32),
            (pol / pol.sum(1, keepdims=True)).astype(np.float32),
            rng.uniform(1, 5, n).astype(np.float32)]


def port_of(jm, seed=0, **kw):
    m = VPModel(seed=seed, device="cpu", **kw)
    m.load_state(vp_params_from_jax(jax.tree.map(np.asarray, jm.params)))
    return m


def assert_params_close(m, jparams, **tol):
    want = vp_params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in m.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **(tol or PARAM_TOL))


TRAIN_LR = 3e-3  # the fixture model's learning rate, in both packages


def trained_jax_model(seed=2, steps=40):
    """A JAX VPModel a few steps away from its init (norm scales and biases
    off 1 and 0, logits spread), at lr TRAIN_LR."""
    jm = JVPModel(seed=seed, lr=TRAIN_LR)
    data = tuple(jnp.asarray(c) for c in (np.asarray(columns(64, seed)[0], np.float32)[..., None],
                                          *columns(64, seed)[1:]))
    key = jax.random.PRNGKey(seed)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        jm.params, jm.opt_state, _ = jm._train_step(jm.params, jm.opt_state, data, sub, 32)
    return jm


@pytest.fixture(scope="module")
def jm_trained():
    return trained_jax_model()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vpnet_matches_flax(jm_trained, dtype):
    jm = jm_trained
    boards = columns(96, seed=5)[0]
    x_j = jnp.asarray(boards, jnp.float32)[..., None]
    x_t = torch.as_tensor(boards).float()[:, None]
    m = port_of(jm)
    v32, p32 = JVPNet().apply(jm.params, x_j)
    if dtype == "float32":
        v, logits = m.apply_fn()(x_t)
        np.testing.assert_allclose(v.numpy(), np.asarray(v32)[:, 0], **NET_TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(p32), **NET_TOL)
        assert float(np.ptp(np.asarray(p32))) > 0.1  # the logits are not flat
        return
    v_ref, p_ref = jm.apply_fn(jnp.bfloat16)(jm.params, x_j)
    v, logits = m.apply_fn(torch.bfloat16)(x_t)
    assert v.dtype == logits.dtype == torch.float32  # the heads run in float32
    for got, want, full in ((v.numpy(), np.asarray(v_ref)[:, 0], np.asarray(v32)),
                            (logits.numpy(), np.asarray(p_ref), np.asarray(p32))):
        np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * float(np.abs(full).max()))
        assert not np.array_equal(got, np.asarray(full).reshape(got.shape))  # bf16 ran


def test_vp_losses_match_jax():
    rng = np.random.RandomState(1)
    pred, target = (rng.uniform(-3, 3, 64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(L.smooth_l1(torch.as_tensor(pred), torch.as_tensor(target)).numpy(),
                               np.asarray(JL.smooth_l1(pred, target)), rtol=1e-6, atol=1e-6)
    logits = rng.normal(0, 2, (64, 7)).astype(np.float32)
    probs = columns(64, seed=2)[2]
    probs[0] = np.eye(7, dtype=np.float32)[3]  # a one-hot target: smoothing keeps log finite
    np.testing.assert_allclose(
        L.kl_div_policy(torch.as_tensor(logits), torch.as_tensor(probs)).numpy(),
        np.asarray(JL.kl_div_policy(logits, probs)), rtol=1e-6, atol=1e-6)


def test_adam_amsgrad_matches_optax():
    rng = np.random.RandomState(3)
    shapes = [(5, 3), (7,)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    tx = optax.amsgrad(1e-4)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.as_tensor(p.copy()) for p in params]
    opt = AdamAmsgrad(tp, lr=1e-4)
    ref = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    torch_ams = torch.optim.Adam(ref, lr=1e-4, amsgrad=True)
    held = 0
    for i in range(12):
        scale = 3.0 * 0.5**i  # shrinking gradients: nu_hat falls below nu_max
        grads = [rng.normal(0, scale, s).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        nu_hat = [np.asarray(n) / (1 - 0.999 ** (i + 1)) for n in state[0].nu]
        held += sum(int((np.asarray(m) > h).sum()) for m, h in zip(state[0].nu_max, nu_hat))
        opt.step([torch.as_tensor(g) for g in grads])
        for p, g in zip(ref, grads):
            p.grad = torch.as_tensor(g)
        torch_ams.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        for mine, theirs in ((opt.mu, state[0].mu), (opt.nu, state[0].nu),
                             (opt.nu_max, state[0].nu_max)):
            for a, b in zip(mine, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert opt.count == int(state[0].count) == 12
    assert held > 0  # steps on which the running maximum won
    # torch's amsgrad keeps the max of the uncorrected moment: another update
    assert not all(np.allclose(a.numpy(), r.detach().numpy(), rtol=1e-6, atol=1e-7)
                   for a, r in zip(tp, ref))


def as_jax(cols):
    return (jnp.asarray(cols[0], jnp.float32)[..., None], *(jnp.asarray(c) for c in cols[1:]))


def as_port(cols):
    return (torch.as_tensor(cols[0]).float()[:, None], *(torch.as_tensor(c) for c in cols[1:]))


def test_train_step_matches_jax(jm_trained):
    jm = jm_trained
    m = port_of(jm, lr=TRAIN_LR)
    m.load_opt_state(*vp_opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    cols = columns(64, seed=7)
    params, opt_state = jm.params, jm.opt_state
    key = jax.random.PRNGKey(11)
    for _ in range(3):
        key, sub = jax.random.split(key)
        params, opt_state, met = jm._train_step(params, opt_state, as_jax(cols), sub, 32)
        idx = torch.as_tensor(np.array(jax.random.randint(sub, (32,), 0, 64)))
        loss, per, gnorm = m.train_step(as_port(cols), idx)
        np.testing.assert_allclose(float(loss), float(met["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(per.std(correction=0)), float(met["loss_std"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(gnorm), float(met["grad_norm"]), rtol=1e-5)
    assert_params_close(m, params)
    mu, nu, nu_max, count = vp_opt_state_from_jax(jax.tree.map(np.asarray, opt_state))
    for n, a, b, c in zip(m.names, m.opt.mu, m.opt.nu, m.opt.nu_max):
        np.testing.assert_allclose(a.numpy(), mu[n].numpy(), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), nu[n].numpy(), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(c.numpy(), nu_max[n].numpy(), rtol=1e-4, atol=1e-9)
    assert m.opt.count == count == int(jm.opt_state[0].count) + 3


def test_train_data_session_matches_jax(jm_trained, tmp_path):
    jm = jm_trained
    m = port_of(jm, index_source=JaxIndexSource(), lr=TRAIN_LR)
    m.load_opt_state(*vp_opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    m._rng = np.random.RandomState(5)
    jm._rng = np.random.RandomState(5)
    cols = columns(160, seed=3)
    args = dict(batch_size=16, iters_per_val=10, max_iters=30, shuffle=True,
                early_stopping_patience=2, early_stopping_threshold=0.0)
    jlog, plog = [], []
    jh = jm.train_data(cols, log=jlog.append, **args)
    ph = m.train_data(cols, log=plog.append, **args)
    assert [h[0] for h in ph] == [h[0] for h in jh] == [10, 20, 30]
    np.testing.assert_allclose(np.array(ph), np.array(jh), rtol=1e-4, atol=1e-5)
    assert plog == [ln for ln in plog if ln] and len(plog) == len(jlog)
    assert_params_close(m, jm.params)


def test_checkpoint_round_trip(tmp_path):
    m = VPModel(seed=4, device="cpu")
    cols = as_port(columns(32, seed=4))
    for i in range(3):
        m.train_step(cols, torch.arange(i, 16 + i))
    path = str(tmp_path / "ck" / "vp.pt")
    m.save(path)
    r = VPModel(seed=9, device="cpu")
    assert r.load(path)
    for a, b in zip(m.net.parameters(), r.net.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(m.opt.mu + m.opt.nu + m.opt.nu_max, r.opt.mu + r.opt.nu + r.opt.nu_max):
        assert torch.equal(a, b)
    assert r.opt.count == m.opt.count == 3
    assert not VPModel(device="cpu").load(str(tmp_path / "missing.pt"))
    vv = str(tmp_path / "vv.pt")
    VVModel(device="cpu").save(vv)
    with pytest.raises(ValueError, match="not of the VP net"):
        VPModel(device="cpu").load(vv)


def assert_leaves_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
    return len(g)


def test_flax_reader_matches_flax_on_the_repo_checkpoint():
    with open(CKPT, "rb") as f:
        blob = pickle.load(f)
    got = flax_msgpack.read_jax_checkpoint(CKPT)
    assert got["params"] == got["params"] and set(got) == set(blob)
    n = sum(assert_leaves_equal(got[k], flax.serialization.msgpack_restore(blob[k]))
            for k in ("params", "opt_state"))
    assert n == 31
    for k in ("ubound", "lbound"):
        np.testing.assert_array_equal(got[k], blob[k])
    # loaded by VVModel.load: the JAX model's inference
    jm = JVVModel(seed=0)
    assert jm.load(CKPT)
    m = VVModel(seed=3, device="cpu")
    assert m.load(CKPT)
    boards = columns(32, seed=8)[0]
    for a, b, atol in zip(m.inference(boards), jm.inference(boards), (1e-3, 1e-2)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
    assert m.opt.count == int(jm.opt_state[1][0].count)


def test_flax_reader_and_vp_load_on_a_jax_vp_checkpoint(jm_trained, tmp_path):
    path = str(tmp_path / "model_vp.msgpack")
    jm_trained.save(path)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    got = flax_msgpack.read_jax_checkpoint(path)
    n = sum(assert_leaves_equal(got[k], flax.serialization.msgpack_restore(blob[k]))
            for k in ("params", "opt_state"))
    assert n == 16 + 1 + 3 * 16  # params; count, mu, nu, nu_max
    m = VPModel(seed=5, device="cpu", checkpoint_path=path)
    assert m.load()
    assert m.opt.count == int(jm_trained.opt_state[0].count) > 0
    boards = columns(32, seed=8)[0]
    for a, b in zip(m.inference(boards), jm_trained.inference(boards)):
        np.testing.assert_allclose(a, b, **NET_TOL)
    with pytest.raises(ValueError, match="another net"):
        VVModel(device="cpu").load(path)
    with pytest.raises(ValueError, match="refusing to overwrite"):
        m.save()
    # the reader refuses pickled objects other than numpy arrays
    evil = tmp_path / "evil.msgpack"
    evil.write_bytes(pickle.dumps({"params": b"", "opt_state": b"", "x": os.getcwd}))
    with pytest.raises(pickle.UnpicklingError):
        flax_msgpack.read_jax_checkpoint(str(evil))
