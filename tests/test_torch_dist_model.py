"""The port's distributional net, loss and model against the JAX package's,
on the CPU, and the JAX distributional checkpoint read without flax.

- `DistNet` forward against flax's `DistNet` with the weights carried by
  `dist_params_from_jax`: float32 within rtol 1e-4 / atol 1e-3 (the nets'
  bounds); the bf16 body within 2% of the float32 output's largest
  magnitude, as the VV and VP bf16 tests hold theirs.
- `categorical_ce` within rtol 1e-6 / atol 1e-6 (a zero prediction hits
  the clip).
- `DistModel.train_step` against the JAX step on the JAX key chain, on
  minibatches whose nearest ReLU pre-activation is farther than 1e-6 from
  zero (nearer, float32 rounding can put it on either side in the two
  frameworks): loss and loss_std rtol 1e-5; params after the Yogi steps
  rtol 1e-4 / atol 1e-5, moments rtol 1e-4.
- One `train_data` session of 3 windows with early stopping (history rtol
  1e-4 / atol 1e-5, params rtol 1e-4 / atol 1e-5).
- Checkpoints: the port's own round trip; a checkpoint that the JAX
  `DistModel.save` writes read by `train/flax_msgpack.py` with every leaf
  bit-equal to `flax.serialization.msgpack_restore`'s and loaded by
  `DistModel.load` into the JAX model's inference; the VV, VP and dist
  loaders refuse one another's checkpoints.
"""

import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.models import losses as JL
from tetris_mcts_tpu.models.nets import DistNet as JDistNet
from tetris_mcts_tpu.train.trainer import DistModel as JDistModel
from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.train import flax_msgpack
from tetris_mcts_tpu_torch.train.trainer import (DistModel, VPModel, VVModel,
                                                 dist_opt_state_from_jax, dist_params_from_jax)
from test_torch_train import JaxIndexSource
from torch_train_cases import min_nonzero_preactivation

torch.set_num_threads(1)

ATOMS = 16
NET_TOL = dict(rtol=1e-4, atol=1e-3)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_LR = 3e-3  # the fixture model's learning rate, in both packages


def columns(n, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0, 1, (n, ATOMS)).astype(np.float32) ** 4
    return [rng.randint(-1, 2, (n, 20, 10)).astype(np.int8),
            (d / d.sum(1, keepdims=True)).astype(np.float32),
            rng.uniform(1, 5, n).astype(np.float32)]


def as_jax(cols):
    return (jnp.asarray(cols[0], jnp.float32)[..., None], *(jnp.asarray(c) for c in cols[1:]))


def as_port(cols):
    return (torch.as_tensor(cols[0]).float()[:, None], *(torch.as_tensor(c) for c in cols[1:]))


def port_of(jm, seed=0, **kw):
    m = DistModel(ATOMS, seed, "cpu", **kw)
    m.load_state(dist_params_from_jax(jax.tree.map(np.asarray, jm.params)))
    return m


def assert_params_close(m, jparams):
    want = dist_params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in m.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **PARAM_TOL)


@pytest.fixture(scope="module")
def jm_trained():
    """A JAX DistModel 40 steps away from its init (biases off 0, the
    distributions peaked), at lr TRAIN_LR."""
    jm = JDistModel(atoms=ATOMS, seed=2, lr=TRAIN_LR)
    data = as_jax(columns(64, 2))
    key = jax.random.PRNGKey(2)
    for _ in range(40):
        key, sub = jax.random.split(key)
        jm.params, jm.opt_state, _ = jm._train_step(jm.params, jm.opt_state, data, sub, 32)
    return jm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_distnet_matches_flax(jm_trained, dtype):
    jm = jm_trained
    boards = columns(96, seed=5)[0]
    x_j = jnp.asarray(boards, jnp.float32)[..., None]
    x_t = torch.as_tensor(boards).float()[:, None]
    m = port_of(jm)
    p32 = np.asarray(JDistNet(atoms=ATOMS).apply(jm.params, x_j))
    if dtype == "float32":
        got = m.apply_fn()(x_t).numpy()
        np.testing.assert_allclose(got, p32, **NET_TOL)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
        assert float(p32.max()) > 2.0 / ATOMS  # the distributions are not flat
        return
    want = np.asarray(jm.apply_fn(jnp.bfloat16)(jm.params, x_j))
    got = m.apply_fn(torch.bfloat16)(x_t)
    assert got.dtype == torch.float32  # the head and softmax run in float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.02 * float(np.abs(p32).max()))
    assert not np.array_equal(got.numpy(), p32)  # bf16 ran


def test_categorical_ce_matches_jax():
    pred, target = columns(64, seed=1)[1], columns(64, seed=2)[1]
    pred[0, 3] = 0.0  # log of the clip
    np.testing.assert_allclose(
        L.categorical_ce(torch.as_tensor(pred), torch.as_tensor(target)).numpy(),
        np.asarray(JL.categorical_ce(pred, target)), rtol=1e-6, atol=1e-6)


def clear_keys(m, cols, n, bs, start=0):
    """The first n keys from PRNGKey(start) whose minibatch holds no ReLU
    pre-activation within 1e-6 of zero."""
    keys, k = [], start
    while len(keys) < n:
        key = jax.random.PRNGKey(k)
        idx = np.array(jax.random.randint(key, (bs,), 0, cols[0].shape[0]))
        if min_nonzero_preactivation(m.net, cols[0][idx]) > 1e-6:
            keys.append(key)
        k += 1
        assert k < start + 60
    return keys


def test_train_step_matches_jax(jm_trained):
    jm = jm_trained
    m = port_of(jm, lr=TRAIN_LR)
    m.load_opt_state(*dist_opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
    cols = columns(64, seed=7)
    params, opt_state = jm.params, jm.opt_state
    for sub in clear_keys(m, as_port(cols), 3, 32):
        params, opt_state, met = jm._train_step(params, opt_state, as_jax(cols), sub, 32)
        idx = torch.as_tensor(np.array(jax.random.randint(sub, (32,), 0, 64)))
        loss, per, gnorm = m.train_step(as_port(cols), idx)
        np.testing.assert_allclose(float(loss), float(met["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(per.std(correction=0)), float(met["loss_std"]),
                                   rtol=1e-5)
        assert float(gnorm) > 0
    assert_params_close(m, params)
    mu, nu, count = dist_opt_state_from_jax(jax.tree.map(np.asarray, opt_state))
    for n, a, b in zip(m.names, m.opt.mu, m.opt.nu):
        np.testing.assert_allclose(a.numpy(), mu[n].numpy(), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), nu[n].numpy(), rtol=1e-4, atol=1e-9)
    assert m.opt.count == count == int(jm.opt_state[1][0].count) + 3


def test_train_data_session_matches_jax(jm_trained):
    jm = jm_trained
    m = port_of(jm, index_source=JaxIndexSource(), lr=TRAIN_LR)
    m.load_opt_state(*dist_opt_state_from_jax(jax.tree.map(np.asarray, jm.opt_state)))
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
    assert len(plog) == len(jlog)
    assert_params_close(m, jm.params)


def test_checkpoints_and_the_jax_blob(jm_trained, tmp_path):
    # the port's own round trip
    m = DistModel(ATOMS, seed=4, device="cpu")
    cols = as_port(columns(32, seed=4))
    for i in range(3):
        m.train_step(cols, torch.arange(i, 16 + i))
    path = str(tmp_path / "ck" / "dist.pt")
    m.save(path)
    r = DistModel(ATOMS, seed=9, device="cpu")
    assert r.load(path)
    for a, b in zip(list(m.net.parameters()) + m.opt.mu + m.opt.nu,
                    list(r.net.parameters()) + r.opt.mu + r.opt.nu):
        assert torch.equal(a, b)
    assert r.opt.count == m.opt.count == 3
    vv, vp = str(tmp_path / "vv.pt"), str(tmp_path / "vp.pt")
    VVModel(device="cpu").save(vv)
    VPModel(device="cpu").save(vp)
    for other in (vv, vp):
        with pytest.raises(ValueError, match="not of the distributional net"):
            DistModel(ATOMS, device="cpu").load(other)
    with pytest.raises(ValueError, match="not of the VV net"):
        VVModel(device="cpu").load(path)
    # a checkpoint of the JAX DistModel, read without flax
    blob_path = str(tmp_path / "model_dist.msgpack")
    jm_trained.save(blob_path)
    with open(blob_path, "rb") as f:
        blob = pickle.load(f)
    got = flax_msgpack.read_jax_checkpoint(blob_path)
    for k in ("params", "opt_state"):
        g = jax.tree_util.tree_flatten_with_path(got[k])[0]
        w = jax.tree_util.tree_flatten_with_path(flax.serialization.msgpack_restore(blob[k]))[0]
        assert [p for p, _ in g] == [p for p, _ in w]
        for (p, a), (_, b) in zip(g, w):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), p
    d = DistModel(ATOMS, seed=5, device="cpu", checkpoint_path=blob_path)
    assert d.load()
    assert d.opt.count == int(jm_trained.opt_state[1][0].count) >= 40
    boards = columns(32, seed=8)[0]
    np.testing.assert_allclose(d.inference(boards), np.asarray(jm_trained.inference(boards)),
                               **NET_TOL)
    with pytest.raises(ValueError, match="another net"):
        VVModel(device="cpu").load(blob_path)
    with pytest.raises(ValueError, match="refusing to overwrite"):
        d.save()
