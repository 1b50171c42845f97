"""The port's fused packed-board VV forward (`ops/vv_forward.py`; its plain
version, which is what runs on the CPU) against the JAX package.

- `unpack_pm1` equals the JAX `unpack_pm1` bit for bit, including boards
  where a cell has both the locked and the piece bit (the piece wins).
- `vv_forward_packed_plain` against the JAX `vv_forward_packed(...,
  use_pallas=False)` (the Pallas kernel's own math as plain jnp) and against
  the port's `VVNet` on the unpacked images, same weights (`params_from_jax`),
  at tests/test_ops.py's tolerances: rtol 1e-4, atol 1e-3 on the value and
  1e-2 on the variance. The comparison with `VVNet` holds the forward to
  the port's fc1 layout (inputs in (c, y, x) order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import vv_forward as JF
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.env import engine as E
from tetris_mcts_tpu_torch.ops import vv_forward as F
from torch_parity import port_vvmodel

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "model_vv.msgpack")
TOL_V = dict(rtol=1e-4, atol=1e-3)
TOL_VAR = dict(rtol=1e-4, atol=1e-2)


def _boards(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2**20, (n, 20)).astype(np.uint32)


def test_unpack_pm1_matches_jax():
    packed = _boards(32, 0)
    packed[0, :] = 0xFFFFF  # both bits everywhere: the piece wins
    got = F.unpack_pm1(torch.as_tensor(packed.view(np.int32)))
    want = np.asarray(JF.unpack_pm1(jnp.asarray(packed)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == -1).all()


@pytest.mark.parametrize("source", ["fresh", "checkpoint"])
def test_plain_forward_matches_jax_and_vvnet(source):
    jm = JVVModel(seed=3)
    if source == "checkpoint":
        assert jm.load(CKPT)
    packed = _boards(64, 1)
    v_j, var_j = JF.vv_forward_packed(jm.params, jm.ubound, jm.lbound,
                                      jnp.asarray(packed), use_pallas=False)
    model = port_vvmodel(jm)
    x = torch.as_tensor(packed.view(np.int32))
    F.reset_launches()
    v, var = F.vv_forward_packed(model.net, model.ubound, model.lbound, x)
    assert F.LAUNCHES["vv_forward"] == 0  # a CPU tensor: the plain version ran
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **TOL_V)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), **TOL_VAR)
    v_n, var_n = model.apply_fn()(E.unpack_obs(x)[:, None].float())
    np.testing.assert_allclose(v.numpy(), v_n.numpy(), **TOL_V)
    np.testing.assert_allclose(var.numpy(), var_n.numpy(), **TOL_VAR)


def test_forward_takes_cpu_or_cuda_only():
    model = port_vvmodel(JVVModel(seed=1))
    with pytest.raises(ValueError):
        F.vv_forward_packed(model.net, model.ubound, model.lbound,
                            torch.empty(4, 20, dtype=torch.int32, device="meta"))


def test_search_boards_match_jax():
    """On child boards a search produces (the JAX engine's packed child
    observations after a few random moves), not only on random bits."""
    jm = JVVModel(seed=5)
    cfg = JE.EnvConfig()
    states = JE.reset_batch(4, 16, cfg)
    rng = np.random.RandomState(1)
    for _ in range(30):
        states = JE.step_batch(states, jnp.asarray(rng.randint(0, 7, 16), jnp.int32),
                               cfg)
    packed = np.array(jax.vmap(JE.pack_obs)(states))
    v_j, var_j = JF.vv_forward_packed(jm.params, jm.ubound, jm.lbound,
                                      jnp.asarray(packed), use_pallas=False)
    model = port_vvmodel(jm)
    v, var = F.vv_forward_packed(model.net, model.ubound, model.lbound,
                                 torch.as_tensor(packed.view(np.int32)))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), **TOL_V)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), **TOL_VAR)
