"""The port's RAdam, NSGD and SNGD and `make` against the JAX package's
optimizers (`tetris_mcts_tpu/train/optim.py`), on the CPU.

Each runs 10 updates on seeded gradients over five decades, as the JAX
package runs an optimizer: its update compiled (`jax.jit`), inside which
RAdam's b2^count is XLA's float32 pow. The params (and RAdam's moments)
must stay within rtol 1e-6 / atol 1e-7 of optax's. RAdam's 10 steps cross
from the unrectified branch (rho < 5, counts 1-5) into the rectified one
(count 6 on). Eager optax takes b2^count by repeated float32 products,
which moves RAdam's r by 0.3% at count 7 (rho = rho_inf - x cancels); the
port follows the compiled form (`optim.radam_rectifier`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.train import optim as JO
from tetris_mcts_tpu_torch.train import optim as O

torch.set_num_threads(1)

SHAPES = [(32, 1, 3, 3), (32,), (256, 28), (2,)]
TOL = dict(rtol=1e-6, atol=1e-7)


def run_both(name, steps=10, seed=0):
    rng = np.random.RandomState(seed)
    ps = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = JO.make(name)
    jp = [jnp.asarray(x) for x in ps]
    st = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.tensor(x) for x in ps]
    opt = O.make(name, tp)
    for _ in range(steps):
        gs = [(rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32) for s in SHAPES]
        upd, st = update([jnp.asarray(g) for g in gs], st, jp)
        jp = [a + b for a, b in zip(jp, upd)]
        opt.step([torch.tensor(g) for g in gs])
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return opt, st


def test_radam_matches_optax_through_both_branches():
    assert [O.radam_rectifier(c) is None for c in range(1, 8)] == [True] * 5 + [False] * 2
    opt, st = run_both("radam")
    adam = st[0]
    for got, want in zip(opt.mu + opt.nu, list(adam.mu) + list(adam.nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert opt.count == int(adam.count) == 10


def test_radam_rectifier_is_xlas():
    """r as the compiled optax computes it, at the counts either side of
    the threshold and further on."""
    b2 = 0.999
    rho_inf = 2.0 / (1.0 - b2) - 1.0

    @jax.jit
    def rect(c):
        b2t = b2**c
        ro = rho_inf - 2 * c * b2t / (1 - b2t)
        return ro, jnp.sqrt((ro - 4.0) * (ro - 2.0) * rho_inf
                            / ((rho_inf - 4.0) * (rho_inf - 2.0) * ro))

    for c in (5, 6, 7, 8, 50, 1000, 19999):
        ro, r = rect(jnp.int32(c))
        got = O.radam_rectifier(c)
        assert (got is None) == (float(ro) < 5.0)
        if got is not None:
            assert got == float(r), c


@pytest.mark.parametrize("name", ["nsgd", "sngd"])
def test_normalised_sgd_matches_jax(name):
    run_both(name)


@pytest.mark.parametrize("name,cls", [("yogi", O.Yogi), ("adam_amsgrad", O.AdamAmsgrad),
                                      ("radam", O.RAdam), ("nsgd", O.NSGD),
                                      ("sngd", O.SNGD)])
def test_make_covers_every_name(name, cls):
    p = [torch.zeros(3)]
    opt = O.make(name, p, lr=0.5)
    assert type(opt) is cls and opt.lr == 0.5 and opt.params[0] is p[0]
    with pytest.raises(KeyError):
        O.make("sgd", p)
