"""The port's Bayesian VV net (`train/bayesian.BBBVVModel`) against the JAX
package's (`tetris_mcts_tpu/train/bayesian.py`), on the CPU.

One Adam (Bayes-by-backprop) step and one BGD step run in both packages on
the same minibatch and the same eps: the JAX step's own draws, replayed
from its key chain (`key, k_idx, k_mc = split(key, 3)`, the minibatch
`randint(k_idx)`, draw d's eps of weight i `normal(split(split(k_mc,
mc)[d], 10)[i])` in flax's leaf order) and carried into the port's layout
by `_state_from_flax`, the mapping that carries the params. Tolerances,
measured on this data: the loss rtol 1e-5, the KL rtol 1e-6; mu and rho
after the step rtol 1e-5 / atol 1e-7 (BGD; Adam's mu atol 1e-7 on every
entry whose gradient is not within float32 rounding of zero, see
`test_adam_step_matches_jax`). Then, as the JAX package's own tests
(tests/test_bayesian.py): a huge-gradient BGD session keeps every sigma
positive and finite, 200-step sessions of both methods do not diverge,
stochastic inference varies between calls; and the minibatch and draws
of the port's own source (a torch generator, not threefry) are
reproducible from the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.train.bayesian import BBBVVModel as JBBB
from tetris_mcts_tpu_torch.train.bayesian import BBBVVModel, softplus
from tetris_mcts_tpu_torch.train.trainer import _state_from_flax

torch.set_num_threads(1)


def data_cols(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 2, (n, 20, 10)).astype(np.int8),
            rng.uniform(0, 50, n).astype(np.float32),
            rng.uniform(1, 10, n).astype(np.float32),
            np.ones(n, np.float32)]


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def port_of(jb, **kw):
    m = BBBVVModel(mc_iters=jb.mc_iters, device="cpu", method=jb.method, **kw)
    m.load_state(_state_from_flax(np_tree(jb.params["mu"])),
                 _state_from_flax(np_tree(jb.params["rho"])))
    return m


def jax_draws(jb, key, n, bs):
    """The JAX step's minibatch and eps from its step key: (idx, eps in the
    port's layout {name: (mc, ...)})."""
    _, k_idx, k_mc = jax.random.split(key, 3)
    idx = np.array(jax.random.randint(k_idx, (bs,), 0, n))
    leaves, tdef = jax.tree.flatten(jb.params["mu"])
    draws = []
    for k in jax.random.split(k_mc, jb.mc_iters):
        ks = jax.random.split(k, len(leaves))
        eps = [np.asarray(jax.random.normal(kk, l.shape)) for kk, l in zip(ks, leaves)]
        draws.append(_state_from_flax(jax.tree.unflatten(tdef, eps)))
    return torch.as_tensor(idx), {n_: torch.stack([d[n_] for d in draws]) for n_ in draws[0]}


def jax_kl(params, prior_sigma=0.1):
    pv = prior_sigma**2
    total = 0.0
    for m, r in zip(jax.tree.leaves(params["mu"]), jax.tree.leaves(params["rho"])):
        s2 = jnp.logaddexp(r, 0.0) ** 2
        total = total + 0.5 * jnp.sum(s2 / pv + m * m / pv - 1.0 - jnp.log(s2 / pv))
    return float(total)


def as_jax(cols):
    w = jnp.asarray(cols[3])
    return (jnp.asarray(cols[0], jnp.float32)[..., None], jnp.asarray(cols[1]),
            jnp.asarray(cols[2]), w / jnp.mean(w))


def as_port(cols):
    w = torch.as_tensor(cols[3])
    return (torch.as_tensor(cols[0]).float()[:, None], torch.as_tensor(cols[1]),
            torch.as_tensor(cols[2]), w / w.mean())


def assert_posterior_close(m, params, which=("mu", "rho"), **tol):
    for part in which:
        want = _state_from_flax(np_tree(params[part]))
        for n, p in getattr(m, part).items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       err_msg=f"{part} {n}", **tol)


def test_adam_step_matches_jax():
    jb = JBBB(mc_iters=3, seed=1)
    m = port_of(jb)
    cols = data_cols()
    key = jax.random.PRNGKey(4)
    idx, eps = jax_draws(jb, key, 64, 16)
    np.testing.assert_allclose(float(m.kl_to_prior().detach()), jax_kl(jb.params), rtol=1e-6)
    params, _, jloss = jb._train_step(jb.params, jb.opt_state, jb.ubound, as_jax(cols), key, 16)
    batch = tuple(d[idx] for d in as_port(cols))
    _, grads = m.adam_loss_and_grads(batch, eps)
    loss = m.train_step(as_port(cols), idx, eps)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    # Adam's first step is -lr g / (|g| + 1e-8): a gradient entry within
    # float32 rounding of zero can take a different sign, or size, in the
    # two frameworks, and its entry then moves by up to lr; entries whose
    # gradient is beyond 1e-6 of zero must agree
    mu_grads = dict(zip(m.names, grads[:len(m.names)]))
    want = _state_from_flax(np_tree(params["mu"]))
    for n, p in m.mu.items():
        firm = mu_grads[n].abs() > 1e-6
        assert firm.float().mean() > 0.9, n
        np.testing.assert_allclose(p.detach()[firm].numpy(), want[n][firm].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=f"mu {n}")
    assert_posterior_close(m, params, ("rho",), rtol=1e-5, atol=1e-7)
    assert m.opt.count == 1


def test_bgd_step_matches_jax():
    jb = JBBB(mc_iters=3, seed=3, method="bgd")
    m = port_of(jb)
    cols = data_cols(seed=1)
    key = jax.random.PRNGKey(7)
    idx, eps = jax_draws(jb, key, 64, 16)
    params, _, jloss = jb._train_step(jb.params, jb.opt_state, jb.ubound, as_jax(cols), key, 16)
    loss = m.train_step(as_port(cols), idx, eps)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_posterior_close(m, params, rtol=1e-5, atol=1e-7)
    assert any(not torch.equal(m.mu[n], _state_from_flax(np_tree(jb.params["mu"]))[n])
               for n in m.names)


def test_bgd_survives_huge_gradients():
    """tests/test_bayesian.py's case: absurd targets and a tiny variance
    give a huge E[g eps]; the x > 0 branch s / (r + x) keeps sigma from
    cancelling to 0, and the floor keeps rho finite."""
    rng = np.random.RandomState(9)
    n = 64
    cols = [rng.randint(0, 2, (n, 20, 10)).astype(np.int8), np.full(n, 1e7, np.float32),
            np.full(n, 1e-3, np.float32), np.ones(n, np.float32)]
    m = BBBVVModel(mc_iters=2, seed=5, method="bgd", device="cpu")
    m.train_data(cols, batch_size=64, iters=50, log=lambda s: None)
    for n_ in m.names:
        sig = softplus(m.rho[n_]).detach()
        assert torch.isfinite(m.rho[n_]).all() and torch.isfinite(m.mu[n_]).all()
        assert (sig > 0).all() and torch.isfinite(sig).all()


@pytest.mark.parametrize("method", ["adam", "bgd"])
def test_sessions_train_and_keep_sigma_positive(method):
    m = BBBVVModel(mc_iters=2, seed=1 if method == "adam" else 3, method=method, device="cpu")
    cols = data_cols()
    mu0 = {n: p.detach().clone() for n, p in m.mu.items()}
    h = m.train_data(cols, batch_size=16, iters=200, log=lambda s: None)
    assert [it for it, _ in h] == [100, 200] and np.isfinite(h[-1][1])
    assert h[-1][1] < h[0][1] * 1.5  # not diverging
    assert any(not torch.equal(mu0[n], m.mu[n]) for n in m.names)
    for n in m.names:
        sig = softplus(m.rho[n]).detach()
        assert (sig > 0).all() and torch.isfinite(sig).all()
    np.testing.assert_allclose(m.ubound.numpy(), [cols[1].max(), cols[2].max()])
    v, var = m.inference(cols[0][:4])
    assert v.shape == (4, 1) and np.isfinite(v).all() and np.isfinite(var).all()


def test_stochastic_inference_varies_and_draws_are_seeded():
    m = BBBVVModel(mc_iters=1, seed=2, device="cpu")
    boards = data_cols(4)[0]
    v1, _ = m.inference_stochastic(boards)
    v2, _ = m.inference_stochastic(boards)
    assert not np.allclose(v1, v2)
    vm, _ = m.inference(boards)
    assert np.isfinite(vm).all() and not np.allclose(vm, v1)
    again = BBBVVModel(mc_iters=1, seed=2, device="cpu")
    np.testing.assert_array_equal(again.inference_stochastic(boards)[0], v1)
    a, b = (BBBVVModel(mc_iters=3, seed=0, device="cpu").draws for _ in range(2))
    a.start(11), b.start(11)
    (ia, ea), (ib, eb) = a(64, 8), b(64, 8)
    assert torch.equal(ia, ib) and all(torch.equal(ea[n], eb[n]) for n in ea)
    assert ea["fc1.weight"].shape == (3, 256, 1792)
    with pytest.raises(ValueError, match="unknown method"):
        BBBVVModel(method="sgd", device="cpu")
