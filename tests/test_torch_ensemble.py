"""The port's deep ensemble (`train/ensemble.EnsembleVVModel`) against the
JAX package's (`tetris_mcts_tpu/train/ensemble.py`), on the CPU, with the
JAX members' weights carried over by `ensemble_params_from_jax`.

- The forward: `inference`, `member_inference` and `apply_fn` in float32
  within the VV net's bounds (rtol 1e-4; atol 1e-3 value, 1e-2 variance,
  tests/test_ops.py), `apply_fn` in bf16 within 2% of the output range, the
  VV net's bf16 bound (tests/test_torch_model.py: the two frameworks round
  the body to bfloat16 at different places).
- 10 train steps on the K-member key chain (per step `key, sub = split(key)`,
  member k draws `randint(split(sub, K)[k], (bs,), 0, n)`), without and
  with the EWC penalty: each step's loss, loss_std and worst grad norm
  within rtol 1e-5, the params after steps 1 and 10 within PARAM_TOL
  (rtol 1e-4 / atol 1e-5, tests/test_torch_train.py).
- A session with early stopping on the same key chain: the same stop
  iteration and best window, the history within rtol 1e-4 / atol 1e-5, the
  restored params within PARAM_TOL; the grad-norm watchdog dumps the worst
  member's own minibatch, where the JAX package's dump holds rows that no
  member drew (a known difference, ROADMAP.md queue 3).

  A pre-activation within float32 rounding of zero falls on either side of
  its ReLU in the two frameworks, and its unit's gradient then differs as
  a whole (ROADMAP.md queue 3); the torch-vs-JAX train tests therefore use
  minibatches whose nearest pre-activation is above 1e-6, checked at every
  step here. K members draw K minibatches a step, so the steps run at
  batch 8 and the session at batch 4 with short windows (one at batch 16
  met 1.4e-7 at its third step and parted from JAX's there).
- `compute_fisher`: one Fisher a member within rtol 1e-3 / atol 1e-9 (as
  the single net's, tests/test_torch_train.py).
- Checkpoints: the port's round trip, a JAX ensemble checkpoint written
  here and read without flax, and the refusals by name.
- A 3-move lp slice with the ensemble as the evaluator against the JAX
  move program (its Pallas kernels interpreted), at tests/test_ensemble.py's
  search shape (B=4, 3 sims, pools 256, table 512, depth 32): every
  integer equal, statistics within rtol 1e-5 / atol 1e-5. The nets'
  outputs differ between the frameworks by float32 rounding (the VV net's
  bound is rtol 1e-4), and the backups carry it: one variance of 1024
  was 1.07e-6 relative off after move 2, over the rtol 1e-6 of the
  stub-net slices.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.ops import tree_walk as JW
from tetris_mcts_tpu.search import mcts as JM
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.ensemble import EnsembleVVModel as JEnsemble
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu_torch.env import engine as E
from tetris_mcts_tpu_torch.models.nets import VVNet
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.train.ensemble import (EnsembleVVModel, ensemble_opt_state_from_jax,
                                                  ensemble_params_from_jax)
from tetris_mcts_tpu_torch.train.trainer import VVModel, _state_from_flax
from torch_parity import JaxKeyPlanes, jax_move_program, run_slice
from torch_train_cases import min_nonzero_preactivation

torch.set_num_threads(1)

K = 3
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "model_vv.msgpack")
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


class JaxMemberIndexSource:
    """The JAX ensemble's minibatch key chain: the session seed ->
    PRNGKey, then per step `key, sub = split(key)` and member k's
    `randint(split(sub, K)[k], (bs,), 0, n)`: (K, bs) indices."""

    def __init__(self, k=K):
        self.k = k
        self.drawn = []

    def start(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n, bs):
        self.key, sub = jax.random.split(self.key)
        idx = member_idx(sub, self.k, n, bs)
        self.drawn.append(idx)
        return torch.as_tensor(idx)


def member_idx(sub, k, n, bs):
    return np.stack([np.array(jax.random.randint(kk, (bs,), 0, n))
                     for kk in jax.random.split(sub, k)])


def columns(n, seed=0, vmax=50.0):
    rng = np.random.RandomState(seed)
    return [rng.randint(-1, 2, (n, 20, 10)).astype(np.int8),
            rng.uniform(0, vmax, n).astype(np.float32),
            rng.uniform(0, 30, n).astype(np.float32),
            rng.uniform(1, 5, n).astype(np.float32)]


def as_jax(cols):
    return (jnp.asarray(cols[0], jnp.float32)[..., None], *(jnp.asarray(c) for c in cols[1:]))


def as_port(cols):
    return (torch.as_tensor(cols[0]).float()[:, None], *(torch.as_tensor(c) for c in cols[1:]))


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def port_of(jm, seed=0, **kw):
    """The port's ensemble with `jm`'s weights and bounds; `seed` is jm's,
    so the two sessions' shuffles and session seeds (RandomState(seed + 1))
    agree."""
    m = EnsembleVVModel(jm.n_models, seed=seed, device="cpu", **kw)
    m.load_state(*ensemble_params_from_jax(np_tree(jm.params), jm.ubound, jm.lbound,
                                           jm.n_models))
    return m


def stacked(tree, k=K):
    """A JAX stacked param tree (leading K axis) in the port's layout."""
    p = np_tree(tree)
    sds = [_state_from_flax(jax.tree.map(lambda x: x[i], p)) for i in range(k)]
    return {n: torch.stack([sd[n] for sd in sds]) for n in sds[0]}


def nearest_preactivation(m, states, idx):
    """The smallest non-zero |pre-activation| of every member on its own
    minibatch states[idx[k]] (float64, tests/torch_train_cases.py)."""
    return min(min_nonzero_preactivation(member_net(m, k), states[idx[k]])
               for k in range(m.n_models))


def member_net(m, k):
    net = VVNet()
    net.load_state_dict({n: p[k].detach() for n, p in m.params.items()})
    return net


def assert_params_close(m, jparams, **tol):
    want = stacked(jparams, m.n_models)
    for n, p in m.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n,
                                   **(tol or PARAM_TOL))


@pytest.fixture(scope="module")
def jm():
    return JEnsemble(n_models=K, seed=0)


def _packed(n=48, seed=1):
    return np.random.RandomState(seed).randint(0, 2**20, (n, 20)).astype(np.uint32)


def test_forward_matches_jax(jm):
    m = port_of(jm)
    packed = _packed()
    imgs = JE.unpack_obs(jnp.asarray(packed))[..., None].astype(jnp.float32)
    x = E.unpack_obs(torch.as_tensor(packed.view(np.int32)))[:, None].float()
    boards = x[:, 0].numpy().astype(np.int8)
    v, var = m.inference(boards)
    jv, jvar = jm.inference(boards)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(var, jvar, rtol=1e-4, atol=1e-2)
    mv, mvar = m.member_inference(boards)
    jmv, jmvar = jm.member_inference(boards)
    assert mv.shape == (K, 48)
    np.testing.assert_allclose(mv, jmv, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(mvar, jmvar, rtol=1e-4, atol=1e-2)
    # the law of total variance on the port's own members
    np.testing.assert_allclose(v[:, 0], mv.mean(0), rtol=1e-6)
    np.testing.assert_allclose(var[:, 0], mvar.mean(0) + mv.var(0), rtol=1e-5)
    f32 = m.apply_fn()(x)
    jf32 = jm.apply_fn()(jm.params, jm.ubound, imgs)
    np.testing.assert_allclose(f32[0].numpy(), np.asarray(jf32[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(f32[1].numpy(), np.asarray(jf32[1]), rtol=1e-4, atol=1e-2)
    bf = m.apply_fn(torch.bfloat16)(x)
    jbf = jm.apply_fn(jnp.bfloat16)(jm.params, jm.ubound, imgs)
    ub = np.asarray(jm.ubound)
    assert bf[0].dtype == torch.float32
    np.testing.assert_allclose(bf[0].numpy(), np.asarray(jbf[0], np.float32), rtol=0,
                               atol=0.02 * ub[0])
    np.testing.assert_allclose(bf[1].numpy(), np.asarray(jbf[1], np.float32), rtol=0,
                               atol=0.02 * ub[1])
    with pytest.raises(ValueError, match="n_models >= 2"):
        EnsembleVVModel(1, device="cpu")


@pytest.mark.parametrize("ewc", [False, True])
def test_train_steps_match_jax(jm, ewc):
    """10 steps on the K-member key chain; with `ewc` a non-zero lambda, a
    random Fisher a member and anchors away from the params."""
    m = port_of(jm)
    cols = columns(64)
    jd, td = as_jax(cols), as_port(cols)
    lam = 0.7 if ewc else 0.0
    fisher = jax.tree.map(jnp.zeros_like, jm.params)
    p0 = jm.params
    if ewc:
        rng = np.random.RandomState(5)
        leaves, tdef = jax.tree.flatten(jm.params)
        fisher = jax.tree.unflatten(tdef, [jnp.asarray(rng.uniform(0, 2, l.shape), jnp.float32)
                                           for l in leaves])
        p0 = jax.tree.unflatten(tdef, [l + jnp.asarray(rng.normal(0, 0.05, l.shape), jnp.float32)
                                       for l in leaves])
        m.fisher, m.p0 = stacked(fisher), stacked(p0)
    # key chains whose 30 minibatches keep every pre-activation beyond 1e-6
    key = jax.random.PRNGKey(5 if ewc else 1)
    params, opt = jm.params, jm.opt_state
    for step in range(10):
        key, sub = jax.random.split(key)
        params, opt, met, _ = jm._train_step(params, opt, jm.ubound, jd, sub, fisher, p0,
                                             jnp.float32(lam), 8)
        idx = member_idx(sub, K, 64, 8)
        assert nearest_preactivation(m, td[0], idx) > 1e-6, step
        loss, per, gnorm = m.train_step(td, torch.as_tensor(idx), lam)
        assert per.shape == (K, 8) and gnorm.shape == (K,)
        for got, want in ((loss, met["loss"]),
                          (per.std(1, correction=0).mean(), met["loss_std"]),
                          (gnorm[int(gnorm.argmax())], met["grad_norm"])):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        if step in (0, 9):
            assert_params_close(m, params)
    assert m.opt.count == 10 and (np.asarray(opt[1][0].count) == 10).all()


def test_session_matches_jax(jm, tmp_path):
    """A session (shuffle, rescale, early stopping, best-params restore,
    the grad-norm watchdog) on the same key chain."""
    m = port_of(jm, index_source=JaxMemberIndexSource())
    jm2 = JEnsemble(n_models=K, seed=0)
    norms, nearest = [], []
    step = m.train_step

    def watched(data, idx, lam=0.0):
        nearest.append(nearest_preactivation(m, data[0], idx))
        out = step(data, idx, lam)
        norms.append(out[2].clone())
        return out

    m.train_step = watched
    cols = columns(160, seed=29)
    args = dict(batch_size=4, iters_per_val=3, max_iters=300, shuffle=True,
                early_stopping_patience=1, early_stopping_threshold=0.0,
                grad_norm_warn=30.0)
    jlog, plog = [], []
    jh = jm2.train_data(cols, log=jlog.append, dump_dir=str(tmp_path / "j"), **args)
    ph = m.train_data(cols, log=plog.append, dump_dir=str(tmp_path / "p"), **args)
    assert min(nearest) > 1e-6
    assert [h[0] for h in ph] == [h[0] for h in jh]
    assert ph[-1][0] < 300, "early stopping never fired"
    np.testing.assert_allclose(np.array(ph)[:, 1:], np.array(jh)[:, 1:], rtol=1e-4, atol=1e-5)
    stars = lambda log: [ln.endswith("*") for ln in log if ln.startswith("Iteration")]
    assert stars(plog) == stars(jlog) and not stars(plog)[-1]
    assert_params_close(m, jm2.params)
    np.testing.assert_array_equal(m.ubound.numpy(), np.asarray(jm2.ubound))

    # the watchdog: the last dump is the worst member's minibatch of the
    # last flagged step (at most 4 a window), in both packages' order
    warn = lambda log: [ln for ln in log if ln.startswith("Large gradient")]
    assert len(warn(plog)) == len(warn(jlog)) > 0
    g = torch.stack(norms).numpy()
    win = args["iters_per_val"]
    last = None
    for w0 in range(0, len(g), win):
        flagged = np.nonzero(g[w0:w0 + win].max(1) > args["grad_norm_warn"])[0][:4]
        if len(flagged):
            last = w0 + flagged[-1]
    # the shuffled training rows the session drew from
    perm = np.random.RandomState(0 + 1).permutation(160)  # the session's shuffle
    train_states = cols[0][perm][:-16]
    drawn = m.index_source.drawn[last]
    got = np.load(tmp_path / "p" / "dump_grad.npz")["states"][..., 0]
    np.testing.assert_array_equal(got, train_states[drawn[g[last].argmax()]])
    want = np.load(tmp_path / "j" / "dump_grad.npz")["states"][..., 0]
    assert all(not np.array_equal(want, train_states[d]) for d in drawn), \
        "the JAX dump holds a member's minibatch"


def test_compute_fisher_matches_jax(jm):
    m = port_of(jm)
    cols = columns(8, seed=6)
    jm2 = JEnsemble(n_models=K, seed=0)
    jm2.compute_fisher(cols)
    m.compute_fisher(cols)
    want = stacked(jm2.fisher)
    for n, f in m.fisher.items():
        assert f.shape[0] == K
        np.testing.assert_allclose(f.numpy(), want[n].numpy(), rtol=1e-3, atol=1e-9, err_msg=n)
        assert torch.equal(m.p0[n], m.params[n].detach())
    assert any(not torch.allclose(f[0], f[1]) for f in m.fisher.values())


def test_checkpoints_and_refusals(jm, tmp_path):
    m = port_of(jm)
    cols = as_port(columns(32, seed=4))
    for i in range(3):
        m.train_step(cols, torch.arange(i, 16 * K + i).reshape(K, 16) % 32)
    m.ubound = torch.tensor([123.5, 456.25])
    path = str(tmp_path / "ck" / "ens.pt")
    m.save(path)
    r = EnsembleVVModel(K, seed=9, device="cpu")
    assert r.load(path)
    for n in m.names:
        assert torch.equal(m.params[n], r.params[n])
    for a, b in zip(m.opt.mu + m.opt.nu, r.opt.mu + r.opt.nu):
        assert torch.equal(a, b)
    assert r.opt.count == 3 and torch.equal(r.ubound, m.ubound)
    assert torch.equal(r._ubound_floor, m.ubound)
    assert not EnsembleVVModel(K, device="cpu").load(str(tmp_path / "missing.pt"))

    # a JAX ensemble checkpoint, written here, read without flax
    jpath = str(tmp_path / "ens.msgpack")
    jm.save(jpath)
    p = EnsembleVVModel(K, seed=9, device="cpu")
    assert p.load(jpath)
    assert_params_close(p, jm.params, rtol=0, atol=0)
    blob = pickle.load(open(jpath, "rb"))
    from tetris_mcts_tpu_torch.train import flax_msgpack
    mu, nu, count = ensemble_opt_state_from_jax(
        flax_msgpack.msgpack_restore(blob["opt_state"]), K)
    for n, a, b in zip(p.names, p.opt.mu, p.opt.nu):
        assert torch.equal(a, mu[n]) and torch.equal(b, nu[n])
    assert p.opt.count == count == 0
    np.testing.assert_array_equal(p.ubound.numpy(), np.asarray(jm.ubound))

    # the refusals, by name
    with pytest.raises(ValueError, match="3-member ensemble, not of a 2-member"):
        EnsembleVVModel(2, device="cpu").load(jpath)
    with pytest.raises(ValueError, match="3-member ensemble, not of a 2-member"):
        EnsembleVVModel(2, device="cpu").load(path)
    with pytest.raises(ValueError, match="one VV net, not of a 3-member"):
        EnsembleVVModel(K, device="cpu").load(CKPT)
    single = str(tmp_path / "single.pt")
    VVModel(device="cpu").save(single)
    with pytest.raises(ValueError, match="another of the port's nets"):
        EnsembleVVModel(K, device="cpu").load(single)
    with pytest.raises(ValueError, match="JAX checkpoint of a 3-member ensemble.*--ensemble 3"):
        VVModel(device="cpu").load(jpath)
    with pytest.raises(ValueError, match="3-member ensemble, not of one VV net"):
        VVModel(device="cpu").load(path)
    with pytest.raises(ValueError, match="one VV net, not of an ensemble"):
        ensemble_params_from_jax(np_tree(JVVModel(seed=0).params), jm.ubound, jm.lbound, K)


# the search shape of tests/test_ensemble.py::test_ensemble_drives_search
SLICE_JCFG = JT.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=32)
SLICE_TCFG = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=32)
SLICE_B, SLICE_SIMS, SLICE_MOVES = 4, 3, 3


def test_lp_slice_with_the_ensemble_matches_jax(jm, monkeypatch):
    monkeypatch.setattr(JW, "use_walk_kernels", lambda: True)
    move_j = jax_move_program(JM.nn_child_evaluator(jm.apply_fn()), SLICE_JCFG, SLICE_SIMS,
                              "lp")
    m = port_of(jm)
    planes = JaxKeyPlanes(0)
    move_t = M.make_move_fn(M.nn_child_evaluator(m.apply_fn()),
                            M.SearchConfig(tree=SLICE_TCFG, sims=SLICE_SIMS), planes)
    run_slice(move_j, jm.params, jm.ubound, move_t, planes, SLICE_JCFG, SLICE_TCFG, SLICE_B,
              SLICE_MOVES, dict(rtol=1e-5, atol=1e-5), final_select=False)


@pytest.mark.parametrize("kind", ["one net", "ensemble"])
def test_inference_stochastic_matches_jax(jm, kind):
    """`inference_stochastic` draws normal(value, sqrt(variance)) from the
    model's RandomState(seed + 1), as the JAX package's VVModel does (the
    ensemble inherits it on its combined outputs): the same draws on the
    same weights, within the VV net's bounds, two calls in a row."""
    from tetris_mcts_tpu_torch.train.trainer import params_from_jax

    if kind == "ensemble":
        j, m = JEnsemble(n_models=K, seed=0), port_of(jm)
        j.params = jm.params
    else:
        j, m = JVVModel(seed=0), VVModel(seed=0, device="cpu")
        m.load_state(*params_from_jax(np_tree(j.params), j.ubound, j.lbound))
    boards = columns(16, seed=2)[0]
    for _ in range(2):
        (jv, jvar), (v, var) = j.inference_stochastic(boards), m.inference_stochastic(boards)
        np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(var, jvar, rtol=1e-4, atol=1e-2)
