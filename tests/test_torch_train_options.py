"""`VVModel` sessions of the port under each training option that
`cli/train` sets (loss type, unweighted rows, learning rate and weight
decay, EWC inside a session, early stopping with threshold 0), against the
JAX package's `VVModel` on the CPU.

Both models start from the same weights (`params_from_jax`) and draw the
same minibatches (the JAX key chain, `JaxIndexSource`), on the rows of
tests/test_torch_train.py's session test; held as that test holds the
default session: the same stop iteration and best windows, the history
within rtol 1e-4 / atol 1e-5, the params within rtol 1e-4 / atol 1e-5.

Sessions run 2 windows of 5 steps (threshold 0: until it stops). The mae
session runs one window: mae's gradient is the sign of each residual,
which training drives towards zero, and a residual within float32
rounding of zero can take either sign in two float32 computations (as a
ReLU input can, ROADMAP queue 3); on these rows such a flip moves the
grad norm of step 10 by 5.9e-4 relative, and the trajectories part from
there. The 9 steps before it agree within 3e-5 relative.
"""

import numpy as np
import pytest
import torch

from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from test_torch_train import JaxIndexSource, assert_params_close, columns, port_of

torch.set_num_threads(1)

SESSION = dict(batch_size=16, iters_per_val=5, max_iters=10, early_stopping_patience=2,
               shuffle=True)
# case -> (VVModel kwargs, train_data kwargs)
CASES = {
    **{f"loss_{k}": (dict(loss_type=k), {}) for k in
       ("kldiv", "mle", "weak", "mle_approx", "mse")},
    # one window (the module docstring says why)
    "loss_mae": (dict(loss_type="mae"), dict(max_iters=5)),
    "unweighted": (dict(weighted=False), {}),
    "unweighted_per_session": ({}, dict(weighted=False)),
    "ewc": (dict(ewc=True, ewc_lambda=0.5), {}),
    "threshold_0": ({}, dict(early_stopping_threshold=0.0, early_stopping_patience=1,
                             max_iters=40)),
    "lr_and_decay": (dict(lr=3e-3, weight_decay=1e-2), {}),
}


@pytest.mark.parametrize("case", CASES)
def test_session_option_matches_jax(case, tmp_path):
    model_kw, data_kw = CASES[case]
    jm = JVVModel(seed=3, **model_kw)
    m = port_of(jm, seed=3, index_source=JaxIndexSource(), **model_kw)
    cols = columns(160, seed=3)
    if model_kw.get("ewc"):
        # an anchor and a Fisher from a first batch of rows, in both
        anchor = columns(32, seed=5)
        jm.compute_fisher(anchor)
        m.compute_fisher(anchor)
    jlog, plog = [], []
    dump = dict(dump_dir=str(tmp_path / "dump"))
    jh = jm.train_data(cols, log=jlog.append, **dump, **{**SESSION, **data_kw})
    ph = m.train_data(cols, log=plog.append, **dump, **{**SESSION, **data_kw})
    assert [h[0] for h in ph] == [h[0] for h in jh]
    np.testing.assert_allclose(np.array(ph)[:, 1:], np.array(jh)[:, 1:], rtol=1e-4, atol=1e-5)
    stars = lambda log: [ln.endswith("*") for ln in log if ln.startswith("Iteration")]
    assert stars(plog) == stars(jlog)
    assert_params_close(m, jm.params)
    assert m.weighted == jm.weighted and m.loss_type == jm.loss_type
    if case == "threshold_0":
        assert ph[-1][0] < 40, "early stopping never fired"
    elif case not in ("loss_kldiv", "loss_mle"):  # mle is kldiv's other name
        # the option changes the session: the defaults give another history
        base = port_of(JVVModel(seed=3), seed=3, index_source=JaxIndexSource())
        if model_kw.get("ewc"):
            base.compute_fisher(anchor)
        bh = base.train_data(cols, log=lambda s: None, **dump, **{**SESSION, **data_kw,
                                                                      "weighted": True})
        assert not np.allclose(np.array(bh)[:, 1:], np.array(ph)[:, 1:], rtol=1e-3)
