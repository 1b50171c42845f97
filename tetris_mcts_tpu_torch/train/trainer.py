"""The VV, VP and distributional models: nets, inference, training and
checkpoints (counterpart of the reference package's `train/trainer.py`
`VVModel`, `VPModel` and `DistModel`).

Holds the VV net and its output bounds (`ubound` = [100, 1000] and
`lbound` = [0, 0.1] at the start, as the reference sets them), builds the
search evaluator's forward (`apply_fn`, which reads `ubound` at call time,
so a session's rescale reaches the next move), and trains the net with the
reference's semantics (`train_data`): weight normalisation, an optional
shuffle, a validation tail, the output-bound rescale (monotone after a
`load`), minibatches drawn with replacement, a validation loss every
`iters_per_val` steps, early stopping on it with the best params restored,
the grad-norm watchdog and the zero-gradient guard; `train_step` is one
weighted-loss step (plus the EWC penalty) with Yogi (`train/optim.py`).

The JAX package trains through XLA and has no training kernel, so the
port trains with plain torch ops and autograd. On a card a whole step,
backward included, runs with TF32 off (`models/nets.tf32_off`). A step
reads nothing back: a validation window keeps its losses, grad norms and
minibatch indices on the device and reads them once, at its end.

Randomness: the shuffle and the session's minibatch seed come from
`np.random.RandomState(seed + 1)`, as in the reference; the minibatch
indices from `index_source` (`TorchIndexSource`, a torch.Generator on the
device seeded per session), which a test can replace with one that
replays the reference's key chain.

`VPModel` holds the VP net (`models/nets.VPNet`) and trains it with the
reference's semantics: the smooth-L1 value loss plus the label-smoothed
policy KL (`models/losses.py`), weighted, with Adam-amsgrad at lr 1e-4
(`train/optim.AdamAmsgrad`); its session is the same loop
(`_early_stop_fit`) without the VV model's grad-norm watch and bounds.

`DistModel` holds the distributional net (`models/nets.DistNet`, `atoms`
bins) and trains it on target distributions with the reference's
semantics: the categorical cross-entropy, weighted, with Yogi at lr 1e-3
(weight decay 1e-3), on the same session loop, without a grad-norm watch.

Checkpoints: `save` writes `torch.save` of the net's state dict, the
optimizer state (and the VV bounds) (defaults `DEFAULT_CKPT`,
`VP_DEFAULT_CKPT`); `load` reads it back, and reads a checkpoint of the
JAX package too (a pickle of flax msgpack bytes, read without flax by
`train/flax_msgpack.py`), converted by `params_from_jax` +
`opt_state_from_jax` (VV), `vp_params_from_jax` + `vp_opt_state_from_jax`
(VP) or `dist_params_from_jax` + `dist_opt_state_from_jax` (dist). `save`
never overwrites a file that is not the port's, and each model's `load`
refuses another model's checkpoint.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import zipfile

import numpy as np
import torch

from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.models.nets import DistNet, VPNet, VVNet, tf32_off
from tetris_mcts_tpu_torch.train import flax_msgpack
from tetris_mcts_tpu_torch.train.optim import AMS_LR, AdamAmsgrad, Yogi

VARIANCE_BOUND = L.VARIANCE_BOUND  # reference `variance_bound`
DEFAULT_CKPT = "./checkpoints/model_vv_torch.pt"
VP_DEFAULT_CKPT = "./checkpoints/model_vp_torch.pt"
DIST_DEFAULT_CKPT = "./checkpoints/model_dist_torch.pt"
DQN_DEFAULT_CKPT = "./checkpoints/model_dqn_torch.pt"


def _f32(x):
    return np.array(x, np.float32)  # a writable copy


def _conv(sd, p, name):
    """A flax conv (HWIO kernel) as an nn.Conv2d's weight (OIHW) and bias."""
    sd[f"{name}.weight"] = torch.from_numpy(
        _f32(p[name]["kernel"]).transpose(3, 2, 0, 1).copy())
    sd[f"{name}.bias"] = torch.from_numpy(_f32(p[name]["bias"]))


def _dense(sd, p, name, hwc=None):
    """A flax Dense as an nn.Linear. With hwc = (H, W, C), its input rows
    follow flax's NHWC flatten (y, x, c) and are permuted to the NCHW
    flatten (c, y, x) of the port's nets."""
    k = _f32(p[name]["kernel"])                                 # (in, out)
    if hwc is not None:
        H, W, C = hwc
        k = k.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(H * W * C, -1)
    sd[f"{name}.weight"] = torch.from_numpy(k.T.copy())
    sd[f"{name}.bias"] = torch.from_numpy(_f32(p[name]["bias"]))


def _state_from_flax(p):
    """flax VV or Dist param tree (numpy) -> VVNet / DistNet state dict
    (torch, float32): the two nets share their layer names and layout."""
    p = p.get("params", p)
    sd = {}
    for i in (1, 2, 3):
        _conv(sd, p, f"conv{i}")
    _dense(sd, p, "fc1", (14, 4, sd["conv3.weight"].shape[0]))
    _dense(sd, p, "fc_out")
    return sd


def _vp_state_from_flax(p):
    """flax VP param tree (numpy) -> VPNet state dict (torch, float32)."""
    p = p.get("params", p)
    sd = {}
    for i in (1, 2):
        _conv(sd, p, f"conv{i}")
        sd[f"norm{i}.weight"] = torch.from_numpy(_f32(p[f"norm{i}"]["scale"]))
        sd[f"norm{i}.bias"] = torch.from_numpy(_f32(p[f"norm{i}"]["bias"]))
    hwc = (16, 6, sd["conv2.weight"].shape[0])
    for name in ("fc_v", "fc_p"):
        _dense(sd, p, name, hwc)
    for name in ("value", "policy"):
        _dense(sd, p, name)
    return sd


def _q_state_from_flax(p):
    """flax QNet or DistQNet param tree (numpy) -> `QNet` / `DistQNet` state
    dict (torch, float32): the two nets share their layer names and layout."""
    p = p.get("params", p)
    sd = {}
    for i in (1, 2):
        _conv(sd, p, f"conv{i}")
    _dense(sd, p, "fc1", (16, 6, sd["conv2.weight"].shape[0]))
    _dense(sd, p, "fc_q")
    return sd


def params_from_jax(params_np, ubound, lbound):
    """flax VV params (nested dict of numpy arrays, with or without the
    top-level "params" key) -> (state_dict, ubound, lbound) for `VVNet`."""
    as_t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return _state_from_flax(params_np), as_t(ubound), as_t(lbound)


def dist_params_from_jax(params_np):
    """flax DistNet params (nested dict of numpy arrays) -> `DistNet` state
    dict."""
    return _state_from_flax(params_np)


def vp_params_from_jax(params_np):
    """flax VP params (nested dict of numpy arrays) -> `VPNet` state dict."""
    return _vp_state_from_flax(params_np)


def qnet_params_from_jax(params_np):
    """flax QNet params (nested dict of numpy arrays) -> `QNet` state dict."""
    return _q_state_from_flax(params_np)


# DistQNet's layer names and layout are QNet's (16 filters, a 7 x atoms head)
distqnet_params_from_jax = qnet_params_from_jax


def _find_moments(s, fields):
    """The optimizer state's moment record: an optax state object with the
    attributes `fields`, or its flax state-dict form (a dict with those
    keys), found depth first in the chain's tuples (or "0", "1", ... dicts)."""
    if isinstance(s, dict):
        if all(f in s for f in fields):
            return s
        subs = list(s.values())
    elif all(hasattr(s, f) for f in fields):
        return {f: getattr(s, f) for f in fields + ("count",)}
    else:
        subs = list(s) if isinstance(s, (tuple, list)) else []
    for x in subs:
        found = _find_moments(x, fields)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state_np):
    """The reference's Yogi state (the optax chain's state, or its flax
    state dict, as numpy arrays) -> (mu state dict, nu state dict, count):
    mu and nu in `VVNet`'s layout, as `params_from_jax` lays out params."""
    st = _find_moments(opt_state_np, ("mu", "nu"))
    if st is None:
        raise ValueError("no Yogi moments (mu, nu) in this optimizer state")
    return _state_from_flax(st["mu"]), _state_from_flax(st["nu"]), int(np.asarray(st["count"]))


# the DistModel's Yogi chain is the VV model's, on a net of the same layout
dist_opt_state_from_jax = opt_state_from_jax


def vp_opt_state_from_jax(opt_state_np):
    """The reference's Adam-amsgrad state (`ScaleByAmsgradState`, or its
    flax state dict) -> (mu, nu, nu_max state dicts in `VPNet`'s layout,
    count)."""
    st = _find_moments(opt_state_np, ("mu", "nu", "nu_max"))
    if st is None:
        raise ValueError("no Adam-amsgrad moments (mu, nu, nu_max) in this optimizer state")
    return (*(_vp_state_from_flax(st[k]) for k in ("mu", "nu", "nu_max")),
            int(np.asarray(st["count"])))


def adam_opt_state_from_jax(opt_state_np):
    """The DQN nets' optax.adam state (`ScaleByAdamState`, or its flax state
    dict) -> (mu, nu state dicts in `QNet` / `DistQNet`'s layout, count)."""
    st = _find_moments(opt_state_np, ("mu", "nu"))
    if st is None:
        raise ValueError("no Adam moments (mu, nu) in this optimizer state")
    return (_q_state_from_flax(st["mu"]), _q_state_from_flax(st["nu"]),
            int(np.asarray(st["count"])))


def _read_jax(path: str, kind: str):
    """The JAX package's checkpoint at `path` (flax_msgpack), checked to be
    of the `kind` net ("vv": conv3, fc1 and the bounds; "dist": conv3 and
    fc1 without bounds; "vp": the norms and heads; "dqn": conv2 and the Q
    head)."""
    try:
        blob = flax_msgpack.read_jax_checkpoint(path)
    except (ValueError, pickle.UnpicklingError, EOFError) as e:
        raise ValueError(f"{path} is neither a checkpoint of the port (torch.save) nor "
                         f"one of the JAX package ({e})") from e
    p = blob["params"].get("params", blob["params"])
    want = {"vv": ("conv3", "fc1", "fc_out"), "dist": ("conv3", "fc1", "fc_out"),
            "vp": ("norm1", "fc_v", "policy"), "dqn": ("conv2", "fc1", "fc_q")}[kind]
    if not all(k in p for k in want) or (kind != "vp" and ("ubound" in blob) != (kind == "vv")):
        raise ValueError(f"{path} is a JAX checkpoint of another net (params "
                         f"{sorted(p)}), not of the {kind} net")
    return blob


def _save_torch(path: str, blob: dict, verbose: bool):
    """torch.save of blob to path through a temporary file and a rename;
    refuses to overwrite a file that is not a checkpoint of the port."""
    if os.path.isfile(path) and not zipfile.is_zipfile(path):
        raise ValueError(f"refusing to overwrite {path}: it is not a checkpoint "
                         "of the port (torch.save)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if verbose:
        print("Saving model...", flush=True)


class TorchIndexSource:
    """Minibatch indices with replacement from a torch.Generator on
    `device`, seeded at the start of every training session."""

    def __init__(self, device):
        self.gen = torch.Generator(device=device)
        self.device = device

    def start(self, seed: int):
        self.gen.manual_seed(int(seed))

    def __call__(self, n: int, batch: int):
        return torch.randint(0, n, (batch,), generator=self.gen, device=self.device)


def _col(x, device):
    """(N,), (N, 1) or (N, 1, ...) column -> float32 (N,) on device."""
    x = torch.as_tensor(x, device=device).float()
    return x.reshape(x.shape[0])


def _boards(x, device):
    """(N, 20, 10) or (N, 1, 20, 10) getState images -> float32
    (N, 1, 20, 10) on device."""
    x = torch.as_tensor(x, device=device)
    if x.dim() == 3:
        x = x[:, None]
    return x.float()


def _early_stop_fit(model, cols, step, *, batch_size, iters_per_val, validation_fraction,
                    validation_rows, early_stopping, early_stopping_patience,
                    early_stopping_threshold, shuffle, min_iters, max_iters, log,
                    grad_norm_warn=None, dump_dir="./data"):
    """The training session both models run (the reference `train_data`
    loop): an optional shuffle (`model._rng`), a validation tail of
    `validation_rows` rows or `validation_fraction` of them, minibatches
    drawn with replacement by `model.index_source` (seeded from
    `model._rng`), `step(train, idx) -> (loss, per-sample losses, grad
    norm)` a minibatch, a validation loss every `iters_per_val` steps
    (`model.eval_loss`), early stopping on it with the best params restored.

    cols: equal-length device tensors, states first. With `grad_norm_warn`
    (the VV model's session) the grad norm is watched too: windows with a
    step above it dump that minibatch (`model._dump_grad_batch`) into
    `dump_dir`, a window of exactly zero gradients ends the session, and the
    norm is logged and kept as the history's fifth column. Without it (the
    VP model's, as the reference's shared `_early_stop_fit`), the history
    is (iteration, train loss, val loss, val std) a window.

    A step reads nothing back: a window keeps its losses, grad norms and
    minibatch indices on the device and reads them once, at its end."""
    watch = grad_norm_warn is not None
    n = cols[0].shape[0]
    # validation_rows pins the tail exactly
    n_val = (validation_rows if validation_rows is not None
             else max(int(n * validation_fraction), 1))
    if shuffle:
        perm = torch.as_tensor(model._rng.permutation(n), device=cols[0].device)
        cols = tuple(d[perm] for d in cols)
    train = tuple(d[:-n_val] for d in cols)
    val = tuple(d[-n_val:] for d in cols)
    n_train = n - n_val
    log(f"Training data size: {n_train}    Validation data size: {n_val}")

    fails = 0
    best_val = float("inf")
    best = model._params_copy()
    model.index_source.start(model._rng.randint(2**31))
    history = []
    it = 0
    while it < max_iters:
        k = min(iters_per_val, max_iters - it)
        idxs, losses, gnorms = [], [], []
        for _ in range(k):
            idx = model.index_source(n_train, batch_size)
            loss, _, gnorm = step(train, idx)
            idxs.append(idx)
            losses.append(loss)
            gnorms.append(gnorm)
        vmean, vstd = model.eval_loss(val)
        # the window's one read from the device
        host = torch.cat([torch.stack(losses), torch.stack(gnorms),
                          torch.stack([vmean, vstd])]).cpu().numpy()
        losses_h, gnorms_h = host[:k], host[k:2 * k]
        it += k
        loss_avg = float(losses_h.mean())
        gnorm_avg = float(gnorms_h.mean())

        if watch:
            for j in np.nonzero(gnorms_h > grad_norm_warn)[0][:4]:
                log(f"Large gradient ({float(gnorms_h[j])}) detected")
                model._dump_grad_batch(tuple(d[idxs[j]] for d in train), dump_dir)

        vmean = float(host[2 * k])
        vstd = float(host[2 * k + 1]) / n_val**0.5
        suffix = ""
        stop = False
        if early_stopping:
            if vmean - best_val < vstd * early_stopping_threshold:
                fails = 0
                if vmean < best_val:
                    suffix = "*"
                    best_val = vmean
                    best = model._params_copy()
            else:
                fails += 1
                stop = fails >= early_stopping_patience and it >= min_iters
        line = (f"Iteration:{it:7d}  training loss:{loss_avg:6.4f}  "
                f"validation loss:{vmean:6.4f}±{vstd:6.4f}")
        if watch:
            log(f"{line}  gradient norm:{gnorm_avg:6.3f}    {suffix}")
            history.append((it, loss_avg, vmean, vstd, gnorm_avg))
        else:
            log(line)
            history.append((it, loss_avg, vmean, vstd))
        if stop:
            break
        # A window of exactly zero gradients: the bounded sigmoid heads
        # are saturated on every sampled row, the loss is constant and
        # the session would spin to max_iters. End it.
        if watch and gnorm_avg == 0.0:
            log(f"Zero-gradient window at iteration {it} — output "
                "heads saturated on this data; ending session")
            break

    if early_stopping:
        model.net.load_state_dict(best)
    return history


class VVModel:
    """VV net + output bounds on `device`, with Yogi training.

    Options, as the reference's: `loss_type` (one of `models/losses.vv_loss`'s
    names), `weighted` (sessions weight the loss by the weight column,
    normalised to mean 1; else by ones), Yogi's `lr` and `weight_decay`,
    and `ewc` (every step of a session adds 0.5 * `ewc_lambda` * sum F (p -
    p0)^2, with the Fisher F and anchor p0 of `compute_fisher`). The
    defaults (kldiv, weighted, 1e-3, 1e-3, no EWC) are what the self-play
    CLI trains with."""

    def __init__(self, seed: int = 0, device="cuda", checkpoint_path: str = DEFAULT_CKPT,
                 index_source=None, loss_type: str = "kldiv", weighted: bool = True,
                 lr: float = 1e-3, weight_decay: float = 1e-3, ewc: bool = False,
                 ewc_lambda: float = 1.0):
        self.device = torch.device(device)
        self.net = VVNet(seed=seed).to(self.device)
        self.ubound = torch.tensor([1e2, 1e3], device=self.device)
        self.lbound = torch.tensor([0.0, VARIANCE_BOUND], device=self.device)
        self.loss_type = loss_type
        self.loss_fn = L.vv_loss(loss_type)
        self.weighted = weighted
        self.ewc = ewc
        self.ewc_lambda = float(ewc_lambda)
        self.checkpoint_path = checkpoint_path
        self.names = [n for n, _ in self.net.named_parameters()]
        self.opt = Yogi(self.net.parameters(), lr=lr, weight_decay=weight_decay)
        self.fisher = {n: torch.zeros_like(p) for n, p in self.net.named_parameters()}
        self.p0 = self._params_copy()
        self._ubound_floor = None
        self._rng = np.random.RandomState(seed + 1)
        self.index_source = index_source or TorchIndexSource(self.device)

    def _params_copy(self):
        return {n: p.detach().clone() for n, p in self.net.named_parameters()}

    def load_state(self, state_dict, ubound, lbound):
        """Set the net's params and the bounds; the params become the EWC
        anchor p0, as a fresh model's initial params are."""
        self.net.load_state_dict(state_dict)
        self.ubound = torch.as_tensor(ubound, dtype=torch.float32, device=self.device)
        self.lbound = torch.as_tensor(lbound, dtype=torch.float32, device=self.device)
        self.p0 = self._params_copy()

    def load_opt_state(self, mu, nu, count: int):
        """Set the Yogi state from state dicts of mu and nu (and the count)."""
        self.opt.load([mu[n] for n in self.names], [nu[n] for n in self.names], count)

    # ---------------------------------------------------------- inference
    def apply_fn(self, compute_dtype=None):
        """imgs (n, 1, 20, 10) -> (v (n,), var (n,)). `compute_dtype`
        (torch.bfloat16 for --bf16) applies to this closure only; the
        bounds are read at call time."""

        @torch.no_grad()
        def f(imgs):
            out = self.net(imgs.to(self.device), self.ubound, self.lbound,
                           compute_dtype)
            return out[:, 0], out[:, 1]

        return f

    def inference(self, boards):
        """boards (N, 20, 10) or (N, 1, 20, 10) -> (value (N, 1), variance
        (N, 1)) numpy arrays."""
        v, var = self.apply_fn()(_boards(boards, self.device))
        return v.cpu().numpy()[:, None], var.cpu().numpy()[:, None]

    # ----------------------------------------------------------- training
    def _weighted_loss(self, out, value, variance, weight):
        """Per-sample loss of the net's outputs out (B, 2), weighted, the
        target variance clamped to VARIANCE_BOUND."""
        variance = torch.clamp_min(variance, VARIANCE_BOUND)
        return weight * self.loss_fn(out[:, 1], out[:, 0], variance, value)

    def per_sample_loss(self, states, value, variance, weight):
        """Weighted per-sample loss (B,) of the net on states."""
        return self._weighted_loss(self.net(states, self.ubound, self.lbound),
                                   value, variance, weight)

    def loss_and_grads(self, batch, lam: float = 0.0):
        """(loss, per-sample losses, grads in `names` order) of one batch
        (states, value, variance, weight): the mean weighted loss plus
        0.5 * lam * sum F (p - p0)^2."""
        params = list(self.net.parameters())
        with tf32_off():
            per = self.per_sample_loss(*batch)
            loss = per.mean()
            if lam:
                penalty = sum((self.fisher[n] * (p - self.p0[n]) ** 2).sum()
                              for n, p in zip(self.names, params))
                loss = loss + 0.5 * lam * penalty
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), per.detach(), grads

    def train_step(self, data, idx, lam: float = 0.0):
        """One Yogi step on the rows `idx` of data (states, value, variance,
        weight). Returns (loss, per-sample losses, global grad norm) on the
        device; the reference's `loss_std` is `per.std(correction=0)`."""
        batch = tuple(d[idx] for d in data)
        loss, per, grads = self.loss_and_grads(batch, lam)
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.opt.step(grads)
        return loss, per, gnorm

    @torch.no_grad()
    def eval_loss(self, data):
        """(mean, std) of the per-sample loss over data, device scalars."""
        with tf32_off():
            per = self.per_sample_loss(*data)
        return per.mean(), per.std(correction=0)

    def train_data(self, data, batch_size: int = 128, iters_per_val: int = 500,
                   validation_fraction: float = 0.1, validation_rows: int | None = None,
                   weighted: bool | None = None, early_stopping: bool = True,
                   early_stopping_patience: int = 10,
                   early_stopping_threshold: float = 1.0, shuffle: bool = False,
                   min_iters: int = 0, max_iters: int = 100000,
                   grad_norm_warn: float = 1e3, dump_dir: str = "./data", log=print):
        """One training session over data = [states, values, variance,
        weights] (numpy arrays or tensors); `weighted` sets the model's
        option for this and later sessions. Returns the history, a list of
        (iteration, train loss, val loss, val std, grad norm) a window."""
        if weighted is not None:
            self.weighted = weighted
        dev = self.device
        states = _boards(data[0], dev)
        value, variance, weight = (_col(x, dev) for x in data[1:4])
        weight = weight / weight.mean() if self.weighted else torch.ones_like(weight)

        # Rescale the output bounds to the data's max. After a `load` the
        # rescale is monotone: it never shrinks below the bounds the net was
        # trained against, and a raised bound becomes the new floor.
        vmax = value.max()
        varmax = torch.clamp_min(variance.max(), VARIANCE_BOUND)
        if self._ubound_floor is not None:
            vmax = torch.maximum(vmax, self._ubound_floor[0])
            varmax = torch.maximum(varmax, self._ubound_floor[1])
            self._ubound_floor = torch.stack([vmax, varmax])
        self.ubound = torch.stack([vmax, varmax]).float()

        lam = self.ewc_lambda if self.ewc else 0.0
        return _early_stop_fit(
            self, (states, value, variance, weight),
            lambda train, idx: self.train_step(train, idx, lam),
            batch_size=batch_size, iters_per_val=iters_per_val,
            validation_fraction=validation_fraction, validation_rows=validation_rows,
            early_stopping=early_stopping, early_stopping_patience=early_stopping_patience,
            early_stopping_threshold=early_stopping_threshold, shuffle=shuffle,
            min_iters=min_iters, max_iters=max_iters, log=log,
            grad_norm_warn=grad_norm_warn, dump_dir=dump_dir)

    def compute_fisher(self, data):
        """Empirical Fisher (the mean squared per-example gradient) of the
        per-sample loss at the current params; the params become p0."""
        from torch.func import functional_call, grad, vmap

        states = _boards(data[0], self.device)
        value, variance, weight = (_col(x, self.device) for x in data[1:4])
        params = {n: p.detach() for n, p in self.net.named_parameters()}

        def one(p, s, v, var, w):
            out = functional_call(self.net, p, (s[None], self.ubound, self.lbound))
            return self._weighted_loss(out, v[None], var[None], w[None])[0]

        with tf32_off():
            grads = vmap(grad(one), in_dims=(None, 0, 0, 0, 0))(
                params, states, value, variance, weight)
        self.fisher = {n: (g**2).mean(0) for n, g in grads.items()}
        self.p0 = self._params_copy()

    # --------------------------------------------------------- persistence
    def save(self, path: str | None = None, verbose: bool = False):
        """Write the net's params, the Yogi state and the bounds to `path`
        (`torch.save`; written to a temporary file, then renamed). Refuses
        to overwrite a file that is not a checkpoint of the port."""
        mu, nu, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        _save_torch(path or self.checkpoint_path,
                    {"net": cpu(self.net.parameters()), "yogi_mu": cpu(mu),
                     "yogi_nu": cpu(nu), "yogi_count": count,
                     "ubound": self.ubound.cpu(), "lbound": self.lbound.cpu()}, verbose)

    def load(self, path: str | None = None):
        """Read a checkpoint written by `save`, or one of the JAX package
        (its params, Yogi state and bounds, converted). The loaded bounds
        become the floor of later rescales and the params the EWC anchor
        p0. Returns False when the file does not exist."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        if not zipfile.is_zipfile(path):
            blob = _read_jax(path, "vv")
            self.load_state(*params_from_jax(blob["params"], blob["ubound"], blob["lbound"]))
            self.load_opt_state(*opt_state_from_jax(blob["opt_state"]))
        else:
            blob = torch.load(path, map_location=self.device, weights_only=True)
            if "ubound" not in blob:
                raise ValueError(f"{path} is a checkpoint of another of the port's nets, not "
                                 "of the VV net")
            self.load_state(blob["net"], blob["ubound"], blob["lbound"])
            self.load_opt_state(blob["yogi_mu"], blob["yogi_nu"], blob["yogi_count"])
        self._ubound_floor = self.ubound.clone()
        return True

    def _dump_grad_batch(self, batch, dump_dir):
        """The grad-norm watchdog's dump of one minibatch, in the
        reference's file layout (states NHWC (n, 20, 10, 1))."""
        os.makedirs(dump_dir, exist_ok=True)
        states, value, variance, weight = batch
        v, var = self.apply_fn()(states)
        host = lambda x: x.detach().cpu().numpy()
        np.savez(os.path.join(dump_dir, "dump_grad"),
                 states=host(states.permute(0, 2, 3, 1)), value=host(value),
                 variance=host(variance), weight=host(weight),
                 pred_value=host(v), pred_variance=host(var))


class VPModel:
    """VP net on `device`, with Adam-amsgrad training (the reference
    `VPModel`): the per-sample loss is weight * (smooth_l1(v, value) +
    kl_div_policy(logits, policy)); `weighted` sessions weight by the
    weight column normalised to mean 1, else by ones."""

    def __init__(self, seed: int = 0, device="cuda", checkpoint_path: str = VP_DEFAULT_CKPT,
                 index_source=None, lr: float = AMS_LR, weighted: bool = True):
        self.device = torch.device(device)
        self.net = VPNet(seed=seed).to(self.device)
        self.weighted = weighted
        self.checkpoint_path = checkpoint_path
        self.names = [n for n, _ in self.net.named_parameters()]
        self.opt = AdamAmsgrad(self.net.parameters(), lr=lr)
        self._rng = np.random.RandomState(seed + 1)
        self.index_source = index_source or TorchIndexSource(self.device)

    def _params_copy(self):
        return {n: p.detach().clone() for n, p in self.net.named_parameters()}

    def load_state(self, state_dict):
        self.net.load_state_dict(state_dict)

    def load_opt_state(self, mu, nu, nu_max, count: int):
        """Set the optimizer state from state dicts of mu, nu and nu_max."""
        self.opt.load(*([d[n] for n in self.names] for d in (mu, nu, nu_max)), count)

    # ---------------------------------------------------------- inference
    def apply_fn(self, compute_dtype=None):
        """imgs (n, 1, 20, 10) -> (v (n,), policy logits (n, 7)).
        `compute_dtype` (torch.bfloat16 for --bf16) applies to this closure
        only."""

        @torch.no_grad()
        def f(imgs):
            v, logits = self.net(imgs.to(self.device), compute_dtype)
            return v[:, 0], logits

        return f

    def inference(self, boards):
        """boards (N, 20, 10) or (N, 1, 20, 10) -> (value (N, 1), policy
        (N, 7)) numpy arrays; the policy is the logits' softmax."""
        v, logits = self.apply_fn()(_boards(boards, self.device))
        return v.cpu().numpy()[:, None], torch.softmax(logits, -1).cpu().numpy()

    # ----------------------------------------------------------- training
    def per_sample_loss(self, states, value, policy, weight):
        v, logits = self.net(states)
        return weight * (L.smooth_l1(v[:, 0], value) + L.kl_div_policy(logits, policy))

    def loss_and_grads(self, batch):
        """(loss, per-sample losses, grads in `names` order) of one batch
        (states, value, policy, weight)."""
        params = list(self.net.parameters())
        with tf32_off():
            per = self.per_sample_loss(*batch)
            loss = per.mean()
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), per.detach(), grads

    def train_step(self, data, idx):
        """One Adam-amsgrad step on the rows `idx` of data (states, value,
        policy, weight). Returns (loss, per-sample losses, global grad
        norm) on the device."""
        loss, per, grads = self.loss_and_grads(tuple(d[idx] for d in data))
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.opt.step(grads)
        return loss, per, gnorm

    @torch.no_grad()
    def eval_loss(self, data):
        """(mean, std) of the per-sample loss over data, device scalars."""
        with tf32_off():
            per = self.per_sample_loss(*data)
        return per.mean(), per.std(correction=0)

    def train_data(self, data, batch_size: int = 128, iters_per_val: int = 500,
                   validation_fraction: float = 0.1, validation_rows: int | None = None,
                   early_stopping: bool = True, early_stopping_patience: int = 10,
                   early_stopping_threshold: float = 1.0, shuffle: bool = False,
                   min_iters: int = 0, max_iters: int = 100000, log=print):
        """One training session over data = [states, values, policy (7),
        weights]. Returns the history, a list of (iteration, train loss,
        val loss, val std) a window."""
        dev = self.device
        weight = _col(data[3], dev)
        weight = weight / weight.mean() if self.weighted else torch.ones_like(weight)
        cols = (_boards(data[0], dev), _col(data[1], dev),
                torch.as_tensor(data[2], device=dev).float().reshape(-1, 7), weight)
        return _early_stop_fit(
            self, cols, self.train_step, batch_size=batch_size,
            iters_per_val=iters_per_val, validation_fraction=validation_fraction,
            validation_rows=validation_rows, early_stopping=early_stopping,
            early_stopping_patience=early_stopping_patience,
            early_stopping_threshold=early_stopping_threshold, shuffle=shuffle,
            min_iters=min_iters, max_iters=max_iters, log=log)

    # --------------------------------------------------------- persistence
    def save(self, path: str | None = None, verbose: bool = False):
        """Write the net's params and the optimizer state to `path`
        (`torch.save`, through a temporary file). Refuses to overwrite a
        file that is not a checkpoint of the port."""
        mu, nu, nu_max, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        _save_torch(path or self.checkpoint_path,
                    {"net": cpu(self.net.parameters()), "ams_mu": cpu(mu),
                     "ams_nu": cpu(nu), "ams_nu_max": cpu(nu_max), "ams_count": count},
                    verbose)

    def load(self, path: str | None = None):
        """Read a checkpoint written by `save`, or a VP checkpoint of the
        JAX package (converted). Returns False when the file does not
        exist."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        if not zipfile.is_zipfile(path):
            blob = _read_jax(path, "vp")
            self.load_state(vp_params_from_jax(blob["params"]))
            self.load_opt_state(*vp_opt_state_from_jax(blob["opt_state"]))
        else:
            blob = torch.load(path, map_location=self.device, weights_only=True)
            if "ams_mu" not in blob:
                raise ValueError(f"{path} is a checkpoint of another of the port's nets, not "
                                 "of the VP net")
            self.load_state(blob["net"])
            self.load_opt_state(blob["ams_mu"], blob["ams_nu"], blob["ams_nu_max"],
                                blob["ams_count"])
        return True


class DistModel:
    """The distributional net (`atoms` bins) on `device`, with Yogi training
    (the reference `DistModel`): the per-sample loss is weight *
    categorical_ce(net(states), target); `weighted` sessions weight by the
    weight column normalised to mean 1, else by ones."""

    def __init__(self, atoms: int = 50, seed: int = 0, device="cuda",
                 checkpoint_path: str = DIST_DEFAULT_CKPT, index_source=None,
                 lr: float = 1e-3, weighted: bool = True):
        self.device = torch.device(device)
        self.atoms = atoms
        self.net = DistNet(atoms, seed=seed).to(self.device)
        self.weighted = weighted
        self.checkpoint_path = checkpoint_path
        self.names = [n for n, _ in self.net.named_parameters()]
        self.opt = Yogi(self.net.parameters(), lr=lr)
        self._rng = np.random.RandomState(seed + 1)
        self.index_source = index_source or TorchIndexSource(self.device)

    def _params_copy(self):
        return {n: p.detach().clone() for n, p in self.net.named_parameters()}

    def load_state(self, state_dict):
        self.net.load_state_dict(state_dict)

    def load_opt_state(self, mu, nu, count: int):
        """Set the Yogi state from state dicts of mu and nu (and the count)."""
        self.opt.load([mu[n] for n in self.names], [nu[n] for n in self.names], count)

    # ---------------------------------------------------------- inference
    def apply_fn(self, compute_dtype=None):
        """imgs (n, 1, 20, 10) -> (n, atoms) probabilities. `compute_dtype`
        (torch.bfloat16 for --bf16) applies to this closure only."""

        @torch.no_grad()
        def f(imgs):
            return self.net(imgs.to(self.device), compute_dtype)

        return f

    def inference(self, boards):
        """boards (N, 20, 10) or (N, 1, 20, 10) -> (N, atoms) numpy array."""
        return self.apply_fn()(_boards(boards, self.device)).cpu().numpy()

    # ----------------------------------------------------------- training
    def per_sample_loss(self, states, target, weight):
        return weight * L.categorical_ce(self.net(states), target)

    def loss_and_grads(self, batch):
        """(loss, per-sample losses, grads in `names` order) of one batch
        (states, target distributions, weight)."""
        params = list(self.net.parameters())
        with tf32_off():
            per = self.per_sample_loss(*batch)
            loss = per.mean()
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), per.detach(), grads

    def train_step(self, data, idx):
        """One Yogi step on the rows `idx` of data (states, target, weight).
        Returns (loss, per-sample losses, global grad norm) on the device."""
        loss, per, grads = self.loss_and_grads(tuple(d[idx] for d in data))
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.opt.step(grads)
        return loss, per, gnorm

    @torch.no_grad()
    def eval_loss(self, data):
        """(mean, std) of the per-sample loss over data, device scalars."""
        with tf32_off():
            per = self.per_sample_loss(*data)
        return per.mean(), per.std(correction=0)

    def train_data(self, data, batch_size: int = 128, iters_per_val: int = 500,
                   validation_fraction: float = 0.1, validation_rows: int | None = None,
                   early_stopping: bool = True, early_stopping_patience: int = 10,
                   early_stopping_threshold: float = 1.0, shuffle: bool = False,
                   min_iters: int = 0, max_iters: int = 100000, log=print):
        """One training session over data = [states, target distributions
        (N, atoms), weights]. Returns the history, a list of (iteration,
        train loss, val loss, val std) a window."""
        dev = self.device
        weight = _col(data[2], dev)
        weight = weight / weight.mean() if self.weighted else torch.ones_like(weight)
        cols = (_boards(data[0], dev),
                torch.as_tensor(data[1], device=dev).float().reshape(-1, self.atoms), weight)
        return _early_stop_fit(
            self, cols, self.train_step, batch_size=batch_size,
            iters_per_val=iters_per_val, validation_fraction=validation_fraction,
            validation_rows=validation_rows, early_stopping=early_stopping,
            early_stopping_patience=early_stopping_patience,
            early_stopping_threshold=early_stopping_threshold, shuffle=shuffle,
            min_iters=min_iters, max_iters=max_iters, log=log)

    # --------------------------------------------------------- persistence
    def save(self, path: str | None = None, verbose: bool = False):
        """Write the net's params and the Yogi state to `path` (`torch.save`,
        through a temporary file). Refuses to overwrite a file that is not a
        checkpoint of the port."""
        mu, nu, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        _save_torch(path or self.checkpoint_path,
                    {"net": cpu(self.net.parameters()), "yogi_mu": cpu(mu),
                     "yogi_nu": cpu(nu), "yogi_count": count, "atoms": self.atoms}, verbose)

    def load(self, path: str | None = None):
        """Read a checkpoint written by `save`, or a distributional checkpoint
        of the JAX package (converted). Returns False when the file does not
        exist."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        if not zipfile.is_zipfile(path):
            blob = _read_jax(path, "dist")
            self.load_state(dist_params_from_jax(blob["params"]))
            self.load_opt_state(*dist_opt_state_from_jax(blob["opt_state"]))
        else:
            blob = torch.load(path, map_location=self.device, weights_only=True)
            if "atoms" not in blob:
                raise ValueError(f"{path} is a checkpoint of another of the port's nets, not "
                                 "of the distributional net")
            self.load_state(blob["net"])
            self.load_opt_state(blob["yogi_mu"], blob["yogi_nu"], blob["yogi_count"])
        return True
