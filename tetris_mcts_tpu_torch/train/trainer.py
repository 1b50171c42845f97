"""The VV model: net, output bounds, inference and training (counterpart of
the reference package's `train/trainer.py` `VVModel`).

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

Checkpoints: `save` writes `torch.save` of the net's state dict, the Yogi
state and the bounds (default `DEFAULT_CKPT`); `load` reads it back. A
checkpoint of the JAX package (a pickle of flax bytes) is converted where
flax is installed: `params_from_jax` and `opt_state_from_jax` take its
params and optimizer state as numpy arrays.
"""

from __future__ import annotations

import os
import tempfile
import zipfile

import numpy as np
import torch

from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.models.nets import VVNet, tf32_off
from tetris_mcts_tpu_torch.train.optim import Yogi

VARIANCE_BOUND = L.VARIANCE_BOUND  # reference `variance_bound`
DEFAULT_CKPT = "./checkpoints/model_vv_torch.pt"


def _state_from_flax(p):
    """flax VV param tree (numpy) -> VVNet state dict (torch, float32).

    Conv kernels are HWIO in flax and OIHW here. fc1's input rows follow
    the NHWC flatten (y, x, c) there and the NCHW flatten (c, y, x) here,
    so they are permuted."""
    p = p.get("params", p)
    f32 = lambda x: np.array(x, np.float32)  # a writable copy
    sd = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = torch.from_numpy(
            f32(p[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1).copy())
        sd[f"conv{i}.bias"] = torch.from_numpy(f32(p[f"conv{i}"]["bias"]))
    k1 = f32(p["fc1"]["kernel"])                               # (y*x*c, out)
    C = sd["conv3.weight"].shape[0]
    n_out = k1.shape[1]
    k1 = k1.reshape(14, 4, C, n_out).transpose(2, 0, 1, 3).reshape(-1, n_out)
    sd["fc1.weight"] = torch.from_numpy(k1.T.copy())
    sd["fc1.bias"] = torch.from_numpy(f32(p["fc1"]["bias"]))
    sd["fc_out.weight"] = torch.from_numpy(f32(p["fc_out"]["kernel"]).T.copy())
    sd["fc_out.bias"] = torch.from_numpy(f32(p["fc_out"]["bias"]))
    return sd


def params_from_jax(params_np, ubound, lbound):
    """flax VV params (nested dict of numpy arrays, with or without the
    top-level "params" key) -> (state_dict, ubound, lbound) for `VVNet`."""
    as_t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return _state_from_flax(params_np), as_t(ubound), as_t(lbound)


def opt_state_from_jax(opt_state_np):
    """The reference's Yogi state (the optax chain's state as numpy arrays,
    with its `ScaleByAdamState`) -> (mu state dict, nu state dict, count):
    mu and nu in `VVNet`'s layout, as `params_from_jax` lays out params."""
    def find(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
        for x in s if isinstance(s, (tuple, list)) else ():
            found = find(x)
            if found is not None:
                return found
        return None

    st = find(opt_state_np)
    if st is None:
        raise ValueError("no Yogi moments (mu, nu) in this optimizer state")
    return _state_from_flax(st.mu), _state_from_flax(st.nu), int(np.asarray(st.count))


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


class VVModel:
    """VV net + output bounds on `device`, with Yogi training.

    The loss is `kldiv` and Yogi runs at its defaults (lr 1e-3, weight
    decay 1e-3), as the self-play CLI trains. Sessions weight the loss by
    the weight column, normalised to mean 1, and add no EWC penalty; the
    penalty is `train_step`'s `lam` with `fisher` / `p0` (`compute_fisher`)."""

    def __init__(self, seed: int = 0, device="cuda", checkpoint_path: str = DEFAULT_CKPT,
                 index_source=None):
        self.device = torch.device(device)
        self.net = VVNet(seed=seed).to(self.device)
        self.ubound = torch.tensor([1e2, 1e3], device=self.device)
        self.lbound = torch.tensor([0.0, VARIANCE_BOUND], device=self.device)
        self.loss_fn = L.vv_loss("kldiv")
        self.checkpoint_path = checkpoint_path
        self.names = [n for n, _ in self.net.named_parameters()]
        self.opt = Yogi(self.net.parameters())
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
                   early_stopping: bool = True,
                   early_stopping_patience: int = 10,
                   early_stopping_threshold: float = 1.0, shuffle: bool = False,
                   min_iters: int = 0, max_iters: int = 100000,
                   grad_norm_warn: float = 1e3, dump_dir: str = "./data", log=print):
        """One training session over data = [states, values, variance,
        weights] (numpy arrays or tensors). Returns the history, a list of
        (iteration, train loss, val loss, val std, grad norm) a window."""
        dev = self.device
        states = _boards(data[0], dev)
        value, variance, weight = (_col(x, dev) for x in data[1:4])
        weight = weight / weight.mean()
        n = states.shape[0]
        # validation_rows pins the tail exactly
        n_val = (validation_rows if validation_rows is not None
                 else max(int(n * validation_fraction), 1))
        cols = (states, value, variance, weight)
        if shuffle:
            perm = torch.as_tensor(self._rng.permutation(n), device=dev)
            cols = tuple(d[perm] for d in cols)

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

        train = tuple(d[:-n_val] for d in cols)
        val = tuple(d[-n_val:] for d in cols)
        n_train = n - n_val
        log(f"Training data size: {n_train}    Validation data size: {n_val}")

        fails = 0
        best_val = float("inf")
        best = self._params_copy()
        self.index_source.start(self._rng.randint(2**31))
        history = []
        it = 0
        while it < max_iters:
            k = min(iters_per_val, max_iters - it)
            idxs, losses, gnorms = [], [], []
            for _ in range(k):
                idx = self.index_source(n_train, batch_size)
                loss, _, gnorm = self.train_step(train, idx)
                idxs.append(idx)
                losses.append(loss)
                gnorms.append(gnorm)
            vmean, vstd = self.eval_loss(val)
            # the window's one read from the device
            host = torch.cat([torch.stack(losses), torch.stack(gnorms),
                              torch.stack([vmean, vstd])]).cpu().numpy()
            losses_h, gnorms_h = host[:k], host[k:2 * k]
            it += k
            loss_avg = float(losses_h.mean())
            gnorm_avg = float(gnorms_h.mean())

            for j in np.nonzero(gnorms_h > grad_norm_warn)[0][:4]:  # watchdog
                log(f"Large gradient ({float(gnorms_h[j])}) detected")
                self._dump_grad_batch(tuple(d[idxs[j]] for d in train), dump_dir)

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
                        best = self._params_copy()
                else:
                    fails += 1
                    stop = fails >= early_stopping_patience and it >= min_iters
            log(f"Iteration:{it:7d}  training loss:{loss_avg:6.4f}  "
                f"validation loss:{vmean:6.4f}±{vstd:6.4f}  "
                f"gradient norm:{gnorm_avg:6.3f}    {suffix}")
            history.append((it, loss_avg, vmean, vstd, gnorm_avg))
            if stop:
                break
            # A window of exactly zero gradients: the bounded sigmoid heads
            # are saturated on every sampled row, the loss is constant and
            # the session would spin to max_iters. End it.
            if gnorm_avg == 0.0:
                log(f"Zero-gradient window at iteration {it} — output "
                    "heads saturated on this data; ending session")
                break

        if early_stopping:
            self.net.load_state_dict(best)
        return history

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
        path = path or self.checkpoint_path
        if os.path.isfile(path) and not zipfile.is_zipfile(path):
            raise ValueError(f"refusing to overwrite {path}: it is not a checkpoint "
                             "of the port (torch.save)")
        mu, nu, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        blob = {"net": cpu(self.net.parameters()), "yogi_mu": cpu(mu),
                "yogi_nu": cpu(nu), "yogi_count": count,
                "ubound": self.ubound.cpu(), "lbound": self.lbound.cpu()}
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

    def load(self, path: str | None = None):
        """Read a checkpoint written by `save`. The loaded bounds become the
        floor of later rescales and the params the EWC anchor p0. Returns
        False when the file does not exist."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        if not zipfile.is_zipfile(path):
            raise ValueError(
                f"{path} is not a checkpoint of the port. A checkpoint of the JAX "
                "package (a pickle of flax bytes) is converted where flax is "
                "installed: params_from_jax and opt_state_from_jax "
                "(tetris_mcts_tpu_torch/train/trainer.py) on its params and "
                "optimizer state, then load_state, load_opt_state and save")
        blob = torch.load(path, map_location=self.device, weights_only=True)
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
