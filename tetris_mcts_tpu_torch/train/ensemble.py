"""The deep ensemble of K VV nets (counterpart of the reference package's
`train/ensemble.py` `EnsembleVVModel`), with the `VVModel` API: inference,
`apply_fn` for the search, `train_data`, `compute_fisher`, save and load.

The K members' parameters live stacked on a leading axis (`params`, a
dict of (K, ...) tensors in `VVNet`'s layout). The forward runs all K
members at once (`stacked_outputs`, which the Bayesian net's MC draws
share): each conv is one convolution over the K members' filters side by
side (grouped by member after the first), on channels-last activations,
and each linear one batched product. At the search's 448 boards
and K = 5 this took 1.07 ms of device time, 64 launches and 0.95 ms a call
on an NVIDIA H100 80GB HBM3 at 700 W, against 2.47 ms, 42 and 2.01 ms for
`torch.func.vmap` over `functional_call` (whose grouped NCHW convolutions
cuDNN transposes) and 0.91 ms, 111 and 2.02 ms for a loop over the members
(`chip_smoke.py`'s ensemble phase). The bf16 body, the float32 head and the
TF32-off convs are `VVNet`'s.

Inference combines the members by the law of total variance, in the
reference's order of operations: value = mean_k v_k, variance = mean_k
var_k + var_k(v), the population variance mean_k (v_k - value)^2. The
combined (value, variance) is what `apply_fn` gives every VV search
evaluator.

Training: each step, member k trains on its own minibatch (the index
source draws (K, batch) indices) with its own loss, the weighted loss plus
its own EWC penalty; one Yogi over the stacked tensors is K independent
Yogis, since the update (weight decay included) is elementwise. A step's
loss and loss_std are the means over the members, its grad norm the worst
member's (the first of the largest); the validation loss is the mean over
the members of (mean, std). The session loop is `VVModel.train_data`'s:
the grad-norm watchdog dumps the worst member's own minibatch (the JAX
package recomputes a single net's minibatch there, which no member drew).
`compute_fisher` computes one diagonal Fisher a member, at that member's
params, which become its anchor.

Checkpoints: the port's own format (`torch.save` of the stacked params,
the Yogi state, the bounds and K; default `ENS_DEFAULT_CKPT`), or a JAX
ensemble checkpoint, read without flax (`train/flax_msgpack.py`): its
leaves carry the leading K axis, split by `ensemble_params_from_jax` and
`ensemble_opt_state_from_jax`. A K that does not match, and a checkpoint
of one net, are refused by name.
"""

from __future__ import annotations

import copy
import os
import zipfile

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import stack_module_state

from tetris_mcts_tpu_torch.models.nets import VVNet, tf32_off
from tetris_mcts_tpu_torch.train.optim import Yogi
from tetris_mcts_tpu_torch.train.trainer import (ENS_DEFAULT_CKPT, TorchIndexSource, VVModel,
                                                 _boards, _find_moments, _read_jax,
                                                 _save_torch, _state_from_flax,
                                                 jax_ensemble_members)


def _member(tree, k):
    """Member k of a (nested dict of) numpy arrays with a leading K axis."""
    if isinstance(tree, dict):
        return {key: _member(v, k) for key, v in tree.items()}
    return np.asarray(tree)[k]


def _stacked(trees):
    """flax param trees of the K members -> a state dict of (K, ...)
    tensors in `VVNet`'s layout."""
    sds = [_state_from_flax(t) for t in trees]
    return {n: torch.stack([sd[n] for sd in sds]) for n in sds[0]}


def ensemble_params_from_jax(params_np, ubound, lbound, n_models: int):
    """A JAX ensemble's params (nested dict of numpy arrays, each with a
    leading K axis) -> (stacked state dict, ubound, lbound). Refuses a
    single net's params and a K other than `n_models`."""
    p = params_np.get("params", params_np)
    kernel = np.asarray(p["conv1"]["kernel"])
    if kernel.ndim != 5:
        raise ValueError("these are the params of one VV net, not of an ensemble")
    if kernel.shape[0] != n_models:
        raise ValueError(f"the params hold a {kernel.shape[0]}-member ensemble, not "
                         f"{n_models} members")
    as_t = lambda x: torch.from_numpy(np.array(x, np.float32))
    return _stacked([_member(p, k) for k in range(n_models)]), as_t(ubound), as_t(lbound)


def ensemble_opt_state_from_jax(opt_state_np, n_models: int):
    """A JAX ensemble's Yogi state (every leaf with a leading K axis, the
    count one a member) -> (stacked mu, stacked nu, count). The members'
    counts must agree (they step together)."""
    st = _find_moments(opt_state_np, ("mu", "nu"))
    if st is None:
        raise ValueError("no Yogi moments (mu, nu) in this optimizer state")
    counts = np.asarray(st["count"]).reshape(-1)
    if counts.shape[0] != n_models or (counts != counts[0]).any():
        raise ValueError(f"the Yogi counts {counts.tolist()} are not one count for "
                         f"{n_models} members")
    return (*(_stacked([_member(st[m], k) for k in range(n_models)]) for m in ("mu", "nu")),
            int(counts[0]))


def stacked_outputs(params, imgs, ubound, lbound, compute_dtype=None, per_member_imgs=False):
    """`VVNet`'s forward for K nets at once: params {name: (K, ...)} in
    `VVNet`'s layout; imgs (n, 1, 20, 10) shared by all, or (K, n, 1, 20,
    10), a set a net. Returns (K, n, 2). Each conv runs the K nets' filters
    side by side (the first grouped by net only when each has its own
    images) on channels-last activations, each linear as a batched
    product; `compute_dtype` covers the body, the head runs in float32."""
    K = params["conv1.weight"].shape[0]
    dt = compute_dtype or torch.float32
    w = lambda name: params[name].to(dt)
    x = imgs.to(dt)
    if per_member_imgs:  # a net's images in its own input channel
        x = x.transpose(0, 1).reshape(imgs.shape[1], K, *imgs.shape[-2:])
    n = x.shape[0]
    with tf32_off():
        x = F.relu(F.conv2d(x, w("conv1.weight").flatten(0, 1), w("conv1.bias").flatten(),
                            groups=K if per_member_imgs else 1))
        x = x.contiguous(memory_format=torch.channels_last)
        for c in ("conv2", "conv3"):
            x = F.relu(F.conv2d(x, w(f"{c}.weight").flatten(0, 1), w(f"{c}.bias").flatten(),
                                groups=K))
    x = x.contiguous().reshape(n, K, -1).transpose(0, 1)  # (K, n, (c, y, x))
    x = F.relu(torch.baddbmm(w("fc1.bias")[:, None], x, w("fc1.weight").transpose(1, 2)))
    out = torch.baddbmm(params["fc_out.bias"][:, None], x.float(),
                        params["fc_out.weight"].transpose(1, 2))
    return torch.sigmoid(out) * ubound + lbound


class EnsembleVVModel(VVModel):
    """K VV nets on `device`, stacked, with the `VVModel` API (see the
    module docstring). Member k starts from `VVNet(seed=seed * K + k)`."""

    def __init__(self, n_models: int = 5, seed: int = 0, device="cuda",
                 checkpoint_path: str = ENS_DEFAULT_CKPT, index_source=None,
                 loss_type: str = "kldiv", weighted: bool = True, lr: float = 1e-3,
                 weight_decay: float = 1e-3, ewc: bool = False, ewc_lambda: float = 1.0):
        if n_models < 2:
            raise ValueError("an ensemble needs n_models >= 2")
        self.n_models = n_models
        members = [VVNet(seed=seed * n_models + k) for k in range(n_models)]
        stacked, _ = stack_module_state(members)
        # set before VVModel's constructor, whose p0 is a _params_copy()
        self.params = {n: stacked[n].detach().to(device).requires_grad_()
                       for n, _ in members[0].named_parameters()}
        super().__init__(seed, device, checkpoint_path,
                         index_source or TorchIndexSource(device, (n_models,)),
                         loss_type, weighted, lr, weight_decay, ewc, ewc_lambda)
        # the layout for `compute_fisher`'s functional calls, no weights
        self.net = copy.deepcopy(members[0]).to("meta")
        self.opt = Yogi([self.params[n] for n in self.names], lr=lr,
                        weight_decay=weight_decay)
        self.fisher = {n: torch.zeros_like(p) for n, p in self.params.items()}

    def _params_copy(self):
        return {n: p.detach().clone() for n, p in self.params.items()}

    def _set_params(self, params):
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(params[n])

    def load_state(self, state_dict, ubound, lbound):
        """Set the stacked params (K, ...) and the bounds; the params
        become every member's EWC anchor."""
        self._set_params(state_dict)
        self.ubound = torch.as_tensor(ubound, dtype=torch.float32, device=self.device)
        self.lbound = torch.as_tensor(lbound, dtype=torch.float32, device=self.device)
        self.p0 = self._params_copy()

    def member_net(self, k: int) -> VVNet:
        """A `VVNet` on the model's device holding a copy of member k's
        weights."""
        net = VVNet().to(self.device)
        net.load_state_dict({n: p[k].detach() for n, p in self.params.items()})
        return net

    # ---------------------------------------------------------- inference
    def _outputs(self, params, imgs, compute_dtype=None, per_member_imgs=False):
        """The K members' outputs (K, n, 2) (`stacked_outputs`)."""
        return stacked_outputs(params, imgs, self.ubound, self.lbound, compute_dtype,
                               per_member_imgs)

    @staticmethod
    def combine(v, var):
        """(K, n) member values and variances -> the ensemble's (n,) value
        and variance (law of total variance, population variance)."""
        mean = v.mean(0)
        return mean, var.mean(0) + ((v - mean) ** 2).mean(0)

    def apply_fn(self, compute_dtype=None):
        """imgs (n, 1, 20, 10) -> the combined (v (n,), var (n,)), as
        `VVModel.apply_fn`; `compute_dtype` applies to this closure only."""

        @torch.no_grad()
        def f(imgs):
            out = self._outputs(self.params, imgs.to(self.device), compute_dtype)
            return self.combine(out[..., 0], out[..., 1])

        return f

    @torch.no_grad()
    def member_inference(self, boards):
        """boards (N, 20, 10) or (N, 1, 20, 10) -> every member's (value
        (K, N), variance (K, N)) numpy arrays."""
        out = self._outputs(self.params, _boards(boards, self.device))
        return out[..., 0].cpu().numpy(), out[..., 1].cpu().numpy()

    # ----------------------------------------------------------- training
    def per_sample_loss(self, states, value, variance, weight):
        """Weighted per-sample losses (K, B) of the members on minibatches
        (K, B, ...), a minibatch a member."""
        out = self._outputs(self.params, states, per_member_imgs=True)
        return self._weighted_loss(out.reshape(-1, 2), value.reshape(-1), variance.reshape(-1),
                                   weight.reshape(-1)).reshape(value.shape)

    def loss_and_grads(self, batch, lam: float = 0.0):
        """(member losses (K,), per-sample losses (K, B), grads (K, ...) in
        `names` order) of minibatches (K, B, ...): member k's loss is its
        mean weighted loss plus 0.5 * lam * sum F_k (p_k - p0_k)^2, and
        its gradient is that loss's alone (the members share nothing)."""
        params = [self.params[n] for n in self.names]
        with tf32_off():
            per = self.per_sample_loss(*batch)
            loss = per.mean(1)
            if lam:
                penalty = sum((self.fisher[n] * (p - self.p0[n]) ** 2).flatten(1).sum(1)
                              for n, p in zip(self.names, params))
                loss = loss + 0.5 * lam * penalty
            grads = torch.autograd.grad(loss.sum(), params)
        return loss.detach(), per.detach(), grads

    def train_step(self, data, idx, lam: float = 0.0):
        """One Yogi step of every member on its rows idx[k] of data (states,
        value, variance, weight); idx (K, B). Returns (the members' mean
        loss, per-sample losses (K, B), each member's grad norm (K,)) on
        the device; the reference's loss_std is the members' mean of
        per.std(1, correction=0)."""
        batch = tuple(d[idx] for d in data)
        loss, per, grads = self.loss_and_grads(batch, lam)
        # sums of squares, then the root: torch's CPU norm along a dimension
        # accumulates in order (1e-5 off on fc1's 458752 entries), its sum
        # does not
        gnorm = torch.stack([g.flatten(1).square().sum(1) for g in grads]).sum(0).sqrt()
        self.opt.step(grads)
        return loss.mean(), per, gnorm

    @torch.no_grad()
    def eval_loss(self, data):
        """The members' mean of (mean, std) of their per-sample losses over
        data, device scalars."""
        states, value, variance, weight = data
        K = self.n_models
        with tf32_off():
            out = self._outputs(self.params, states)
            per = self._weighted_loss(out.reshape(-1, 2), value.repeat(K),
                                      variance.repeat(K), weight.repeat(K)).reshape(K, -1)
        return per.mean(1).mean(), per.std(1, correction=0).mean()

    def compute_fisher(self, data):
        """One empirical Fisher a member, at its own params, over the same
        rows; every member's params become its anchor p0."""
        fishers = [self._fisher_at({n: p[k].detach() for n, p in self.params.items()}, data)
                   for k in range(self.n_models)]
        self.fisher = {n: torch.stack([f[n] for f in fishers]) for n in self.names}
        self.p0 = self._params_copy()

    # --------------------------------------------------------- persistence
    def save(self, path: str | None = None, verbose: bool = False):
        """Write the stacked params, the Yogi state, the bounds and K to
        `path` (`torch.save`, through a temporary file). Refuses to
        overwrite a file that is not a checkpoint of the port."""
        mu, nu, count = self.opt.state()
        cpu = lambda xs: {n: x.detach().cpu() for n, x in zip(self.names, xs)}
        _save_torch(path or self.checkpoint_path,
                    {"ens_params": cpu(self.params[n] for n in self.names),
                     "yogi_mu": cpu(mu), "yogi_nu": cpu(nu), "yogi_count": count,
                     "ubound": self.ubound.cpu(), "lbound": self.lbound.cpu(),
                     "n_models": self.n_models}, verbose)

    def load(self, path: str | None = None):
        """Read a checkpoint written by `save`, or a JAX ensemble checkpoint
        (converted), of K = n_models members. The loaded bounds become the
        floor of later rescales. Returns False when the file does not
        exist."""
        path = path or self.checkpoint_path
        if not os.path.isfile(path):
            print("Checkpoint not found, using default model", flush=True)
            return False
        K = self.n_models
        if not zipfile.is_zipfile(path):
            blob = _read_jax(path, "vv")
            k = jax_ensemble_members(blob)
            if k != K:
                raise ValueError(f"{path} is a JAX checkpoint of "
                                 f"{f'a {k}-member ensemble' if k else 'one VV net'}, "
                                 f"not of a {K}-member ensemble")
            self.load_state(*ensemble_params_from_jax(blob["params"], blob["ubound"],
                                                      blob["lbound"], K))
            self.load_opt_state(*ensemble_opt_state_from_jax(blob["opt_state"], K))
        else:
            blob = torch.load(path, map_location=self.device, weights_only=True)
            if blob.get("n_models") != K:
                what = (f"a {blob['n_models']}-member ensemble" if "n_models" in blob
                        else "another of the port's nets")
                raise ValueError(f"{path} is a checkpoint of {what}, not of a {K}-member "
                                 "ensemble")
            self.load_state(blob["ens_params"], blob["ubound"], blob["lbound"])
            self.load_opt_state(blob["yogi_mu"], blob["yogi_nu"], blob["yogi_count"])
        self._ubound_floor = self.ubound.clone()
        return True
