"""The Bayesian VV net (counterpart of the reference package's
`train/bayesian.py` `BBBVVModel`): a variational posterior N(mu, sigma^2)
on every weight of `VVNet`, sigma = softplus(rho) = logaddexp(rho, 0),
trained by one of two methods:

- "adam", Bayes-by-backprop: the loss is the mean over `mc_iters`
  reparameterised draws w = mu + sigma * eps of the weighted Gaussian-LL
  data loss, plus `kl_weight` times KL(q || N(0, prior_sigma^2)) summed over
  all weights; `Adam` (optax.adam) steps mu and rho.
- "bgd", the closed-form Bayesian gradient descent update: from the draws'
  gradients g of the data loss, E[g] and E[g eps] (non-finite entries
  zeroed),
      mu    <- mu - mean_eta * sigma^2 * E[g]
      sigma <- s / (r + x) where x > 0, else s * (r - x),
               x = sigma * E[g eps] / 2, r = sqrt(1 + x^2)
  then rho = the inverse softplus of sigma floored at 1e-6; no KL term, no
  optimizer state.

At the start rho = log(expm1(prior_sigma / 10)) everywhere, mu is
`VVNet(seed)`'s init, and the bounds are the VV net's. A session
(`train_data`) rescales ubound to [max value, max(max variance,
VARIANCE_BOUND)], normalises the weights by their mean, and runs `iters`
steps, each on a minibatch drawn with replacement.

The draws are inputs of a step (`train_step(data, idx, eps)`): the
minibatch indices and every weight's eps for every MC draw, in the net's
layout ((mc, *shape) a weight). `draws` makes them (`TorchBBBDraws`: one
flat normal draw a step from a torch.Generator on the device, seeded per
session from the model's `np.random.RandomState(seed + 1)`); a test can
replace it with one that replays the reference's key chain. The
`mc_iters` draws run as one forward of `mc_iters` nets
(`ensemble.stacked_outputs`, the ensemble's).

`inference` uses the posterior means; `inference_stochastic` samples one
set of weights from the model's generator, seeded by the model's
RandomState as the reference seeds its key (the stream is torch's, not
threefry's).
"""

from __future__ import annotations

import numpy as np
import torch

from tetris_mcts_tpu_torch.models import losses as L
from tetris_mcts_tpu_torch.models.nets import VVNet, tf32_off
from tetris_mcts_tpu_torch.train.ensemble import stacked_outputs
from tetris_mcts_tpu_torch.train.optim import Adam
from tetris_mcts_tpu_torch.train.trainer import _boards, _col

SIGMA_FLOOR = 1e-6  # BGD's floor on sigma before the inverse softplus


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class TorchBBBDraws:
    """A step's draws from a torch.Generator on `device`: minibatch indices
    (batch,) with replacement, and eps {name: (mc, *shape)} standard
    normals, all weights' from one flat draw."""

    def __init__(self, device, mc: int, shapes: dict):
        self.gen = torch.Generator(device=device)
        self.device, self.mc, self.shapes = device, mc, shapes
        self.sizes = [int(np.prod(s)) for s in shapes.values()]

    def start(self, seed: int):
        self.gen.manual_seed(int(seed))

    def eps(self, mc: int):
        flat = torch.randn(mc, sum(self.sizes), generator=self.gen, device=self.device)
        return {n: x.reshape(mc, *s) for (n, s), x in
                zip(self.shapes.items(), flat.split(self.sizes, dim=1))}

    def __call__(self, n: int, batch: int):
        idx = torch.randint(0, n, (batch,), generator=self.gen, device=self.device)
        return idx, self.eps(self.mc)


class BBBVVModel:
    """Variational VV net on `device`: `mu` and `rho`, dicts of tensors in
    `VVNet`'s layout (see the module docstring)."""

    def __init__(self, lr: float = 1e-3, mc_iters: int = 5, prior_sigma: float = 0.1,
                 kl_weight: float = 1e-4, seed: int = 0, device="cuda",
                 method: str = "adam", mean_eta: float = 1.0, draws=None):
        if method not in ("adam", "bgd"):
            raise ValueError(f"unknown method {method!r}")
        self.device = torch.device(device)
        self.method, self.mc_iters, self.mean_eta = method, mc_iters, mean_eta
        self.prior_var, self.kl_weight = prior_sigma**2, kl_weight
        net = VVNet(seed=seed)
        self.names = [n for n, _ in net.named_parameters()]
        self.mu = {n: p.detach().to(self.device).requires_grad_()
                   for n, p in net.named_parameters()}
        rho0 = float(np.log(np.expm1(prior_sigma / 10.0)))
        self.rho = {n: torch.full_like(p, rho0).requires_grad_() for n, p in self.mu.items()}
        self.ubound = torch.tensor([1e2, 1e3], device=self.device)
        self.lbound = torch.tensor([0.0, L.VARIANCE_BOUND], device=self.device)
        self.opt = Adam([self.mu[n] for n in self.names] + [self.rho[n] for n in self.names],
                        lr=lr)
        self._rng = np.random.RandomState(seed + 1)
        self.gen = torch.Generator(device=self.device)
        self.draws = draws or TorchBBBDraws(
            self.device, mc_iters, {n: tuple(p.shape) for n, p in self.mu.items()})

    @torch.no_grad()
    def load_state(self, mu, rho):
        """Set the posterior's mu and rho from state dicts of the net's
        layout."""
        for n in self.names:
            self.mu[n].copy_(mu[n])
            self.rho[n].copy_(rho[n])

    # ---------------------------------------------------------- the forward
    def data_losses(self, w, batch):
        """The weighted Gaussian-LL data loss of each draw (mc,): the mean
        over the minibatch of weight * gaussian_ll, the target variance
        floored at VARIANCE_BOUND."""
        states, value, variance, weight = batch
        out = stacked_outputs(w, states, self.ubound, self.lbound)
        variance = torch.clamp_min(variance, L.VARIANCE_BOUND)
        per = weight * L.gaussian_ll(out[..., 1], out[..., 0], variance, value)
        return per.mean(1)

    def kl_to_prior(self):
        """KL(N(mu, sigma^2) || N(0, prior_sigma^2)) summed over all weights."""
        pv = self.prior_var
        total = 0.0
        for n in self.names:
            m, s2 = self.mu[n], softplus(self.rho[n]) ** 2
            total = total + 0.5 * torch.sum(s2 / pv + m * m / pv - 1.0 - torch.log(s2 / pv))
        return total

    # ----------------------------------------------------------- training
    def adam_loss_and_grads(self, batch, eps):
        """(loss, grads of mu then rho in `names` order) of one minibatch
        and its draws: the mean data loss over the draws plus kl_weight *
        KL."""
        params = [self.mu[n] for n in self.names] + [self.rho[n] for n in self.names]
        with tf32_off():
            w = {n: self.mu[n] + softplus(self.rho[n]) * eps[n] for n in self.names}
            loss = self.data_losses(w, batch).mean() + self.kl_weight * self.kl_to_prior()
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), grads

    def draw_grads(self, batch, eps):
        """(the draws' data losses (mc,), each draw's gradient {name: (mc,
        ...)} of its data loss at its weights), the BGD step's input."""
        with torch.no_grad():
            sigma = {n: softplus(self.rho[n]) for n in self.names}
            w = {n: (self.mu[n] + sigma[n] * eps[n]).requires_grad_() for n in self.names}
        with tf32_off():
            losses = self.data_losses(w, batch)
            grads = torch.autograd.grad(losses.sum(), [w[n] for n in self.names])
        return losses.detach(), dict(zip(self.names, grads))

    @torch.no_grad()
    def bgd_update(self, grads, eps):
        """The closed-form BGD update of mu and rho from the draws' gradients
        and their eps (see the module docstring)."""
        fin = lambda a: torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        for n in self.names:
            s = softplus(self.rho[n])
            e_g = fin(grads[n].mean(0))
            e_ge = fin((grads[n] * eps[n]).mean(0))
            self.mu[n].copy_(self.mu[n] - self.mean_eta * s**2 * e_g)
            x = s * e_ge / 2.0
            r = torch.sqrt(1.0 + x * x)
            s_new = torch.clamp_min(torch.where(x > 0, s / (r + x), s * (r - x)),
                                    SIGMA_FLOOR)
            self.rho[n].copy_(s_new + torch.log1p(-torch.exp(-s_new)))

    def train_step(self, data, idx, eps):
        """One step on the rows `idx` of data (states, value, variance,
        weight) with the draws eps {name: (mc, ...)}. Returns the loss (a
        device scalar): the Adam method's whole loss, or the mean data loss
        of the BGD method's draws."""
        batch = tuple(d[idx] for d in data)
        if self.method == "adam":
            loss, grads = self.adam_loss_and_grads(batch, eps)
            self.opt.step(grads)
            return loss
        losses, grads = self.draw_grads(batch, eps)
        self.bgd_update(grads, eps)
        return losses.mean()

    def train_data(self, data, batch_size: int = 128, iters: int = 500, log=print):
        """One session of `iters` steps over data = [states, values,
        variance, weights]: rescaled bounds, weights normalised to mean 1,
        minibatches with replacement from `draws` (seeded from the model's
        RandomState). Returns [(iteration, loss)] every 100 iterations,
        logged; the loss is read from the device only then."""
        dev = self.device
        states = _boards(data[0], dev)
        value, variance, weight = (_col(x, dev) for x in data[1:4])
        weight = weight / weight.mean()
        self.ubound = torch.stack([value.max(), torch.clamp_min(
            variance.max(), L.VARIANCE_BOUND)]).float()
        cols = (states, value, variance, weight)
        self.draws.start(self._rng.randint(2**31))
        hist = []
        for it in range(iters):
            idx, eps = self.draws(states.shape[0], batch_size)
            loss = self.train_step(cols, idx, eps)
            if (it + 1) % 100 == 0:
                log(f"Iteration:{it + 1:6d}  loss:{float(loss):8.4f}")
                hist.append((it + 1, float(loss)))
        return hist

    # ---------------------------------------------------------- inference
    @torch.no_grad()
    def _infer(self, w, boards):
        out = stacked_outputs({n: p[None] for n, p in w.items()},
                              _boards(boards, self.device), self.ubound, self.lbound)[0]
        return out[:, 0].cpu().numpy()[:, None], out[:, 1].cpu().numpy()[:, None]

    def inference(self, boards):
        """boards (N, 20, 10) or (N, 1, 20, 10) -> (value (N, 1), variance
        (N, 1)) numpy arrays of the posterior means' net."""
        return self._infer(self.mu, boards)

    def inference_stochastic(self, boards):
        """The outputs of one set of weights drawn from the posterior, from
        the model's generator seeded by its RandomState (Thompson
        exploration)."""
        self.gen.manual_seed(self._rng.randint(2**31))
        with torch.no_grad():
            w = {n: self.mu[n] + softplus(self.rho[n]) * torch.randn(
                p.shape, generator=self.gen, device=self.device) for n, p in self.mu.items()}
        return self._infer(w, boards)
