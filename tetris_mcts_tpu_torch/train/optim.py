"""The optimizers, written by hand (counterpart of the reference package's
`train/optim.py`): `Yogi` for the VV net, `AdamAmsgrad` for the VP net and
`Adam` for the DQN nets.

`Yogi` with L2 weight decay is the optax chain `add_decayed_weights(wd)`
then `optax.yogi(lr, eps=eps)`. One update, for every parameter p with gradient g, in optax's order:

    g  = g + wd * p
    mu = (1 - b1) * g + b1 * mu
    nu = nu - (1 - b2) * sign(nu - g^2) * g^2
    count += 1
    p  = p + -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

mu and nu start at 1e-6.

`Adam` is `optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0). mu
and nu start at 0; one update:

    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g^2 + b2 * nu
    count += 1
    p      = p + -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

(`torch.optim.Adam` computes the same update in another order,
lr / (1 - b1^count) times mu / (sqrt(nu) / sqrt(1 - b2^count) + eps).)

`AdamAmsgrad` is `optax.amsgrad(lr)` (optax 0.2.6: `scale_by_amsgrad` then
the learning rate). mu, nu and nu_max start at 0; one update:

    mu     = (1 - b1) * g + b1 * mu
    nu     = (1 - b2) * g^2 + b2 * nu
    count += 1
    nu_max = max(nu_max, nu / (1 - b2^count))
    p      = p + -lr * (mu / (1 - b1^count)) / (sqrt(nu_max) + eps)

The running maximum is of the bias-corrected second moment, as optax takes
it; `torch.optim.Adam(amsgrad=True)` keeps the maximum of the uncorrected
moment and corrects after, a different update.

The bias corrections are float32 scalars computed on the host from the
integer `count`, so a step reads nothing back from the device. The updates
run as `torch._foreach_*` ops over all parameters, one launch per op on a
card, not one per parameter.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1
# the reference's `yogi()` defaults, the values the self-play CLI trains with
LR, EPS, WEIGHT_DECAY, B1, B2, INITIAL_ACCUMULATOR = 1e-3, 1e-3, 1e-3, 0.9, 0.999, 1e-6


AMS_LR, ADAM_EPS = 1e-4, 1e-8  # the reference's VP optimizer (`adam_amsgrad`)
ADAM_LR = 1e-3                  # the DQN nets' `optax.adam(1e-3)`


def bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it (XLA's float32 pow of
    the float32 decay): the power taken in float64 and rounded once, which
    agrees with XLA's on all but 2 of the first 20000 counts. torch's pow
    with a scalar exponent multiplies in float32 and can be an ulp off,
    which 1 - 0.999^3 turns into 2e-5 of the correction."""
    p = np.float32(np.float64(np.float32(decay)) ** int(count))
    return float(np.float32(1.0) - p)


class Yogi:
    """Yogi state (mu, nu, count) for a list of parameter tensors, updated
    in place by `step(grads)`."""

    def __init__(self, params, lr: float = LR, weight_decay: float = WEIGHT_DECAY):
        self.params = list(params)
        self.lr, self.eps, self.weight_decay = lr, EPS, weight_decay
        self.b1, self.b2 = B1, B2
        self.mu = [torch.full_like(p, INITIAL_ACCUMULATOR) for p in self.params]
        self.nu = [torch.full_like(p, INITIAL_ACCUMULATOR) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        p = self.params
        g = torch._foreach_add(grads, torch._foreach_mul(p, self.weight_decay))
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1),
                                torch._foreach_mul(self.mu, self.b1))
        g2 = torch._foreach_mul(g, g)
        s = torch._foreach_sign(torch._foreach_sub(self.nu, g2))
        nu = torch._foreach_sub(self.nu, torch._foreach_mul(
            torch._foreach_mul(s, 1 - self.b2), g2))
        self.count = min(self.count + 1, INT32_MAX)
        m_hat = torch._foreach_div(mu, bias_correction(self.b1, self.count))
        v_hat = torch._foreach_div(nu, bias_correction(self.b2, self.count))
        u = torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(v_hat),
                                                         self.eps))
        torch._foreach_add_(p, torch._foreach_mul(u, -self.lr))
        self.mu, self.nu = list(mu), list(nu)

    def state(self):
        """(mu, nu, count): copies of the moments, and the step count."""
        return [m.clone() for m in self.mu], [v.clone() for v in self.nu], self.count

    def load(self, mu, nu, count: int):
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
        self.count = int(count)


class Adam:
    """Adam state (mu, nu, count) for a list of parameter tensors, updated
    in place by `step(grads)`."""

    def __init__(self, params, lr: float = ADAM_LR):
        self.params = list(params)
        self.lr, self.eps, self.b1, self.b2 = lr, ADAM_EPS, B1, B2
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _corrected_moments(self, grads):
        """Update mu, nu and the count; return the bias-corrected moments."""
        grads = list(grads)
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                torch._foreach_mul(self.mu, self.b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1 - self.b2),
                                torch._foreach_mul(self.nu, self.b2))
        self.count = min(self.count + 1, INT32_MAX)
        self.mu, self.nu = list(mu), list(nu)
        return (torch._foreach_div(mu, bias_correction(self.b1, self.count)),
                torch._foreach_div(nu, bias_correction(self.b2, self.count)))

    def _apply(self, m_hat, second):
        u = torch._foreach_div(m_hat, torch._foreach_add(torch._foreach_sqrt(second),
                                                         self.eps))
        torch._foreach_add_(self.params, torch._foreach_mul(u, -self.lr))

    @torch.no_grad()
    def step(self, grads):
        self._apply(*self._corrected_moments(grads))

    def state(self):
        """(mu, nu, count): copies of the moments, and the step count."""
        return [m.clone() for m in self.mu], [v.clone() for v in self.nu], self.count

    def load(self, mu, nu, count: int):
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
        self.count = int(count)


class AdamAmsgrad(Adam):
    """Adam-amsgrad state (mu, nu, nu_max, count) for a list of parameter
    tensors, updated in place by `step(grads)`."""

    def __init__(self, params, lr: float = AMS_LR):
        super().__init__(params, lr)
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        m_hat, v_hat = self._corrected_moments(grads)
        self.nu_max = list(torch._foreach_maximum(self.nu_max, v_hat))
        self._apply(m_hat, self.nu_max)

    def state(self):
        """(mu, nu, nu_max, count): copies of the moments, and the step count."""
        mu, nu, count = super().state()
        return mu, nu, [v.clone() for v in self.nu_max], count

    def load(self, mu, nu, nu_max, count: int):
        super().load(mu, nu, count)
        with torch.no_grad():
            for dst, src in zip(self.nu_max, nu_max):
                dst.copy_(torch.as_tensor(src, dtype=dst.dtype))
