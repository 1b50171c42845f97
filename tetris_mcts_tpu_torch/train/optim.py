"""Yogi with L2 weight decay, written by hand (counterpart of the reference
package's `train/optim.py` `yogi`: the optax chain
`add_decayed_weights(wd)` then `optax.yogi(lr, eps=eps)`).

One update, for every parameter p with gradient g, in optax's order:

    g  = g + wd * p
    mu = (1 - b1) * g + b1 * mu
    nu = nu - (1 - b2) * sign(nu - g^2) * g^2
    count += 1
    p  = p + -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

mu and nu start at 1e-6. The bias corrections are float32 scalars computed
on the host from the integer `count`, so a step reads nothing back from
the device. The updates run as `torch._foreach_*` ops over all parameters,
one launch per op on a card, not one per parameter.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
# the reference's `yogi()` defaults, the values the self-play CLI trains with
LR, EPS, WEIGHT_DECAY, B1, B2, INITIAL_ACCUMULATOR = 1e-3, 1e-3, 1e-3, 0.9, 0.999, 1e-6


class Yogi:
    """Yogi state (mu, nu, count) for a list of parameter tensors, updated
    in place by `step(grads)`."""

    def __init__(self, params):
        self.params = list(params)
        self.lr, self.eps, self.weight_decay = LR, EPS, WEIGHT_DECAY
        self.b1, self.b2 = B1, B2
        self.mu = [torch.full_like(p, INITIAL_ACCUMULATOR) for p in self.params]
        self.nu = [torch.full_like(p, INITIAL_ACCUMULATOR) for p in self.params]
        self.count = 0

    def _bias_correction(self, decay: float, count: int) -> float:
        """1 - decay^count in float32, as optax computes it."""
        d = torch.tensor(decay, dtype=torch.float32)
        return float(1.0 - torch.pow(d, float(count)))

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
        m_hat = torch._foreach_div(mu, self._bias_correction(self.b1, self.count))
        v_hat = torch._foreach_div(nu, self._bias_correction(self.b2, self.count))
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
