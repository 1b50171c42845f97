"""The nets' losses (counterpart of the reference package's
`models/losses.py`: the value/variance family, the VP net's two and the
distributional net's cross-entropy). Each
returns per-sample losses (B,); reduction and sample weighting happen in
the trainer (`train/trainer.py`).
"""

from __future__ import annotations

import torch

VARIANCE_BOUND = 1e-1  # reference `variance_bound`


def gaussian_ll(var_pred, mean_pred, var, mean):
    """Gaussian KL divergence between the target N(mean, var) and the
    prediction N(mean_pred, var_pred) up to constants:
    log v_p + ((mu - mu_p)^2 + v) / v_p - log v - 1."""
    return (torch.log(var_pred) + ((mean - mean_pred) ** 2 + var) / var_pred
            - torch.log(var) - 1.0)


def weak_gaussian_ll(var_pred, mean_pred, var, mean, sigma=3.0):
    """Huberized Gaussian LL: squared error within sigma * std of the
    prediction, linear beyond."""
    diff = torch.abs(mean - mean_pred)
    threshold = sigma * torch.sqrt(var_pred)
    vloss = torch.where(diff < threshold, diff**2,
                        2.0 * threshold * diff - threshold**2)
    return torch.log(var_pred) + (var + vloss) / var_pred - torch.log(var) - 1.0


def mle_approx(var_pred, mean_pred, var, mean):
    return (1.0 - var_pred / var) ** 2 + 2.0 * (mean - mean_pred) ** 2 / var


def mae(pred, target):
    return torch.abs(pred - target)


def mse(pred, target):
    return (pred - target) ** 2


def vv_loss(loss_type: str):
    """A VV loss by name: f(var_pred, mean_pred, var, mean) -> (B,)."""
    if loss_type in ("kldiv", "mle"):
        return gaussian_ll
    if loss_type == "weak":
        return weak_gaussian_ll
    if loss_type == "mle_approx":
        return mle_approx
    if loss_type == "mae":
        return lambda vp, mp, v, m: mae(mp, m) + mae(vp, v)
    if loss_type == "mse":
        return lambda vp, mp, v, m: mse(mp, m) + mse(vp, v)
    raise ValueError(f"unknown loss_type {loss_type!r}")


def smooth_l1(pred, target, beta=1.0):
    """The VP net's value loss: 0.5 * d^2 / beta where d = |pred - target|
    < beta, else d - 0.5 * beta."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def kl_div_policy(logits, target_probs, label_smoothing=0.1):
    """The VP net's policy loss: KL(t || softmax(logits)) with the target
    smoothed to t = target * (1 - s) + s / n; the log of t is taken of t
    clipped at 1e-12. Per-sample (B,)."""
    n = logits.shape[-1]
    t = target_probs * (1.0 - label_smoothing) + label_smoothing / n
    logp = torch.log_softmax(logits, dim=-1)
    return torch.sum(t * (torch.log(torch.clamp_min(t, 1e-12)) - logp), dim=-1)


def categorical_ce(pred_probs, target_probs):
    """The distributional net's loss: the cross-entropy -sum t log p of the
    target distribution t against the predicted p, p clipped at 1e-12.
    Per-sample (B,)."""
    return -torch.sum(target_probs * torch.log(torch.clamp_min(pred_probs, 1e-12)), dim=-1)
