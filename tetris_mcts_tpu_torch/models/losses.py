"""The VV net's losses (counterpart of the reference package's
`models/losses.py`, the value/variance family only). Each returns
per-sample losses (B,); reduction and sample weighting happen in the
trainer (`train/trainer.py`).
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
