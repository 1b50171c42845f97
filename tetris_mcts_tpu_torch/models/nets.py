"""The value/variance net (`VVNet`) as an NCHW `nn.Module`.

Counterpart of the reference package's `models/nets.py` `VVNet`: three 3x3
VALID convs (32 filters) with ReLU, FC 1792 -> 256 with ReLU, FC 256 -> 2,
then sigmoid scaled to [lbound, lbound + ubound]. The bounds are arguments,
not weights (the reference rescales them between training sessions).

Inputs are (n, 1, 20, 10) float images (0 empty, 1 locked, -1 piece). The
JAX package computes the forward as XLA convolutions outside any Pallas
kernel, so the port uses `F.conv2d` / `F.linear`. `compute_dtype`
(bfloat16 for `--bf16`) covers the conv and fc1 body; the 2-unit head
always runs in float32, as in the reference.

Precision on a CUDA card: the default (float32) path computes in true
float32. cuDNN convolutions would run in TF32 under PyTorch's default
`torch.backends.cudnn.allow_tf32 = True`, so the forward turns that off
for its convs (and restores it after); the linears follow
`torch.backends.cuda.matmul.allow_tf32`, False by default.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


@contextlib.contextmanager
def tf32_off():
    """True float32 for cuDNN convolutions and cuBLAS matmuls inside the
    block; both settings are restored after. The forward runs in it;
    training wraps a whole step in it too, because autograd runs the
    backward after the forward's own block has exited."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class VVNet(nn.Module):
    def __init__(self, filters: int = 32, n_fc: int = 256, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, filters, 3)
        self.conv2 = nn.Conv2d(filters, filters, 3)
        self.conv3 = nn.Conv2d(filters, filters, 3)
        self.fc1 = nn.Linear(filters * 14 * 4, n_fc)
        self.fc_out = nn.Linear(n_fc, 2)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.conv3, self.fc1, self.fc_out):
                fan_in = m.weight[0].numel()
                _lecun_normal_(m.weight, fan_in, gen)
                m.bias.zero_()

    def forward(self, x, ubound, lbound, compute_dtype=None):
        dt = compute_dtype or torch.float32
        x = x.to(dt)
        with tf32_off():
            for conv in (self.conv1, self.conv2, self.conv3):
                x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt)))
        x = x.flatten(1)  # (c, y, x) order
        x = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = F.linear(x.float(), self.fc_out.weight, self.fc_out.bias)
        return torch.sigmoid(x) * ubound + lbound
