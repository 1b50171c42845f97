"""The value/variance net (`VVNet`), the value/policy net (`VPNet`), the
distributional value net (`DistNet`) and the DQN nets (`QNet`, `DistQNet`)
as NCHW `nn.Module`s.

Counterpart of the reference package's `models/nets.py`. `VVNet`: three 3x3
VALID convs (32 filters) with ReLU, FC 1792 -> 256 with ReLU, FC 256 -> 2,
then sigmoid scaled to [lbound, lbound + ubound]. The bounds are arguments,
not weights (the reference rescales them between training sessions).

Inputs are (n, 1, 20, 10) float images (0 empty, 1 locked, -1 piece). The
JAX package computes the forward as XLA convolutions outside any Pallas
kernel, so the port uses `F.conv2d` / `F.linear`. `compute_dtype`
(bfloat16 for `--bf16`) covers the conv and fc1 body; the 2-unit head
always runs in float32, as in the reference.

`VPNet`: two 3x3 VALID convs (32 filters), each followed by GroupNorm (8
groups) and ReLU, then two streams from the 16 x 6 x 32 features: FC 3072
-> 128 with ReLU -> 1 value (its bias initialised to 100), and FC 3072 ->
128 with ReLU -> 7 policy logits. The GroupNorm is flax's: statistics in
float32 over each group's channels and positions, the variance as
E[x^2] - E[x]^2 clamped at 0, epsilon 1e-6, then (x - mean) * (rsqrt(var +
eps) * scale) + bias. `compute_dtype` covers the conv, norm and 128-unit FC
body; both heads run in float32.

`DistNet`: `VVNet`'s body (three 3x3 VALID convs of 32 filters with ReLU,
FC 1792 -> 256 with ReLU) and a float32 head FC 256 -> atoms, then a
softmax: (n, atoms) probabilities. `compute_dtype` covers the body.

`QNet` and `DistQNet` are the DQN agents' nets: two 3x3 VALID convs (32
filters for `QNet`, 16 for `DistQNet`) with ReLU, FC (filters x 16 x 6) ->
128 with ReLU, then FC 128 -> 7 action values (`QNet`) or FC 128 -> 7 x
atoms logits and a softmax over the atoms of each action (`DistQNet`, (n,
7, atoms)). Both run in float32 only.

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


class _ConvFC(nn.Module):
    """Three 3x3 VALID convs with ReLU, FC 1792 -> n_fc with ReLU, and a
    float32 head FC n_fc -> n_out: the body of `VVNet` and `DistNet`."""

    def __init__(self, n_out: int, filters: int = 32, n_fc: int = 256, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, filters, 3)
        self.conv2 = nn.Conv2d(filters, filters, 3)
        self.conv3 = nn.Conv2d(filters, filters, 3)
        self.fc1 = nn.Linear(filters * 14 * 4, n_fc)
        self.fc_out = nn.Linear(n_fc, n_out)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.conv3, self.fc1, self.fc_out):
                fan_in = m.weight[0].numel()
                _lecun_normal_(m.weight, fan_in, gen)
                m.bias.zero_()

    def logits(self, x, compute_dtype=None, head=None):
        """The head's outputs; `head`, when given, takes the flattened conv
        features in place of fc1 and fc_out (the model-parallel learner's
        split pair, `parallel/mesh.py`)."""
        dt = compute_dtype or torch.float32
        x = x.to(dt)
        with tf32_off():
            for conv in (self.conv1, self.conv2, self.conv3):
                x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt)))
        x = x.flatten(1)  # (c, y, x) order
        if head is not None:
            return head(x)
        x = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        return F.linear(x.float(), self.fc_out.weight, self.fc_out.bias)


class VVNet(_ConvFC):
    def __init__(self, filters: int = 32, n_fc: int = 256, seed: int = 0):
        super().__init__(2, filters, n_fc, seed)

    def forward(self, x, ubound, lbound, compute_dtype=None, head=None):
        return torch.sigmoid(self.logits(x, compute_dtype, head)) * ubound + lbound


class DistNet(_ConvFC):
    def __init__(self, atoms: int = 50, filters: int = 32, n_fc: int = 256, seed: int = 0):
        super().__init__(atoms, filters, n_fc, seed)

    def forward(self, x, compute_dtype=None):
        """x (n, 1, 20, 10) -> (n, atoms) probabilities, float32."""
        return torch.softmax(self.logits(x, compute_dtype), -1)


GN_GROUPS, GN_EPS = 8, 1e-6  # flax GroupNorm(num_groups=8), its default epsilon


def group_norm(x, weight, bias, groups: int = GN_GROUPS, eps: float = GN_EPS):
    """flax's GroupNorm on NCHW x: float32 statistics per (sample, group),
    var = max(E[x^2] - E[x]^2, 0); the result in x's dtype."""
    n, c = x.shape[:2]
    xf = x.float()
    g = xf.reshape(n, groups, -1)
    mean = g.mean(-1)
    var = torch.clamp_min((g * g).mean(-1) - mean * mean, 0.0)
    rep = lambda s: s.repeat_interleave(c // groups, 1)[:, :, None, None]
    mul = torch.rsqrt(rep(var) + eps) * weight[None, :, None, None]
    y = (xf - rep(mean)) * mul + bias[None, :, None, None]
    return y.to(x.dtype)


class VPNet(nn.Module):
    def __init__(self, filters: int = 32, n_fc: int = 128, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, filters, 3)
        self.norm1 = nn.GroupNorm(GN_GROUPS, filters, eps=GN_EPS)
        self.conv2 = nn.Conv2d(filters, filters, 3)
        self.norm2 = nn.GroupNorm(GN_GROUPS, filters, eps=GN_EPS)
        self.fc_v = nn.Linear(filters * 16 * 6, n_fc)
        self.value = nn.Linear(n_fc, 1)
        self.fc_p = nn.Linear(filters * 16 * 6, n_fc)
        self.policy = nn.Linear(n_fc, 7)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.fc_v, self.value, self.fc_p, self.policy):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()
            self.value.bias.fill_(100.0)  # the reference's optimistic value head

    def forward(self, x, compute_dtype=None):
        """x (n, 1, 20, 10) -> (value (n, 1), policy logits (n, 7)), float32."""
        dt = compute_dtype or torch.float32
        x = x.to(dt)
        with tf32_off():
            for conv, norm in ((self.conv1, self.norm1), (self.conv2, self.norm2)):
                x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt))
                x = F.relu(group_norm(x, norm.weight, norm.bias))
        x = x.flatten(1)  # (c, y, x) order
        v = F.relu(F.linear(x, self.fc_v.weight.to(dt), self.fc_v.bias.to(dt)))
        p = F.relu(F.linear(x, self.fc_p.weight.to(dt), self.fc_p.bias.to(dt)))
        return (F.linear(v.float(), self.value.weight, self.value.bias),
                F.linear(p.float(), self.policy.weight, self.policy.bias))


class QNet(nn.Module):
    def __init__(self, n_out: int = 7, filters: int = 32, n_fc: int = 128, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, filters, 3)
        self.conv2 = nn.Conv2d(filters, filters, 3)
        self.fc1 = nn.Linear(filters * 16 * 6, n_fc)
        self.fc_q = nn.Linear(n_fc, n_out)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.fc1, self.fc_q):
                _lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()

    def forward(self, x):
        """x (n, 1, 20, 10) -> (n, 7) action values, float32."""
        with tf32_off():
            for conv in (self.conv1, self.conv2):
                x = F.relu(F.conv2d(x.float(), conv.weight, conv.bias))
            x = F.relu(F.linear(x.flatten(1), self.fc1.weight, self.fc1.bias))
            return F.linear(x, self.fc_q.weight, self.fc_q.bias)


class DistQNet(QNet):
    def __init__(self, atoms: int = 50, filters: int = 16, n_fc: int = 128, seed: int = 0):
        super().__init__(7 * atoms, filters, n_fc, seed)
        self.atoms = atoms

    def forward(self, x):
        """x (n, 1, 20, 10) -> (n, 7, atoms) probabilities, float32."""
        return torch.softmax(super().forward(x).reshape(x.shape[0], 7, self.atoms), -1)
