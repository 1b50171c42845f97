"""Helpers for holding a VV or VP train step on two devices, or in two
frameworks, against each other (no JAX here: chip_smoke.py imports it).

A pre-activation within float32 rounding of zero may fall on either side
of its ReLU in two float32 computations; its unit's gradient then differs
as a whole, which no tolerance on the sums covers. `min_nonzero_
preactivation` finds the nearest one (in float64), so a comparison with
another framework can pick a minibatch that holds none. Two devices can
be asked directly: `agreeing_minibatch` picks a minibatch on which both
put every ReLU input on the same side of zero.
"""

import copy

import torch
import torch.nn.functional as F

from tetris_mcts_tpu_torch.models.nets import group_norm, tf32_off


@torch.no_grad()
def min_nonzero_preactivation(net, states):
    """The smallest non-zero |pre-activation| of the VV net's four ReLUs
    on states (n, 1, 20, 10), computed in float64 on the CPU."""
    net = copy.deepcopy(net).cpu().double()
    x, found = states.detach().cpu().double(), []
    for c in (net.conv1, net.conv2, net.conv3):
        z = F.conv2d(x, c.weight, c.bias)
        found.append(z.abs()[z != 0].min())
        x = F.relu(z)
    z = F.linear(x.flatten(1), net.fc1.weight, net.fc1.bias)
    found.append(z.abs()[z != 0].min())
    return float(min(found))


@torch.no_grad()
def relu_masks(net, states):
    """Which inputs of the net's ReLUs are positive on states (n, 1, 20,
    10): the VV net's four, or the VP net's four (after each GroupNorm, and
    the two 128-unit FCs), computed as the float32 forward computes them
    (TF32 off) on the net's own device; returned on the CPU."""
    x, masks = states.to(net.conv1.weight.device, torch.float32), []
    with tf32_off():
        if hasattr(net, "norm1"):  # VPNet
            for c, n in ((net.conv1, net.norm1), (net.conv2, net.norm2)):
                z = group_norm(F.conv2d(x, c.weight, c.bias), n.weight, n.bias)
                masks.append(z > 0)
                x = F.relu(z)
            x = x.flatten(1)
            masks += [F.linear(x, fc.weight, fc.bias) > 0 for fc in (net.fc_v, net.fc_p)]
            return [m.cpu() for m in masks]
        for c in (net.conv1, net.conv2, net.conv3):
            z = F.conv2d(x, c.weight, c.bias)
            masks.append(z > 0)
            x = F.relu(z)
        z = F.linear(x.flatten(1), net.fc1.weight, net.fc1.bias)
        masks.append(z > 0)
    return [m.cpu() for m in masks]


def agreeing_minibatch(net, other, states, batch, seed=0, tries=64):
    """Row indices (batch,) drawn with replacement from a seeded CPU
    generator: the first draw on whose minibatch `net` and `other` (the
    same weights, on two devices) put every ReLU input on the same side of
    zero. Returns (indices, draws made, ReLU inputs that crossed over in
    the draws rejected)."""
    gen = torch.Generator().manual_seed(seed)
    crossed = 0
    for k in range(1, tries + 1):
        idx = torch.randint(0, states.shape[0], (batch,), generator=gen)
        rows = states[idx.to(states.device)]
        n = sum(int((a != b).sum())
                for a, b in zip(relu_masks(net, rows), relu_masks(other, rows)))
        if n == 0:
            return idx, k, crossed
        crossed += n
    raise AssertionError(f"no minibatch of {tries} draws puts every ReLU input on the same "
                         f"side of zero on both devices ({crossed} crossed over)")
