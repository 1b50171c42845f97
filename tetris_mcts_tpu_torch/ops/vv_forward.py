"""The VV net's forward straight from bit-packed boards: a CUDA kernel and
its plain version.

Counterpart of the reference package's `ops/vv_forward.py`, whose Pallas
kernel (`_kernel` -> `_forward_block`, launched by `vv_forward_packed`)
this replaces:

| wrapper | plain version | replaces (tetris_mcts_tpu/ops/vv_forward.py) |
| --- | --- | --- |
| `vv_forward_packed` | `vv_forward_packed_plain` | `_kernel` / `_forward_block` via `vv_forward_packed` |

`vv_forward_packed(net, ubound, lbound, packed)` takes the port's `VVNet`
module (`models/nets.py`), so the kernel and the search's evaluator read
the same weights in the same layout (conv weights OIHW; fc1's inputs in the
NCHW flatten order (c, y, x)). On a CUDA tensor it launches the kernel of
`csrc/vv_forward.cu` (built by `ops/build.py`) and counts the launch in
`LAUNCHES`; on a CPU tensor it runs the plain version; any other device
raises. As in the reference, the search's evaluators do not call it: they
run `VVNet` itself.

What bounds the kernel on the H100: operations, 1,901,568 multiply-adds a
board in float32 (3.8 MFLOP), against 80 bytes of board in and 8 bytes
out; see the source for its design. A call makes two launches, the conv
ladder and the FC kernel, through one C entry, and counts one: the conv
ladder hands the FC kernel each board's 1792 features through an (n, 1792)
float32 scratch tensor that the wrapper allocates.
"""

from __future__ import annotations

import torch

from tetris_mcts_tpu_torch.env.rng import u32
from tetris_mcts_tpu_torch.ops import build

BOARD_H, BOARD_W = 20, 10
FILTERS, N_FC = 32, 256  # the widths the kernel is written for

# Kernel launches, counted where the kernel is launched.
LAUNCHES = {"vv_forward": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unpack_pm1(packed):
    """Packed words (..., 20) -> float32 (..., 20, 10) image with
    {0, 1 locked, -1 piece}: bits 0-9 the locked row, bits 10-19 the piece
    row; the piece wins where both bits are set."""
    w = u32(packed)[..., None]
    cols = torch.arange(BOARD_W, device=w.device)
    locked = ((w >> cols) & 1).to(torch.float32)
    piece = ((w >> (cols + 10)) & 1).to(torch.float32)
    return locked * (1.0 - piece) - piece


def _weights(net):
    """The net's weights as float32 tensors in the module's own layouts."""
    return [p.detach().to(torch.float32).contiguous() for p in (
        net.conv1.weight, net.conv1.bias, net.conv2.weight, net.conv2.bias,
        net.conv3.weight, net.conv3.bias, net.fc1.weight, net.fc1.bias,
        net.fc_out.weight, net.fc_out.bias)]


def _conv_taps(x, w, b, H, W):
    """NHWC (n, H+2, W+2, Ci) x OIHW (Co, Ci, 3, 3) -> ReLU(conv) NHWC
    (n, H, W, Co), as a sum over the nine taps of (n*H*W, Ci) @ (Ci, Co)
    products (the reference's `_conv_im2col`; with Ci = 1 its
    `_conv1_9shift`)."""
    n, Ci = x.shape[0], x.shape[-1]
    acc = None
    for dy in range(3):
        for dx in range(3):
            xs = x[:, dy:dy + H, dx:dx + W, :].reshape(n * H * W, Ci)
            m = xs @ w[:, :, dy, dx].t()
            acc = m if acc is None else acc + m
    return torch.relu(acc.reshape(n, H, W, -1) + b)


def vv_forward_packed_plain(net, ubound, lbound, packed):
    """Plain form of the kernel (the reference `_forward_block` in torch,
    float32): packed (n, 20) int32 -> (value (n,), variance (n,))."""
    w1, b1, w2, b2, w3, b3, wf1, bf1, wf2, bf2 = _weights(net)
    x = unpack_pm1(packed)[..., None]                 # (n, 20, 10, 1)
    x = _conv_taps(x, w1, b1, 18, 8)
    x = _conv_taps(x, w2, b2, 16, 6)
    x = _conv_taps(x, w3, b3, 14, 4)                  # (n, 14, 4, 32)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)  # fc1's (c, y, x) order
    x = torch.relu(x @ wf1.t() + bf1)
    out = x @ wf2.t() + bf2
    out = torch.sigmoid(out) * ubound.to(torch.float32) + lbound.to(torch.float32)
    return out[:, 0], out[:, 1]


def vv_forward_packed(net, ubound, lbound, packed):
    """(value (n,), variance (n,)) of the VV net `net` on bit-packed boards
    packed (n, 20) int32: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if packed.device.type == "cpu":
        return vv_forward_packed_plain(net, ubound, lbound, packed)
    if not packed.is_cuda:
        raise ValueError(f"vv_forward runs on cuda or cpu tensors, not {packed.device}")
    n = packed.shape[0]
    if packed.dtype != torch.int32 or packed.shape[1:] != (BOARD_H,) or (
            not packed.is_contiguous()):
        raise ValueError(f"packed: want contiguous int32 (n, {BOARD_H}), got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    ws = _weights(net)
    want = [(FILTERS, 1, 3, 3), (FILTERS,), (FILTERS, FILTERS, 3, 3), (FILTERS,),
            (FILTERS, FILTERS, 3, 3), (FILTERS,), (N_FC, FILTERS * 14 * 4), (N_FC,),
            (2, N_FC), (2,)]
    dev = build.tensors_device("vv_forward", [packed, *ws])
    bounds = [b.to(device=dev, dtype=torch.float32).contiguous() for b in (ubound, lbound)]
    for x, shape in zip(ws + bounds, want + [(2,), (2,)]):
        if tuple(x.shape) != shape:
            raise ValueError(f"vv_forward kernel: want a {shape} weight, got "
                             f"{tuple(x.shape)}")
    return _forward_kernel(packed, ws, bounds)


def _forward_kernel(packed, ws, bounds):
    """Launch the forward on checked inputs: the conv ladder writes an
    (n, 1792) scratch, the FC kernel reads it and writes (n, 2)."""
    n = packed.shape[0]
    out = torch.empty(n, 2, dtype=torch.float32, device=packed.device)
    if n == 0:
        return out[:, 0], out[:, 1]
    feat = torch.empty(n, FILTERS * 14 * 4, dtype=torch.float32, device=packed.device)
    build.launch("vv_forward", "vv_forward", packed, *ws, *bounds, feat, out, n)
    LAUNCHES["vv_forward"] += 1
    return out[:, 0], out[:, 1]
