"""Kernel launches go to their tensors' device, on the CPU: `build.lib()`,
`torch.cuda.current_stream` and `torch.cuda.device` are replaced by fakes
that record what they are asked for, and each launcher is called on CPU
tensors while the fake "current device" is another one. A launch must take
the stream of the tensors' device and run inside `torch.cuda.device` of
that device; inputs that span two devices raise before any launch."""

import contextlib

import pytest
import torch

from tetris_mcts_tpu_torch.models.nets import VVNet
from tetris_mcts_tpu_torch.ops import build
from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.ops import vv_forward as F

torch.set_num_threads(1)


class Stream:
    cuda_stream = 1234


@pytest.fixture
def fakes(monkeypatch):
    """Returns the record: streams asked for, devices entered, and for each
    kernel call the device that was current when it ran."""
    rec = {"streams": [], "entered": [], "calls": []}
    current = ["cuda:7"]  # the caller's current device, never the tensors'

    def current_stream(device=None):
        rec["streams"].append(current[0] if device is None else torch.device(device))
        return Stream()

    @contextlib.contextmanager
    def device(dev):
        rec["entered"].append(torch.device(dev))
        prev, current[0] = current[0], torch.device(dev)
        try:
            yield
        finally:
            current[0] = prev

    class Lib:
        def __getattr__(self, fn_name):
            def fn(*args):
                rec["calls"].append((fn_name, current[0], args[-1]))
                return 0
            return fn

    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(build, "lib", lambda name="tree_walk": Lib())
    return rec


def _assert_on_tensors_device(rec, fn_name, dev):
    assert rec["streams"] == [dev]
    assert rec["entered"] == [dev]
    assert rec["calls"] == [(fn_name, dev, Stream.cuda_stream)]


def test_walk_launch_uses_tensors_device(fakes):
    a = torch.zeros(4, dtype=torch.int32)
    W.reset_launches()
    W._launch("backup_walk", a, a.float(), 4, 0.5)
    _assert_on_tensors_device(fakes, "backup_walk", a.device)
    assert W.LAUNCHES["backup_walk"] == 1


def test_forward_launch_uses_tensors_device(fakes):
    net = VVNet(seed=0)
    packed = torch.zeros(3, 20, dtype=torch.int32)
    ws = F._weights(net)
    bounds = [torch.ones(2), torch.zeros(2)]
    F.reset_launches()
    F._forward_kernel(packed, ws, bounds)
    _assert_on_tensors_device(fakes, "vv_forward", packed.device)
    assert F.LAUNCHES["vv_forward"] == 1


def test_launch_refuses_tensors_on_two_devices(fakes):
    a = torch.zeros(4)
    with pytest.raises(ValueError, match="several devices"):
        build.launch("tree_walk", "backup_walk", a, torch.zeros(4, device="meta"), 4)
    assert fakes["calls"] == [] and fakes["streams"] == []
