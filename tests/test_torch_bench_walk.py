"""The micro-benchmark walk's plain version (`ops/bench_walk.py`, what the
wrapper runs on the CPU) against a NumPy copy of the reference loop of
`scripts/microbench_pallas_walk.py` (its lines 99-113; the script runs its
benchmark when imported, so it is copied, not imported), at the script's
tolerances: visits rtol 1e-6, values rtol 1e-5 / atol 1e-6, vars rtol 1e-4
/ atol 1e-6. The reference loop runs in float64, as in the script."""

import numpy as np
import pytest
import torch

from tetris_mcts_tpu_torch.ops import bench_walk as BW

torch.set_num_threads(1)


def reference_walk(idxs_np, M, B):
    """The script's correctness loop, in float64."""
    visit = np.zeros((M, B)); value = np.zeros((M, B)); var = np.zeros((M, B))
    acc = np.full(B, 1.0)
    for t in range(idxs_np.shape[0]):
        o = idxs_np[t]
        bi = np.arange(B)
        vi, va, vr = visit[o, bi], value[o, bi], var[o, bi]
        x = acc - va
        visit[o, bi] = vi + 1.0
        value[o, bi] = va + x / (vi + 1.0)
        var[o, bi] = vr + x * x / (vi + 1.0)
        acc = acc * 0.999
    return visit, value, var


@pytest.mark.parametrize("M", [2048, 4])  # the script's M; and one where levels revisit
def test_bench_walk_plain_matches_script_reference(M):
    B = 256
    rng = np.random.RandomState(0)
    idxs = rng.randint(1, M, (BW.LEVELS, B)).astype(np.int32)
    zeros = torch.zeros(M, B, dtype=torch.float32)
    BW.reset_launches()
    got = BW.bench_walk(torch.as_tensor(idxs), zeros, zeros.clone(), zeros.clone())
    assert BW.LAUNCHES["bench_walk"] == 0  # CPU tensors: the plain version
    assert not zeros.any()  # inputs left as they are
    visit, value, var = reference_walk(idxs, M, B)
    np.testing.assert_allclose(got[0].numpy(), visit, rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), value, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), var, rtol=1e-4, atol=1e-6)
    if M == 4:
        assert visit.max() > 4  # lanes revisited their statistics
