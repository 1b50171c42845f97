"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips unless a CUDA device is present (decided in
the fixture, never at import). On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Integers must match exactly; values and vars within rtol 1e-6 / atol 1e-5
(tests/test_search.py's backup tolerance); the fused VV forward within
rtol 1e-4, atol 1e-3 (value) / 1e-2 (variance) (tests/test_ops.py's).

The select kernel runs a warp per tree, two trees a block: it is checked at
B = 1, 5, 64 and 67 (one tree, a partial block, full blocks, and the odd
batch of more than one block) and on depth-capped walks. The forward picks
its boards per block from n and tiles the FC over 16 boards: it is checked
from 1 to 1792 boards, across tile and block edges.
"""

import numpy as np
import pytest
import torch

from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T

pytestmark = pytest.mark.cuda

CFG = T.TreeConfig(max_nodes=512, max_obs=512, table_size=1024, max_depth=24)
B = 16
B_GROWN = 67  # the select tests take the first B lanes of these trees


@pytest.fixture(scope="module")
def grown():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the walk kernels run only on the card")

    def stub(x):
        n = x.shape[0]
        return (torch.linspace(1.0, 8.0, n, device=x.device),
                torch.full((n,), 2.5, device=x.device))

    scfg = M.SearchConfig(tree=CFG, sims=12)
    move = M.make_move_fn(M.nn_child_evaluator(stub), scfg,
                          M.TorchPlanes(0, "cuda"))
    trees, envs = M.init_batch(3, B_GROWN, scfg, device="cuda")
    for _ in range(4):
        envs, _ = move(trees, envs)
    return trees


def lanes(trees, n):
    """The first n trees of a batch, as a batch of their own."""
    return T.Tree(**{f: getattr(trees, f)[:n].contiguous()
                     for f in trees.__dataclass_fields__})


@pytest.mark.parametrize("policy,low", [(p, 1) for p in W.POLICIES] + [("bayes", 10)])
def test_select_kernel_matches_plain(grown, policy, low):
    """Every selection rule the kernel accepts; low=1 lets the rule's bound
    decide, low=10 is the CLI's setting for bayes."""
    cfg = CFG._replace(policy=policy, low=low)
    trees = lanes(grown, B)
    gum, rnd = M.TorchPlanes(1, "cuda", policy)(B, CFG.max_depth)
    got = W.select_walk(trees, gum, rnd, cfg)
    want = W.select_walk_plain(trees, gum, rnd, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 5, 64, 67])
def test_select_kernel_batch_edges(grown, n):
    """A warp per tree, two a block: one tree, a partial block, full
    blocks, and the whole grown batch."""
    trees = lanes(grown, n)
    gum, rnd = M.TorchPlanes(n, "cuda")(n, CFG.max_depth)
    W.reset_launches()
    got = W.select_walk(trees, gum, rnd, CFG)
    assert W.LAUNCHES["select_walk"] == 1
    want = W.select_walk_plain(trees, gum, rnd, CFG)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].max()) > 2  # the walks descend


@pytest.mark.parametrize("policy", W.POLICIES)
def test_select_kernel_depth_capped(grown, policy):
    """D=8 on trees grown at depth 24: walks stop at the cap, where the
    last level's env stays unstepped."""
    cfg = CFG._replace(policy=policy, max_depth=8)
    trees = lanes(grown, B_GROWN)
    gum, rnd = M.TorchPlanes(8, "cuda", policy)(B_GROWN, 8)
    got = W.select_walk(trees, gum, rnd, cfg)
    want = W.select_walk_plain(trees, gum, rnd, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bench_walk_kernel_matches_plain():
    """The micro-benchmark walk at the script's shapes (B=256, M=2048, 16
    levels), from statistics that are not all zero."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from tetris_mcts_tpu_torch.ops import bench_walk as BW

    rng = np.random.RandomState(0)
    idxs = torch.as_tensor(rng.randint(1, 2048, (BW.LEVELS, 256)).astype(np.int32),
                           device="cuda")
    stats = [torch.as_tensor(rng.rand(2048, 256).astype(np.float32), device="cuda")
             for _ in range(3)]
    BW.reset_launches()
    got = BW.bench_walk(idxs, *stats)
    assert BW.LAUNCHES["bench_walk"] == 1
    want = BW.bench_walk_plain(idxs, *stats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_insert_kernel_matches_plain(grown):
    grown = lanes(grown, B)
    rng = np.random.RandomState(0)
    packed7 = torch.as_tensor(rng.randint(0, 4, (B, 7, 20)).astype(np.int32), device="cuda")
    end7 = torch.as_tensor(rng.rand(B, 7) < 0.2, device="cuda")
    ok = torch.as_tensor(rng.rand(B) < 0.8, device="cuda")
    tk, tp = grown.clone(), grown.clone()
    assert torch.equal(W.insert_obs7(tk, packed7, end7, ok, CFG),
                       T.insert_obs7_batched(tp, packed7, end7, ok, CFG))
    for f in ("tbl_h1", "tbl_h2", "tbl_obs", "n_obs", "obs_end", "obs_bits"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f


def test_lp_backup_kernel_matches_plain(grown):
    grown = lanes(grown, B)
    traces, lengths, *_ = W.select_walk(grown, *M.TorchPlanes(2, "cuda")(B, CFG.max_depth),
                                        CFG)
    v = torch.linspace(1.0, 7.0, B * 7, device="cuda").reshape(B, 7)
    var = torch.full((B, 7), 3.0, device="cuda")
    can = torch.arange(B, device="cuda") % 3 != 0
    tk, tp = grown.clone(), grown.clone()
    W.lp_backup(tk, traces, lengths, v, var, can, CFG)
    W.lp_backup_plain(tp, traces, lengths, v, var, can, CFG)
    assert torch.equal(tk.visits, tp.visits)
    torch.testing.assert_close(tk.values, tp.values, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(tk.vars_, tp.vars_, rtol=1e-6, atol=1e-5)


def test_backup_kernel_matches_plain(grown):
    grown = lanes(grown, B)
    traces, lengths, *_ = W.select_walk(grown, *M.TorchPlanes(4, "cuda")(B, CFG.max_depth),
                                        CFG)
    v0 = torch.linspace(3.0, 70.0, B, device="cuda")
    var0 = torch.linspace(0.25, 2.0, B, device="cuda")
    tk, tp = grown.clone(), grown.clone()
    W.reset_launches()
    W.backup(tk, traces, lengths, v0, var0, CFG)
    assert W.LAUNCHES["backup_walk"] == 1
    T.backup_batched(tp, traces, lengths, v0, var0, CFG)
    assert torch.equal(tk.visits, tp.visits)
    assert not torch.equal(tk.visits, grown.visits)
    torch.testing.assert_close(tk.values, tp.values, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(tk.vars_, tp.vars_, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 448, 1792])
def test_vv_forward_kernel_matches_plain_and_vvnet(grown, n):
    """On child boards of the grown trees (their obs rows), at the main
    path's 448 boards, the leaf path's 64, and ragged counts on both sides
    of the FC's 16-board tiles and of one wave of conv blocks."""
    from tetris_mcts_tpu_torch.env.engine import unpack_obs
    from tetris_mcts_tpu_torch.ops import vv_forward as F
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    bits = grown.obs_bits.permute(0, 2, 1).reshape(-1, 20)
    packed = bits[bits.any(1)][:n].contiguous()
    assert packed.shape[0] == n
    model = VVModel(seed=5, device="cuda")
    F.reset_launches()
    v, var = F.vv_forward_packed(model.net, model.ubound, model.lbound, packed)
    assert F.LAUNCHES["vv_forward"] == 1
    v_p, var_p = F.vv_forward_packed_plain(model.net, model.ubound, model.lbound, packed)
    v_n, var_n = model.apply_fn()(unpack_obs(packed)[:, None].float())
    for v_ref, var_ref in ((v_p, var_p), (v_n, var_n)):
        torch.testing.assert_close(v, v_ref, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(var, var_ref, rtol=1e-4, atol=1e-2)


def test_vvnet_on_card_matches_cpu():
    """The float32 forward on the card (convs pinned to float32, no TF32)
    against the same weights on the CPU, within tests/test_torch_model.py's
    bounds (rtol 1e-4; atol 1e-3 value, 1e-2 variance)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randint(-1, 2, (448, 1, 20, 10)).astype(np.float32))
    v_c, var_c = VVModel(seed=5, device="cpu").apply_fn()(x)
    v_g, var_g = VVModel(seed=5, device="cuda").apply_fn()(x.cuda())
    torch.testing.assert_close(v_g.cpu(), v_c, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(var_g.cpu(), var_c, rtol=1e-4, atol=1e-2)
