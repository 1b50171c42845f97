"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips unless a CUDA device is present (decided in
the fixture, never at import). On a machine with the card:

    python -m pytest -m cuda tests/test_torch_cuda.py

Integers must match exactly; values and vars within rtol 1e-6 / atol 1e-5
(tests/test_search.py's backup tolerance); the fused VV forward within
rtol 1e-4, atol 1e-3 (value) / 1e-2 (variance) (tests/test_ops.py's).

The walk kernels run a warp per tree, two trees a block: each is checked
at B = 1, 5, 16, 64 and 67 (one tree, a partial block, full blocks, and
the odd batch of more than one block), select also on depth-capped walks.
Insert and both backups are also checked on the edge inputs of
tests/torch_walk_cases.py (D=96 traces that hold one obs twice within and
across the backups' chunks of 32 levels, leaf children whose obs lie on
the trace, leaves without children, lanes not expanded, lengths 0 and 1; a
16-slot table with contending keys, duplicates, a wrapping probe and an id
pool that runs out), integers and obs rows compared with torch.equal; the
backup's values and vars too. The bench walk copies on every SM, 16 bytes
a load where B is a multiple of 4: it is checked at B = 1, 67 and 256 and
at M = 4 (every lane revisits rows) and 2048, every output with
torch.equal. The forward picks its boards per block from n and tiles the
FC over 16 boards: it is checked from 1 to 1792 boards, across tile and
block edges.
"""

import numpy as np
import pytest
import torch

from tetris_mcts_tpu_torch.ops import tree_walk as W
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
import torch_walk_cases as C

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


@pytest.mark.parametrize("b,m", [(256, 2048), (1, 2048), (67, 2048), (256, 4), (67, 4),
                                 (1, 4)])
def test_bench_walk_kernel_matches_plain(b, m):
    """The micro-benchmark walk at the script's shapes (B=256, M=2048, 16
    levels), at batches that are not a multiple of 4 (4-byte copies), and
    at M=4, where every lane revisits rows; from statistics that are not
    all zero."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from tetris_mcts_tpu_torch.ops import bench_walk as BW

    rng = np.random.RandomState(0)
    idxs = torch.as_tensor(rng.randint(1, m, (BW.LEVELS, b)).astype(np.int32),
                           device="cuda")
    stats = [torch.as_tensor(rng.rand(m, b).astype(np.float32), device="cuda")
             for _ in range(3)]
    BW.reset_launches()
    got = BW.bench_walk(idxs, *stats)
    assert BW.LAUNCHES["bench_walk"] == 1
    want = BW.bench_walk_plain(idxs, *stats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if m == 4:
        assert int(want[0].max()) > 4  # lanes revisited rows


@pytest.mark.parametrize("n", [1, 5, B, 64, 67])
def test_insert_kernel_matches_plain(grown, n):
    """On the grown trees' first n lanes (a warp per tree, two a block)."""
    grown = lanes(grown, n)
    rng = np.random.RandomState(0)
    packed7 = torch.as_tensor(rng.randint(0, 4, (n, 7, 20)).astype(np.int32), device="cuda")
    end7 = torch.as_tensor(rng.rand(n, 7) < 0.2, device="cuda")
    ok = torch.as_tensor(rng.rand(n) < 0.8, device="cuda")
    tk, tp = grown.clone(), grown.clone()
    W.reset_launches()
    assert torch.equal(W.insert_obs7(tk, packed7, end7, ok, CFG),
                       T.insert_obs7_batched(tp, packed7, end7, ok, CFG))
    assert W.LAUNCHES["insert7_walk"] == 1
    for f in ("tbl_h1", "tbl_h2", "tbl_obs", "n_obs", "obs_end", "obs_bits"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f


@pytest.mark.parametrize("n", [1, 5, B, 64, 67])
def test_lp_backup_kernel_matches_plain(grown, n):
    """On the grown trees' first n lanes (a warp per tree, two a block)."""
    grown = lanes(grown, n)
    traces, lengths, *_ = W.select_walk(grown, *M.TorchPlanes(2, "cuda")(n, CFG.max_depth),
                                        CFG)
    v = torch.linspace(1.0, 7.0, n * 7, device="cuda").reshape(n, 7)
    var = torch.full((n, 7), 3.0, device="cuda")
    can = torch.arange(n, device="cuda") % 3 != 0
    tk, tp = grown.clone(), grown.clone()
    W.reset_launches()
    W.lp_backup(tk, traces, lengths, v, var, can, CFG)
    assert W.LAUNCHES["lp_backup_walk"] == 1
    W.lp_backup_plain(tp, traces, lengths, v, var, can, CFG)
    assert torch.equal(tk.visits, tp.visits)
    torch.testing.assert_close(tk.values, tp.values, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(tk.vars_, tp.vars_, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, B, 64, 67])
def test_backup_kernel_matches_plain(grown, n):
    """On the grown trees' first n lanes (a warp per tree, two a block)."""
    grown = lanes(grown, n)
    traces, lengths, *_ = W.select_walk(grown, *M.TorchPlanes(4, "cuda")(n, CFG.max_depth),
                                        CFG)
    v0 = torch.linspace(3.0, 70.0, n, device="cuda")
    var0 = torch.linspace(0.25, 2.0, n, device="cuda")
    tk, tp = grown.clone(), grown.clone()
    W.reset_launches()
    W.backup(tk, traces, lengths, v0, var0, CFG)
    assert W.LAUNCHES["backup_walk"] == 1
    T.backup_batched(tp, traces, lengths, v0, var0, CFG)
    for f in ("visits", "values", "vars_"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f
    assert not torch.equal(tk.visits, grown.visits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the walk kernels run only on the card")


@pytest.mark.parametrize("n", [1, 5, 64, 67])
def test_lp_backup_kernel_edges(card, n):
    """D=96 traces from 1 to 96 levels: the kernel's chunks of 32 levels,
    obs repeated within and across chunks, seeded children on the trace."""
    case = C.lp_case(n, n, 96)
    if n >= 64:
        assert C.repeats(case) == (True, True, True)
    cfg = T.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M, table_size=16, max_depth=96)
    tk, tp = C.lp_tree(case, "cuda"), C.lp_tree(case, "cuda")
    args = C.lp_args(case, "cuda")
    W.reset_launches()
    W.lp_backup(tk, *args, cfg)
    assert W.LAUNCHES["lp_backup_walk"] == 1
    W.lp_backup_plain(tp, *args, cfg)
    assert torch.equal(tk.visits, tp.visits)
    torch.testing.assert_close(tk.values, tp.values, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(tk.vars_, tp.vars_, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5, 64, 67])
def test_backup_kernel_edges(card, n):
    """The backup from given (v0, var0) on the LP edge trees: D=96 traces
    from 0 to 96 levels, obs repeated within and across chunks."""
    case = C.backup_case(n, n, 96)
    if n >= 64:
        assert C.repeats(case)[:2] == (True, True)
    cfg = T.TreeConfig(max_nodes=C.LP_N, max_obs=C.LP_M, table_size=16, max_depth=96)
    tk, tp = C.lp_tree(case, "cuda"), C.lp_tree(case, "cuda")
    args = C.backup_args(case, "cuda")
    W.reset_launches()
    W.backup(tk, *args, cfg)
    assert W.LAUNCHES["backup_walk"] == 1
    T.backup_batched(tp, *args, cfg)
    for f in ("visits", "values", "vars_"):
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f


@pytest.mark.parametrize("n", [1, 5, 64, 67])
def test_insert_kernel_edges(card, n):
    """A sequence of inserts into a 16-slot table with a 12-id pool:
    contention for one slot, duplicate keys, a probe wrapping to slot 0,
    the pool running out during a call."""
    packed7, end7, ok = C.insert_case(n, n)
    tk, tp = C.insert_trees(n, n, "cuda"), C.insert_trees(n, n, "cuda")
    ran_out = False
    for r in range(C.INSERT_ROUNDS):
        args = [torch.as_tensor(x[r], device="cuda") for x in (packed7, end7, ok)]
        n_before = tk.n_obs.clone()
        W.reset_launches()
        got = W.insert_obs7(tk, *args, C.INSERT_CFG)
        assert W.LAUNCHES["insert7_walk"] == 1
        assert torch.equal(got, T.insert_obs7_batched(tp, *args, C.INSERT_CFG)), r
        for f in ("tbl_h1", "tbl_h2", "tbl_obs", "n_obs", "obs_end", "obs_bits"):
            assert torch.equal(getattr(tk, f), getattr(tp, f)), (r, f)
        ran_out |= C.ran_out(n_before, tk.n_obs, got, args[2])
    assert C.wrapped(tk)
    if n >= 5:
        assert ran_out


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
