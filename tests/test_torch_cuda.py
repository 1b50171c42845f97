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
block edges. Online self-play adds two: one VV train step on the card
against the CPU (TF32 off through the backward), and six store moves whose
replay ring and trees must equal the CPU's. The distributional search adds
two: four DistValueSim moves (insert kernel, plain walks) against the CPU
(integers and rows equal; values and m2 within rtol 1e-6 / atol 1e-5, the
distributions within rtol 1e-6 / atol 1e-6), and one DistModel train step
against the CPU. The VV surface adds two: lp moves with `--select_kernel
0` or `--insert_kernel 0` equal to the kernels' in every tree array, and
lp moves under `--policy max` (plain select and backups) against the CPU.
ValueSim2 adds one: three moves (insert kernel, plain walks) against the
CPU (integers, visits and the edge tables equal; values, vars and max_ret
within rtol 1e-6 / atol 1e-5). DQN adds two: ten steps of each head from
the same weights and draws against the CPU (actions, envs and the ring
equal; losses rtol 1e-5), then one update (loss rtol 1e-5, grads rtol 1e-4
/ atol 1e-5 x the largest, Adam fed the card's grads rtol 1e-6 / atol 1e-7).
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


def test_train_step_on_card_matches_cpu(card):
    """One VV train step (forward, backward, Yogi) on the card against the
    same step on the CPU, with PyTorch's TF32 switches turned on around
    it: the step pins TF32 off for the backward too, so the gradients
    agree within rtol 1e-4 / atol 1e-5 of each tensor's largest entry (a
    TF32 backward misses by ~1e-3). On the minibatch both devices put every
    ReLU input on the same side of zero (tests/torch_train_cases.py)."""
    from tetris_mcts_tpu_torch.train.trainer import VVModel
    from torch_train_cases import agreeing_minibatch

    rng = np.random.RandomState(7)
    n = 512
    cols = [torch.as_tensor(rng.randint(-1, 2, (n, 1, 20, 10)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0, 50, n).astype(np.float32)),
            torch.as_tensor(rng.uniform(0, 30, n).astype(np.float32)),
            torch.as_tensor(rng.uniform(1, 5, n).astype(np.float32))]
    cpu, gpu = VVModel(seed=5, device="cpu"), VVModel(seed=5, device="cuda")
    idx, _, _ = agreeing_minibatch(cpu.net, gpu.net, cols[0], 128)
    gcols = [c.cuda() for c in cols]
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lc, _, gc = cpu.loss_and_grads(tuple(c[idx] for c in cols))
        lg, _, gg = gpu.loss_and_grads(tuple(c[idx.cuda()] for c in gcols))
        for name, a, b in zip(cpu.names, gg, gc):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                       msg=name)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
        cpu.train_step(cols, idx)
        gpu.train_step(gcols, idx.cuda())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(gpu.net.parameters(), cpu.net.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-6)


class HostPlanes:
    """Gumbel planes and store-drop draws from a CPU generator, moved to
    `device`: the same draws on the card and on the CPU."""

    def __init__(self, seed, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, B, D):
        e = torch.empty(B, D, 7).exponential_(generator=self.gen)
        return (-torch.log(e)).to(self.device), torch.zeros(B, D, 7, device=self.device)

    def drop(self, shape):
        return torch.rand(shape, generator=self.gen).to(self.device)


def test_store_move_on_card_matches_cpu(card):
    """Six lp moves with the store drop (the stub net): the replay ring and
    the trees after the card's kernels equal the CPU's plain versions."""
    scfg = M.SearchConfig(tree=T.TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                            max_depth=24), sims=6)
    out = {}
    for dev in ("cuda", "cpu"):
        def stub(x):
            n = x.shape[0]
            return (torch.linspace(1.0, 8.0, n, device=x.device),
                    torch.full((n,), 2.5, device=x.device))

        move = M.make_move_fn(M.nn_child_evaluator(stub), scfg, HostPlanes(4, dev),
                              min_visits_store=2, store=True, store_drop=True)
        trees, envs = M.init_batch(5, 8, scfg, device=dev)
        rep = M.init_replay(96, dev)
        rep.drop_prob.fill_(0.3)
        for _ in range(6):
            envs, _ = move(trees, envs, rep)
        out[dev] = (trees, rep)
    (tg, rg), (tc, rc) = out["cuda"], out["cpu"]
    for a, b in zip(rg.rows(), rc.rows()):
        assert torch.equal(a.cpu(), b)
    for f in ("idx", "count", "total", "cand"):
        assert getattr(rg, f).item() == getattr(rc, f).item(), f
    assert rc.total.item() > 96 and rc.cand.item() > rc.total.item()
    for f in ("visits", "values", "vars_", "obs_bits", "n_obs", "root"):
        assert torch.equal(getattr(tg, f).cpu(), getattr(tc, f)), f


class HostGumbels(HostPlanes):
    """`HostPlanes` with the distributional walk's draws."""

    def level_gumbels(self, B, D):
        return self(B, D)[0]


def dist_stub(x):
    """A deterministic distribution over 16 bins from the board's cell sum."""
    w = torch.remainder(x.sum(dim=(1, 2, 3))[:, None]
                        + 3 * torch.arange(16, device=x.device), 5.0) + 1.0
    return w / w.sum(1, keepdim=True)


def test_dist_move_on_card_matches_cpu(card):
    """Four DistValueSim moves (the stub net, pools of 128 so a harvest is
    stored): the card (insert kernel) equals the CPU (plain insert)."""
    from tetris_mcts_tpu_torch.search import distributional as DD

    scfg = M.SearchConfig(tree=T.TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                            max_depth=16, low=5), sims=8)
    dcfg = DD.DistConfig(atoms=16, vmax=200.0)
    out = {}
    for dev in ("cuda", "cpu"):
        W.reset_launches()
        move = DD.make_dist_move_fn(dist_stub, scfg, dcfg, HostGumbels(3, dev),
                                    min_visits_store=1)
        dts, envs = DD.init_dist_batch(5, 4, scfg, dcfg, device=dev)
        rep = DD.init_dist_replay(256, 16, dev)
        acts = []
        for _ in range(4):
            envs, st = move(dts, envs, rep)
            acts.append(st.action)
        out[dev] = (torch.stack(acts), envs, dts, rep, dict(W.LAUNCHES))
    (ag, eg, dg, rg, lg), (ac, ec, dc, rc, lc) = out["cuda"], out["cpu"]
    assert lg["insert7_walk"] == 4 * 8 and sum(lg.values()) == 32 and sum(lc.values()) == 0
    assert torch.equal(ag.cpu(), ac) and torch.equal(eg.cpu(), ec)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits", "root"):
        assert torch.equal(getattr(dg.base, f).cpu(), getattr(dc.base, f)), f
    torch.testing.assert_close(dg.base.values.cpu(), dc.base.values, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dg.obs_m2.cpu(), dc.obs_m2, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dg.obs_dist.cpu(), dc.obs_dist, rtol=1e-6, atol=1e-6)
    assert rc.total.item() == rg.total.item() > 0
    for a, b in zip(rg.rows(), rc.rows()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)


def test_dist_train_step_on_card_matches_cpu(card):
    """One DistModel train step on the card against the CPU, TF32 switched
    on around it, on a minibatch both devices agree on at every ReLU."""
    from tetris_mcts_tpu_torch.train.trainer import DistModel
    from torch_train_cases import agreeing_minibatch

    rng = np.random.RandomState(8)
    n = 512
    d = rng.uniform(0, 1, (n, 50)).astype(np.float32) ** 4
    cols = [torch.as_tensor(rng.randint(-1, 2, (n, 1, 20, 10)).astype(np.float32)),
            torch.as_tensor(d / d.sum(1, keepdims=True)),
            torch.as_tensor(rng.uniform(1, 5, n).astype(np.float32))]
    cpu, gpu = DistModel(seed=5, device="cpu"), DistModel(seed=5, device="cuda")
    idx, _, _ = agreeing_minibatch(cpu.net, gpu.net, cols[0], 128)
    gcols = [c.cuda() for c in cols]
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lc, _, gc = cpu.loss_and_grads(tuple(c[idx] for c in cols))
        lg, _, gg = gpu.loss_and_grads(tuple(c[idx.cuda()] for c in gcols))
        for name, a, b in zip(cpu.names, gg, gc):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5 * float(b.abs().max()),
                                       msg=name)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
        cpu.train_step(cols, idx)
        gpu.train_step(gcols, idx.cuda())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(gpu.net.parameters(), cpu.net.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-6)


def stub_lp(x):
    n = x.shape[0]
    return (torch.linspace(1.0, 8.0, n, device=x.device),
            torch.full((n,), 2.5, device=x.device))


def lp_moves(dev, moves=4, **tree_kw):
    """`moves` lp moves (stub net, host planes) at B=8; the trees, the
    actions and the walk launches."""
    scfg = M.SearchConfig(tree=T.TreeConfig(max_nodes=256, max_obs=256, table_size=512,
                                            max_depth=24, **tree_kw), sims=6)
    W.reset_launches()
    move = M.make_move_fn(M.nn_child_evaluator(stub_lp), scfg, HostPlanes(6, dev))
    trees, envs = M.init_batch(2, 8, scfg, device=dev)
    acts = []
    for _ in range(moves):
        envs, st = move(trees, envs)
        acts.append(st.action)
    return trees, torch.stack(acts), dict(W.LAUNCHES)


@pytest.mark.parametrize("flag", ["select_kernel", "insert_kernel"])
def test_plain_route_on_card_equals_the_kernels(card, flag):
    tk, ak, lk = lp_moves("cuda")
    tp, ap, lp_ = lp_moves("cuda", **{flag: False})
    assert lk["select_walk"] == lk["insert7_walk"] == lk["lp_backup_walk"] == 24
    gone = "select_walk" if flag == "select_kernel" else "insert7_walk"
    assert lp_[gone] == 0 and sum(lp_.values()) == 48
    assert torch.equal(ak, ap)
    for f in tk.__dataclass_fields__:
        assert torch.equal(getattr(tk, f), getattr(tp, f)), f


def test_policy_max_on_card_matches_cpu(card):
    tg, ag, lg = lp_moves("cuda", policy="max")
    tc, ac, _ = lp_moves("cpu", policy="max")
    assert lg == {"select_walk": 0, "insert7_walk": 24, "lp_backup_walk": 0, "backup_walk": 0}
    assert torch.equal(ag.cpu(), ac)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "obs_bits", "tbl_obs", "root"):
        assert torch.equal(getattr(tg, f).cpu(), getattr(tc, f)), f
    for f in ("values", "vars_", "vmax"):
        torch.testing.assert_close(getattr(tg, f).cpu(), getattr(tc, f), rtol=1e-6, atol=1e-5)
    assert float(tc.vmax.max()) > 0


def test_s2_move_on_card_matches_cpu(card):
    """Three ValueSim2 moves (the linspace stub net, pools of 128, so the
    second move harvests and stores): the card (insert kernel) equals the
    CPU (plain insert); the search draws nothing."""
    from tetris_mcts_tpu_torch.search import stochastic as ST

    scfg = M.SearchConfig(tree=T.TreeConfig(max_nodes=128, max_obs=128, table_size=256,
                                            max_depth=16), sims=8)
    out = {}
    for dev in ("cuda", "cpu"):
        W.reset_launches()
        move = ST.make_s2_move_fn(stub_lp, scfg, min_visits_store=1)
        s2, envs = ST.init_s2_batch(5, 4, scfg, device=dev)
        rep = M.init_replay(256, dev)
        acts = []
        for _ in range(3):
            envs, st = move(s2, envs, rep)
            acts.append(torch.cat([st.action[:, None].float(), st.probs], 1))
        out[dev] = (torch.stack(acts), envs, s2, rep, dict(W.LAUNCHES))
    (ag, eg, sg, rg, lg), (ac, ec, sc, rc, lc) = out["cuda"], out["cpu"]
    assert lg["insert7_walk"] == 3 * 8 and sum(lg.values()) == 24 and sum(lc.values()) == 0
    assert torch.equal(ag.cpu(), ac) and torch.equal(eg.cpu(), ec)
    for f in ("cbase", "nstat", "end", "n_nodes", "visits", "n_obs", "obs_bits", "root"):
        assert torch.equal(getattr(sg.base, f).cpu(), getattr(sc.base, f)), f
    for f in ("edge_child", "edge_count", "edge_dscore"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    for a, b in ((sg.base.values, sc.base.values), (sg.base.vars_, sc.base.vars_),
                 (sg.max_ret, sc.max_ret)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-5)
    assert rc.total.item() == rg.total.item() > 0 and float(sc.edge_count.sum()) > 0
    for a, b in zip(rg.rows(), rc.rows()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dist", [False, True], ids=["dqn", "distdqn"])
def test_dqn_steps_on_card_match_cpu(card, dist):
    """Ten DQN (or C51) steps from the same weights and draws (B=8, a ring
    of 64 that wraps): actions, envs and the ring equal, losses within
    rtol 1e-5; then one update of the card's state against the CPU's."""
    from tetris_mcts_tpu_torch.runtime import dqn as D

    cfg = D.DQNConfig(batch=8, memory_size=64, train_batch=16, target_update_steps=4, seed=4,
                      distributional=dist)
    rng = np.random.RandomState(7)
    draws = [(rng.rand(8).astype(np.float32), rng.randint(0, 7, 8),
              rng.randint(0, min(8 * (k + 1), 64), 16)) for k in range(10)]
    runs = {}
    for dev in ("cuda", "cpu"):
        d = D.DQNDriver(cfg, device=dev, log=lambda s: None)
        feed = iter(draws)
        d.draws = lambda feed=feed, dev=dev: D.DQNDraws(
            *(torch.as_tensor(x, device=dev) for x in next(feed)))
        runs[dev] = (d, [(st.action, st.loss, d.envs, *(a.clone() for a in d.replay.arrays()))
                         for st in (d.step() for _ in range(10))])
    (g, gout), (c, cout) = runs["cuda"], runs["cpu"]
    for go, co in zip(gout, cout):
        for a, b in zip(go[:1] + go[2:], co[:1] + co[2:]):
            assert torch.equal(a.cpu(), b)
        torch.testing.assert_close(go[1].cpu(), co[1], rtol=1e-5, atol=1e-7)
    # the update on its own (Adam turns a gradient's rounding difference near
    # zero into an update of up to its learning rate, so the nets part after
    # a few steps): loss and grads per device, Adam fed the card's grads
    from torch_train_cases import dqn_update_on_two_devices

    up = dqn_update_on_two_devices(g)
    torch.testing.assert_close(up["card"][0].cpu(), up["cpu"][0], rtol=1e-5, atol=0)
    for a, b in zip(up["card"][1], up["cpu"][1]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    for a, b in zip(*up["params"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)
