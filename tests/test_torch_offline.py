"""The offline cycle's pieces of the port against the JAX package's, on the
CPU: the rows the self-play driver saves (and its status memmaps and tree
dump), and `cli/train`'s targets, validation split and file order (the
`VVModel` sessions under each training option `cli/train` sets are held in
tests/test_torch_train_options.py).

The saved rows: the JAX driver (`select_kernel=False`, `insert_kernel=False`,
the XLA law the JAX package's own CPU tests run) and the port's play 6
lp moves at B=4 (6 sims, pools of 128, depth 8) from the same games with
the same frozen net (`params_from_jax` of a seeded JAX `VVModel`) and the
same key schedule (tests/torch_parity.py); lane 1 starts on a near-topped
board (tests/test_torch_reset.py), so its game ends on the first move and
its later rows carry the next episode id. Integer columns, boards and
episode ids are equal; policy, child_stats and value within rtol 1e-6 /
atol 1e-5; variance within rtol 1e-5 / atol 1e-5: the root variances come
from the backup walk, where XLA on the CPU contracts `delta * delta2 - var`
into an FMA and the port rounds each operation (ROADMAP queue 3); the
largest difference seen here is 1.1e-6 relative (1.2e-3 on a variance
near 1100). The tree dumps: board, visit and game equal, value and
variance within the same bounds.

"""

import jax
import numpy as np
import pytest
import torch

from tetris_mcts_tpu.cli import train as JTR
from tetris_mcts_tpu.env import engine as JE
from tetris_mcts_tpu.obs import metrics as JMET
from tetris_mcts_tpu.runtime.selfplay import SelfPlayConfig as JSelfPlayConfig
from tetris_mcts_tpu.runtime.selfplay import SelfPlayDriver as JSelfPlayDriver
from tetris_mcts_tpu.search import tree as JT
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu.utils import data as JD
from tetris_mcts_tpu_torch.cli import train as TR
from tetris_mcts_tpu_torch.obs import metrics as MET
from tetris_mcts_tpu_torch.runtime.selfplay import SelfPlayConfig, SelfPlayDriver
from tetris_mcts_tpu_torch.search import mcts as M
from tetris_mcts_tpu_torch.search import tree as T
from tetris_mcts_tpu_torch.utils import data as D
from test_torch_reset import near_top_board
from torch_parity import JaxKeyPlanes, as_i32, port_vvmodel

torch.set_num_threads(1)

B, SIMS, MOVES, SEED, GAME_END = 4, 6, 6, 5, 1
ROW_TOL = dict(rtol=1e-6, atol=1e-5)
VAR_TOL = dict(rtol=1e-5, atol=1e-5)
COLUMN_TOL = {"policy": ROW_TOL, "child_stats": ROW_TOL, "value": ROW_TOL,
              "variance": VAR_TOL}
CFG = dict(batch=B, sims=SIMS, evaluator="lp", max_nodes=128, max_obs=128, table_size=256,
           max_depth=8, benchmark=True, seed=SEED, memory_size=128)


@pytest.fixture(scope="module")
def played(tmp_path_factory):
    """Both drivers, 6 moves with a saver and a status channel, then their
    tree dumps; the port's pre-move and post-move env states a move."""
    tmp = tmp_path_factory.mktemp("rows")
    jm = JVVModel(seed=3)
    jd = JSelfPlayDriver(JSelfPlayConfig(select_kernel=False, insert_kernel=False, **CFG),
                         model=jm, log=lambda s: None, saver=JD.DataSaver(str(tmp / "j")),
                         status=JMET.StatusPublisher(str(tmp / "js"), batch=B))
    pd = SelfPlayDriver(SelfPlayConfig(**CFG), model=port_vvmodel(jm), device="cpu",
                        log=lambda s: None, saver=D.DataSaver(str(tmp / "p")),
                        status=MET.StatusPublisher(str(tmp / "ps"), batch=B))
    planes = JaxKeyPlanes(SEED)
    move = M.make_move_fn(pd.evaluator, pd.search_cfg, planes, store=False)
    pd._move = lambda trees, envs, replay: (planes.next_move(), move(trees, envs, replay))[1]
    jenvs = JE.reset_batch(11, B, jd.search_cfg.tree.env)
    jd.envs = jenvs._replace(rows=jenvs.rows.at[GAME_END].set(near_top_board(4)))
    jd.trees = jax.vmap(JT.init_tree, in_axes=(0, None))(jd.envs, jd.search_cfg.tree)
    pd.envs = torch.as_tensor(as_i32(JE.pack_state(jd.envs)))
    pd.trees = T.init_tree(pd.envs, pd.search_cfg.tree)
    envs = [pd.envs]
    for _ in range(MOVES):
        jd.step()
        pd.step()
        envs.append(pd.envs)
    jd.saver.close()
    pd.saver.close()
    jd.save_nodes(str(tmp / "j" / "tree0.h5"))
    pd.save_nodes(str(tmp / "p" / "tree0.npz"))
    return dict(tmp=tmp, jd=jd, pd=pd, envs=envs,
                got=D.DataLoader(str(tmp / "p" / "data0.rec")),
                want=JD.DataLoader(str(tmp / "j" / "data0.h5")))


@pytest.mark.parametrize("column", list(D.STATE_SCHEMA))
def test_saved_column_matches_jax(played, column):
    got, want = getattr(played["got"], column), getattr(played["want"], column)
    assert got.dtype == want.dtype and got.shape == want.shape == (
        (MOVES * B,) + D.STATE_SCHEMA[column][0])
    if column in COLUMN_TOL:
        np.testing.assert_allclose(got, want, **COLUMN_TOL[column])
    else:
        np.testing.assert_array_equal(got, want)


def test_saved_boards_are_the_pre_move_boards(played):
    from tetris_mcts_tpu_torch.env import engine

    boards = played["got"].board.reshape(MOVES, B, 20, 10)
    for m in range(MOVES):
        pre, post = (engine.get_state(engine.unpack_state(played["envs"][k])).numpy()
                     for k in (m, m + 1))
        np.testing.assert_array_equal(boards[m], pre)
        assert not np.array_equal(boards[m], post)


def test_episode_end_gives_the_lane_the_next_id(played):
    ep = played["got"].episode.reshape(MOVES, B)
    assert played["pd"].episodes == played["jd"].episodes == 1
    np.testing.assert_array_equal(ep[0], np.arange(B))
    np.testing.assert_array_equal(ep[1:, GAME_END], B)  # its game ended on move 0
    np.testing.assert_array_equal(np.delete(ep, GAME_END, axis=1),
                                  np.broadcast_to(np.delete(np.arange(B), GAME_END),
                                                  (MOVES, B - 1)))


def test_status_memmaps_match_jax(played):
    got = MET.StatusReader(str(played["tmp"] / "ps"), batch=B).read()
    want = JMET.StatusReader(str(played["tmp"] / "js"), batch=B).read()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["board"], played["got"].board[-B])  # game 0, last move


def test_save_nodes_matches_jax(played):
    import h5py

    got = np.load(played["tmp"] / "p" / "tree0.npz")
    with h5py.File(played["tmp"] / "j" / "tree0.h5", "r") as f:
        want = {k: f[k][()] for k in f}
    assert set(got.files) == set(want) == {"board", "value", "variance", "visit", "game"}
    assert len(got["game"]) > 0
    for k in ("board", "visit", "game"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["value"], want["value"], **ROW_TOL)
    np.testing.assert_allclose(got["variance"], want["variance"], **VAR_TOL)


# ---------------------------------------------------------------------------
# cli/train: targets, split, file order
# ---------------------------------------------------------------------------

class Columns:
    """A DataLoader's columns: 5 episodes of 8 rows, scores rising."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        n = 40
        self.episode = np.repeat(np.arange(5) * 3 + 1, 8)
        self.board = rng.randint(-1, 2, (n, 20, 10)).astype(np.int8)
        self.score = np.cumsum(rng.randint(0, 50, n)).astype(np.int64)
        self.value = rng.uniform(0, 80, n).astype(np.float32)
        self.variance = rng.uniform(0, 20, n).astype(np.float32)  # some under 0.1
        self.variance[::7] = 0.01
        self.child_stats = rng.uniform(0, 3, (n, 3, 7)).astype(np.float32)
        self.child_stats[3, 0] = 0.0  # a row without visits


@pytest.mark.parametrize("td", [True, False], ids=["td", "mc"])
@pytest.mark.parametrize("weighting", ["none", "visits", "inverse_variance"])
def test_build_targets_match_jax(td, weighting):
    weighted, mode = weighting != "none", int(weighting == "inverse_variance")
    ld = Columns()
    got = TR.build_targets(ld, td, weighted, mode)
    want = JTR.build_targets(ld, td, weighted, mode)
    for name, a, b in zip(("states", "value", "variance", "weight"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_episodic_split_matches_jax(frac):
    ld = Columns(1)
    got = TR.episodic_split(ld, frac, np.random.RandomState(7))
    want = JTR.episodic_split(ld, frac, np.random.RandomState(7))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tr, va = got
    assert set(ld.episode[tr]).isdisjoint(ld.episode[va]) and va.any()


def save_rows(path_dir, cycle, n):
    rng = np.random.RandomState(cycle)
    s = D.DataSaver(str(path_dir), "data", cycle=cycle)
    s.add_batch(episode=np.zeros(n), board=rng.randint(-1, 2, (n, 20, 10)),
                policy=np.full((n, 7), 1 / 7), action=np.zeros(n), combo=np.zeros(n),
                lines=np.zeros(n), line_stats=np.zeros((n, 4)), score=np.full(n, 100 * cycle),
                child_stats=np.ones((n, 3, 7)), value=np.full(n, float(cycle)),
                variance=np.ones(n))
    s.close()


def test_cycle_no_orders_files_numerically(tmp_path, capsys):
    """--last_nfiles takes the newest cycles by number: data10.rec sorts
    before data2.rec by name."""
    for c, n in ((2, 4), (10, 8), (9, 6)):
        save_rows(tmp_path, c, n)
    names = sorted(str(p) for p in tmp_path.glob("data*.rec"))
    assert [TR.cycle_no(p) for p in sorted(names, key=TR.cycle_no)] == [2, 9, 10]
    assert TR.cycle_no("x/data.rec") == -1
    hist = TR.main(["--device", "cpu", "--data", str(tmp_path / "data*.rec"), "--td",
                    "--last_nfiles", "1", "--max_iters", "2", "--iters_per_val", "2",
                    "--batch_size", "4", "--checkpoint", str(tmp_path / "m.pt"),
                    "--dump_dir", str(tmp_path / "dump")])
    assert len(hist) == 1
    assert "Loaded 8 rows from 1 file(s)" in capsys.readouterr().out


def test_saver_columns_ride_on_the_moves_one_host_read(tmp_path, monkeypatch):
    """A move of a driver with a saver and a status channel copies to the
    host once, as a move without them does."""
    reads = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (reads.append(1),
                                                                     cpu(self, *a, **k))[1])
    for channels in (False, True):
        kw = dict(saver=D.DataSaver(str(tmp_path)),
                  status=MET.StatusPublisher(str(tmp_path / "s"), batch=B)) if channels else {}
        d = SelfPlayDriver(SelfPlayConfig(**CFG), device="cpu", log=lambda s: None, **kw)
        d.step()
        reads.clear()
        d.step()
        assert len(reads) == 1, (channels, len(reads))
