"""The port's self-play rows and loss history on disk (`utils/data.py`,
numpy records) and its live-state memmaps (`obs/metrics.StatusPublisher`)
against the JAX package's (HDF5 through h5py, and the same memmaps).

The same rows, made from a seed with numpy, go through the JAX savers and
loaders and through the port's: every column comes back equal (the schemas
are the same, so each row is stored at the same dtype). Also: the episode
offset across files, the loss saver with and without a grad-norm column,
a truncated trailing record, refused foreign files, and the status files
read across the two packages.
"""

import os

import numpy as np
import pytest

from tetris_mcts_tpu.obs import metrics as JMET
from tetris_mcts_tpu.utils import data as JD
from tetris_mcts_tpu_torch.obs import metrics as MET
from tetris_mcts_tpu_torch.utils import data as D

FIELDS = ([("state", k) for k in JD.STATE_SCHEMA] + [("loss", k) for k in JD.LOSS_SCHEMA])


@pytest.mark.parametrize("schema,field", FIELDS, ids=[f"{s}.{k}" for s, k in FIELDS])
def test_schema_field_matches_jax(schema, field):
    want = (JD.STATE_SCHEMA if schema == "state" else JD.LOSS_SCHEMA)
    got = (D.STATE_SCHEMA if schema == "state" else D.LOSS_SCHEMA)
    assert list(got) == list(want)  # the same order too
    (gs, gt), (ws, wt) = got[field], want[field]
    assert gs == ws and np.dtype(gt) == np.dtype(wt)


def test_record_dtype_is_packed_little_endian():
    dt = D.record_dtype(D.STATE_SCHEMA)
    sizes = [int(np.prod(s, dtype=np.int64)) * np.dtype(t).itemsize
             for s, t in D.STATE_SCHEMA.values()]
    assert dt.itemsize == sum(sizes) == 4 + 200 + 28 + 4 + 4 + 4 + 16 + 8 + 84 + 4 + 4 + 4
    assert all(dt.fields[k][0].base.byteorder in "<|" for k in D.STATE_SCHEMA)


def rows(n, ep0=0, seed=0):
    """One batch of saver rows of mixed input dtypes (the savers cast)."""
    rng = np.random.RandomState(seed)
    return dict(
        episode=np.arange(ep0, ep0 + n), board=rng.randint(-1, 2, (n, 20, 10)),
        policy=rng.dirichlet(np.ones(7), n), action=rng.randint(0, 7, n),
        combo=rng.randint(0, 4, n), lines=np.arange(n), line_stats=rng.randint(0, 9, (n, 4)),
        score=rng.randint(0, 2**40, n), child_stats=rng.rand(n, 3, 7) * 50,
        value=rng.rand(n) * 100, variance=rng.rand(n) + 1)


def save_both(tmp_path, batches, cycle=0, name="data"):
    js = JD.DataSaver(str(tmp_path / "jax"), name, cycle=cycle)
    ps = D.DataSaver(str(tmp_path / "port"), name, cycle=cycle)
    for b in batches:
        js.add_batch(**b)
        ps.add_batch(**b)
    assert len(js) == len(ps)
    js.close()
    ps.close()
    return js.path, ps.path


def assert_loaders_equal(got, want, schema):
    assert got.n == want.n
    for k in schema:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_saver_loader_round_trip_matches_jax(tmp_path):
    jpath, ppath = save_both(tmp_path, [rows(5), rows(4, ep0=5, seed=1)], cycle=3)
    assert ppath.endswith("data3.rec")
    assert_loaders_equal(D.DataLoader(ppath), JD.DataLoader(jpath), D.STATE_SCHEMA)
    assert (D.DataLoader(ppath).cycle == 3).all()


def test_loader_offsets_episode_ids_across_files_as_jax(tmp_path):
    for c in (0, 1, 2):
        save_both(tmp_path, [rows(3, ep0=0, seed=c), rows(2, ep0=1, seed=10 + c)], cycle=c)
    got = D.DataLoader(str(tmp_path / "port" / "data*.rec"))
    want = JD.DataLoader(str(tmp_path / "jax" / "data*.h5"))
    assert_loaders_equal(got, want, D.STATE_SCHEMA)
    assert len(np.unique(got.episode)) == 9 and set(got.cycle.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("grad_norm", [False, True])
def test_loss_saver_matches_jax(tmp_path, grad_norm):
    hist = [(100, 2.0, 2.1, 0.1), (200, 1.5, 1.6, 0.1), (300, 1.25, 1.3, 0.05)]
    if grad_norm:
        hist = [h + (0.5 * i + 0.25,) for i, h in enumerate(hist)]
    for mod, sub in ((JD, "jax"), (D, "port")):
        s = mod.LossSaver(str(tmp_path / sub), cycle=1)
        s.add_history(hist)
        s.close()
    got = D.LossLoader(str(tmp_path / "port" / "loss1.rec"))
    want = JD.LossLoader(str(tmp_path / "jax" / "loss1.h5"))
    assert_loaders_equal(got, want, D.LOSS_SCHEMA)
    assert (got.grad_norm != 0).all() == grad_norm


def test_saver_flushes_every_batch(tmp_path):
    s = D.DataSaver(str(tmp_path), cycle=0)
    s.add_batch(**rows(4))
    assert len(D.DataLoader(s.path)) == 4  # readable while the saver is open
    s.add_batch(**rows(2, seed=3))
    assert len(D.DataLoader(s.path)) == 6
    s.close()


def test_truncated_trailing_record_is_dropped(tmp_path, capsys):
    s = D.DataSaver(str(tmp_path), cycle=0)
    s.add_batch(**rows(5))
    s.close()
    size = os.path.getsize(s.path)
    with open(s.path, "r+b") as f:
        f.truncate(size - 17)  # a crash in the middle of the fifth row
    ld = D.DataLoader(s.path)
    assert len(ld) == 4
    np.testing.assert_array_equal(ld.board, rows(5)["board"][:4].astype(np.int8))
    assert "dropping a trailing partial record" in capsys.readouterr().err


def test_foreign_files_are_refused(tmp_path):
    jpath, _ = save_both(tmp_path, [rows(3)])
    with pytest.raises(ValueError, match="HDF5 file of the JAX package"):
        D.DataLoader(jpath)
    loss = D.LossSaver(str(tmp_path), cycle=0)
    loss.add(1, 1.0, 1.0, 0.1)
    loss.close()
    with pytest.raises(ValueError, match="not a record file of this schema"):
        D.DataLoader(loss.path)  # a loss file read as self-play rows
    with pytest.raises(FileNotFoundError, match="no data files"):
        D.DataLoader(str(tmp_path / "none*.rec"))


def status_inputs(seed=0, batch=4):
    rng = np.random.RandomState(seed)
    return (rng.randint(-1, 2, (20, 10)), rng.randint(0, 5, batch),
            rng.randint(0, 2**40, batch), rng.randint(0, 300, batch),
            rng.randint(0, 50, (batch, 4)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_status_memmaps_read_across_packages(tmp_path, writer):
    args = status_inputs()
    pub = (MET if writer == "port" else JMET).StatusPublisher(str(tmp_path), batch=4)
    pub.publish(*args)
    got = MET.StatusReader(str(tmp_path), batch=4).read()
    want = JMET.StatusReader(str(tmp_path), batch=4).read()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["board"], args[0].astype(np.int8))
    np.testing.assert_array_equal(got["score"], args[2])
    assert MET.StatusReader(str(tmp_path / "none"), batch=4).read() is None
