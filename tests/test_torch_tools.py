"""The port's tooling commands against the JAX package's, on the CPU:
`replay` (`cli/replay.py`), `tools` (`cli/tools.py`), the dashboard
(`obs/dashboard.py`) and the record converter (`convert_records.py`).

Inputs are made from numpy seeds: self-play rows and loss histories
written by the port's savers (`.rec`), converted to the JAX package's
HDF5 for its side; a metrics JSONL and status memmaps written by the
port's writers (both packages read the same formats); checkpoints of the
JAX package (the repo's VV net, VP and dist nets saved here), which the
port reads through `train/flax_msgpack.py`.

- `replay --dump` prints the JAX frames exactly; with `--model` the
  re-inferred value and variance agree within the VV net's bounds
  (tests/test_ops.py: rtol 1e-4, atol 1e-3 value, 1e-2 variance) at the
  two decimals printed.
- The port's GIF (numpy, no PIL), decoded by PIL, is the JAX GIF's frames,
  durations and loop.
- `tools sanity` for vv, vp and dist: the parameter count and every line's
  text equal, the numbers within those bounds (dist: the atom means and
  entropies rtol 1e-4 / atol 1e-3); `print_dump_grad` prints the JAX lines
  on a port dump; `plot` writes the JAX SVGs byte for byte (lines, score,
  loss from a metrics file, loss from records, entropy, dump, response).
- The dashboard's `/data` snapshot equals the JAX `DashboardState`'s;
  `weight_histograms` on a port checkpoint of carried weights gives the
  JAX counts and ranges; the server answers `/data` with JSON.
- `convert_records.py`: `.rec` -> HDF5 -> the JAX loaders give the port
  loaders' arrays, and HDF5 -> `.rec` gives them back.
"""

import json
import os
import re
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from tetris_mcts_tpu.cli import replay as JR
from tetris_mcts_tpu.cli import tools as JTools
from tetris_mcts_tpu.obs import dashboard as JD
from tetris_mcts_tpu.train.trainer import DistModel as JDistModel
from tetris_mcts_tpu.train.trainer import VPModel as JVPModel
from tetris_mcts_tpu.train.trainer import VVModel as JVVModel
from tetris_mcts_tpu.utils import data as JData
from tetris_mcts_tpu_torch.cli import replay as R
from tetris_mcts_tpu_torch.cli import tools as Tools
from tetris_mcts_tpu_torch.obs import dashboard as D
from tetris_mcts_tpu_torch.obs.metrics import MetricsWriter, StatusPublisher
from tetris_mcts_tpu_torch.train.trainer import VVModel, params_from_jax
from tetris_mcts_tpu_torch.utils import data as PData

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import convert_records  # noqa: E402

VV_CKPT = os.path.join(ROOT, "checkpoints", "model_vv.msgpack")
NUM = re.compile(r"-?\d+\.\d+")


def _rows(n_moves=12, B=3, seed=0):
    """A port self-play file's rows: B games, n_moves moves, episodes 0..B-1
    (game 1 ends and starts episode B)."""
    rng = np.random.RandomState(seed)
    out = []
    for mv in range(n_moves):
        ep = np.arange(B)
        if mv >= n_moves // 2:
            ep[1] = B
        pol = rng.dirichlet(np.ones(7), B).astype(np.float32)
        out.append(dict(episode=ep, board=rng.randint(-1, 2, (B, 20, 10)).astype(np.int8),
                        policy=pol, action=rng.randint(0, 7, B), combo=rng.randint(0, 3, B),
                        lines=rng.randint(0, 9, B), line_stats=rng.randint(0, 3, (B, 4)),
                        score=rng.randint(0, 500, B),
                        child_stats=rng.uniform(0, 40, (B, 3, 7)).astype(np.float32),
                        value=rng.uniform(0, 90, B), variance=rng.uniform(0, 9, B)))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    for cycle in (0, 1):
        s = PData.DataSaver(str(d / "rec"), cycle=cycle)
        for row in _rows(seed=cycle):
            s.add_batch(**row)
        s.close()
    ls = PData.LossSaver(str(d / "rec"))
    rng = np.random.RandomState(4)
    ls.add_history([(10 * (i + 1), *rng.uniform(0.5, 3, 3), rng.uniform(0, 9))
                    for i in range(6)])
    ls.close()
    for name in ("data0", "data1", "loss0"):
        convert_records.convert(str(d / "rec" / f"{name}.rec"), str(d / "h5" / f"{name}.h5"))
    # metrics and status memmaps, written by the port
    m = MetricsWriter(str(d / "m.jsonl"))
    for i in range(7):
        m.write("episode", n=i + 1, lines=int(rng.randint(0, 40)), score=int(rng.randint(0, 900)),
                benchmark=False)
        m.write("throughput", moves=i, sims_per_s=float(rng.uniform(1e3, 1e4)))
    for i in range(3):
        m.write("train_session", n=i + 1, rows=128 * (i + 1), seconds=1.0, iters=20,
                loss_train=float(rng.uniform(0.5, 2)), loss_val=float(rng.uniform(0.5, 2)),
                grad_norm=None if i == 1 else float(rng.uniform(1, 9)))
    m.close()
    st = StatusPublisher(str(d / "status"), batch=2)
    st.publish(rng.randint(-1, 2, (20, 10)), [1, 2], [30, 40], [3, 4], rng.randint(0, 3, (2, 4)))
    # a training-set dump and a grad dump, written by the port
    jm = JVVModel(checkpoint_path=VV_CKPT)
    jm.load()
    port = VVModel(device="cpu")
    port.load(VV_CKPT)
    n = 300
    states = rng.randint(-1, 2, (n, 20, 10)).astype(np.int8)
    np.savez(d / "dump", states=states, values=rng.uniform(0, 90, n),
             variance=rng.uniform(0.1, 20, n), weights=rng.uniform(1, 5, n))
    batch = (torch.as_tensor(states[:6, None]).float(), torch.as_tensor(rng.uniform(0, 9, 6)),
             torch.as_tensor(rng.uniform(0, 9, 6)), torch.as_tensor(rng.uniform(1, 2, 6)))
    port._dump_grad_batch(batch, str(d))
    return d


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


def _close_lines(got, want, rtol=1e-4, atol=1e-2):
    """Equal text with the numbers masked; the numbers within tolerance."""
    assert NUM.sub("#", got) == NUM.sub("#", want)
    a = np.array([float(x) for x in NUM.findall(got)])
    b = np.array([float(x) for x in NUM.findall(want)])
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# convert_records.py
# ---------------------------------------------------------------------------

def test_converted_records_load_the_same_in_both_packages(files, tmp_path):
    got = PData.DataLoader(str(files / "rec" / "data*.rec"))
    want = JData.DataLoader(str(files / "h5" / "data*.h5"))
    for k in PData.STATE_SCHEMA:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert getattr(got, k).dtype == getattr(want, k).dtype, k
    lg, lw = PData.LossLoader(str(files / "rec" / "loss0.rec")), \
        JData.LossLoader(str(files / "h5" / "loss0.h5"))
    for k in PData.LOSS_SCHEMA:
        np.testing.assert_array_equal(getattr(lg, k), getattr(lw, k), err_msg=k)
    # and back: HDF5 -> .rec, byte for byte the port's own files
    res = subprocess.run([sys.executable, os.path.join(ROOT, "convert_records.py"),
                          str(files / "h5" / "data0.h5"), str(files / "h5" / "loss0.h5"),
                          str(tmp_path) + os.sep], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for name in ("data0", "loss0"):
        assert (tmp_path / f"{name}.rec").read_bytes() == \
            (files / "rec" / f"{name}.rec").read_bytes(), name
    # a JAX saver's file comes over too
    js = JData.LossSaver(str(tmp_path / "j"), cycle=3)
    js.add(5, 1.5, 2.5, 0.5, 7.0)
    js.close()
    convert_records.convert(js.path, str(tmp_path / "j" / "loss3.rec"))
    back = PData.LossLoader(str(tmp_path / "j" / "loss3.rec"))
    assert (int(back.cycle[0]), int(back.iteration[0]), float(back.grad_norm[0])) == (3, 5, 7.0)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("episode", [None, 3])
def test_replay_dump_prints_the_jax_frames(files, capsys, episode):
    ep = [] if episode is None else ["--episode", str(episode)]
    rc, got = _run(R.main, [str(files / "rec" / "data0.rec"), "--dump", "--device", "cpu"] + ep,
                   capsys)
    JR.main([str(files / "h5" / "data0.h5"), "--dump"] + ep)
    want = capsys.readouterr().out
    assert rc == 0 and got == want and got.count("frame ") == (6 if episode else 12)


def test_replay_dump_with_the_model_matches_jax(files, capsys):
    args = ["--dump", "--episode", "1", "--model", VV_CKPT]
    rc, got = _run(R.main, [str(files / "rec" / "data0.rec"), "--device", "cpu"] + args, capsys)
    JR.main([str(files / "h5" / "data0.h5")] + args)
    want = capsys.readouterr().out
    assert rc == 0 and got.count("model value") == 6
    _close_lines(got, want)


def test_replay_missing_episode(files, capsys):
    assert R.main([str(files / "rec" / "data0.rec"), "--episode", "99", "--device", "cpu"]) == 1
    assert "episode 99 not found" in capsys.readouterr().err


@pytest.mark.parametrize("scale", [1, 4, 20])
def test_gif_decodes_to_the_jax_frames(files, tmp_path, scale):
    boards = PData.DataLoader(str(files / "rec" / "data0.rec")).board[::3][:8].copy()
    boards[3] = boards[2]  # a repeated frame is merged, its duration added
    R.write_gif(boards, tmp_path / "p.gif", scale=scale, duration_ms=70)
    JR.write_gif(boards, tmp_path / "j.gif", scale=scale, duration_ms=70)

    def decode(p):
        im = Image.open(p)
        frames = [(np.asarray(f.convert("L")), f.info.get("duration"))
                  for f in ImageSequence.Iterator(im)]
        return frames, im.info.get("loop")

    (got, loop), (want, jloop) = decode(tmp_path / "p.gif"), decode(tmp_path / "j.gif")
    assert loop == jloop == 0 and len(got) == len(want) == 7
    for (a, da), (b, db) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert da == db
    assert got[2][1] == 140


def test_replay_writes_a_gif(files, tmp_path, capsys):
    rc, out = _run(R.main, [str(files / "rec" / "data0.rec"), "--episode", "0", "--gif",
                            str(tmp_path / "e.gif"), "--gif_scale", "2", "--device", "cpu"], capsys)
    assert rc == 0 and "wrote 12 frames" in out
    assert Image.open(tmp_path / "e.gif").n_frames >= 1


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_nets(tmp_path_factory):
    d = tmp_path_factory.mktemp("nets")
    JVPModel(seed=2).save(str(d / "vp.msgpack"))
    JDistModel(seed=3).save(str(d / "dist.msgpack"))
    return {"vv": VV_CKPT, "vp": str(d / "vp.msgpack"), "dist": str(d / "dist.msgpack")}


@pytest.mark.parametrize("net", ["vv", "vp", "dist"])
def test_sanity_matches_jax(jax_nets, capsys, net):
    args = ["sanity", "--model", net, "--checkpoint", jax_nets[net]]
    rc, got = _run(Tools.main, args + ["--device", "cpu"], capsys)
    JTools.main(args)
    want = capsys.readouterr().out
    assert rc == 0
    assert got.splitlines()[0] == want.splitlines()[0]  # Parameters: N
    _close_lines(got, want, atol=1e-3 if net == "dist" else 1e-2)


def test_print_dump_grad_matches_jax(files, capsys):
    rc, got = _run(Tools.main, ["print_dump_grad", str(files / "dump_grad.npz")], capsys)
    JTools.main(["print_dump_grad", str(files / "dump_grad.npz")])
    assert rc == 0 and got == capsys.readouterr().out and got.count("sample ") == 6


@pytest.mark.parametrize("what", ["lines", "score", "loss", "loss_rec", "entropy", "dump",
                                  "response"])
def test_plot_writes_the_jax_svg(files, tmp_path, capsys, what):
    common = {"lines": ["--metrics", str(files / "m.jsonl")],
              "score": ["--metrics", str(files / "m.jsonl")],
              "loss": ["--metrics", str(files / "m.jsonl")],
              "dump": ["--dump", str(files / "dump.npz")],
              "response": ["--dump", str(files / "dump.npz"), "--checkpoint", VV_CKPT]}
    port = {"loss_rec": ["--loss", str(files / "rec" / "loss*.rec")],
            "entropy": ["--data", str(files / "rec" / "data*.rec")]}
    jax_ = {"loss_rec": ["--loss", str(files / "h5" / "loss*.h5")],
            "entropy": ["--data", str(files / "h5" / "data*.h5")]}
    w = "loss" if what == "loss_rec" else what
    rc, _ = _run(Tools.main, ["plot", "--what", w, "--out", str(tmp_path / "p.svg"),
                              "--device", "cpu"] + common.get(what, port.get(what)), capsys)
    JTools.main(["plot", "--what", w, "--out", str(tmp_path / "j.svg")]
                + common.get(what, jax_.get(what)))
    got, want = (tmp_path / "p.svg").read_text(), (tmp_path / "j.svg").read_text()
    assert rc == 0 and got == want and len(got) > 500


def test_tools_inference_speed_and_train_dump_on_cpu(files, tmp_path, capsys):
    rc, out = _run(Tools.main, ["inference_speed", "--iters", "3", "--batch", "4",
                                "--device", "cpu"], capsys)
    row = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and row["iters"] == 3 and row["inferences_per_s"] > 0
    rc, out = _run(Tools.main, ["train_dump", str(files / "dump.npz"), "--max_iters", "4",
                                "--iters_per_val", "2", "--batch_size", "16", "--save_model",
                                "--checkpoint", str(tmp_path / "ck.pt"), "--device", "cpu"],
                   capsys)
    assert rc == 0 and (tmp_path / "ck.pt").exists()


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------

def test_dashboard_snapshot_matches_jax(files):
    args = (str(files / "m.jsonl"), str(files / "status"), 2, VV_CKPT)
    got, want = D.DashboardState(*args).snapshot(), JD.DashboardState(*args).snapshot()
    assert got == want
    assert len(got["episodes"]) == 7 and len(got["trains"]) == 3 and got["board"] is not None
    assert [w["name"] for w in got["weights"]] == ["conv1", "conv2", "conv3", "fc1", "fc_out"]


def test_weight_histograms_of_carried_weights_match_jax(tmp_path):
    jm = JVVModel(seed=5)
    jm.save(str(tmp_path / "j.msgpack"))
    m = VVModel(device="cpu")
    m.load_state(*params_from_jax(jax.tree.map(np.asarray, jm.params), jm.ubound, jm.lbound))
    m.save(str(tmp_path / "p.pt"))
    got = D.weight_histograms(str(tmp_path / "p.pt"))
    want = JD.weight_histograms(str(tmp_path / "j.msgpack"))
    assert got == want
    assert D.weight_histograms(str(tmp_path / "j.msgpack")) == want


def test_dashboard_serves_data(files):
    httpd = D.serve(str(files / "m.jsonl"), port=0, blocking=False, host="127.0.0.1",
                    checkpoint=VV_CKPT)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        data = json.loads(urllib.request.urlopen(url + "/data", timeout=30).read())
        page = urllib.request.urlopen(url + "/", timeout=30).read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert len(data["episodes"]) == 7 and len(data["weights"]) == 5
    assert "live self-play" in page
