"""The port imports neither JAX nor the JAX package, nor h5py (the card's
machine has none): its modules and chip_smoke.py are checked by their
import statements, and the package is imported in a fresh interpreter
where `jax`, flax, msgpack, the JAX package and `h5py` cannot be imported;
there the JAX package's checkpoint is read and loaded too."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "h5py", "triton",
             "tetris_mcts_tpu")
SOURCES = sorted((ROOT / "tetris_mcts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_modules_are_checked():
    """Every module that wraps a kernel, the move programs that drive
    them (the VP, distributional and stochastic searches' too), the DQN
    agent, the training, replay and metrics modules of
    online self-play, the offline cycle's savers, watchdog and commands,
    and the JAX checkpoint reader are among the sources checked above."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("ops/build.py", "ops/tree_walk.py", "ops/vv_forward.py", "ops/bench_walk.py",
                "search/mcts.py", "search/tree.py", "runtime/selfplay.py", "cli/play.py",
                "models/losses.py", "models/nets.py", "train/optim.py", "train/trainer.py",
                "obs/metrics.py", "utils/data.py", "runtime/watchdog.py", "cli/train.py",
                "cli/cycle.py", "cli/replay.py", "cli/__init__.py", "search/vp.py",
                "search/distributional.py", "train/flax_msgpack.py", "search/stochastic.py",
                "runtime/dqn.py"):
        assert f"tetris_mcts_tpu_torch/{mod}" in names, mod


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'h5py', 'tetris_mcts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pkgutil, importlib, tetris_mcts_tpu_torch as p\n"
        "for mod in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_jax_checkpoint_reads_with_flax_and_msgpack_blocked():
    """train/flax_msgpack.py and VVModel.load read the repo's JAX
    checkpoint in an interpreter where flax, msgpack and JAX cannot be
    imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'h5py', 'tetris_mcts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from tetris_mcts_tpu_torch.train import flax_msgpack\n"
        "from tetris_mcts_tpu_torch.train.trainer import VVModel\n"
        "blob = flax_msgpack.read_jax_checkpoint('checkpoints/model_vv.msgpack')\n"
        "assert blob['params']['params']['fc1']['kernel'].shape == (1792, 256)\n"
        "assert VVModel(device='cpu').load('checkpoints/model_vv.msgpack')\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
