"""Batch sweep of the port's `bench_torch.bench_mcts` (the counterpart of
`scripts/sweep_mcts_batch.py`), to see whether the lp move is bound by
latency or by bandwidth: 32 sims, 2 moves a run, 2 timed runs at B = 64,
256 and 1024; one JSON line a batch with the best run's sims/s.

    python scripts/sweep_mcts_batch_torch.py [--device cpu]
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import bench_torch  # noqa: E402
from tetris_mcts_tpu_torch.obs.card import device_label  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(prog="python scripts/sweep_mcts_batch_torch.py")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the card, its kernels) or cpu (the plain versions)")
    dev = bench_torch.device_arg(p, p.parse_args(argv).device)
    label = device_label(dev)
    for b in (64, 256, 1024):
        best, _ = bench_torch.bench_mcts(batch=b, sims=32, moves=2, reps=2, device=dev)
        print(json.dumps({"batch": b, "sims_per_s": round(best, 1), "device": label}),
              flush=True)


if __name__ == "__main__":
    main()
