"""`dashboard`: serve the live dashboard over a run's metrics JSONL
(counterpart of the reference package's `cli/dashboard.py`;
`obs/dashboard.py` holds the server)."""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch dashboard")
    p.add_argument("--metrics", required=True, help="JSONL metrics path")
    p.add_argument("--status_dir", default="",
                   help="live-state memmap dir ('' = no board panel)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--port", type=int, default=8050, help="0: any free port")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint to watch for the weight-histogram panel")
    args = p.parse_args(argv)

    from tetris_mcts_tpu_torch.obs.dashboard import serve

    serve(args.metrics, args.status_dir, args.batch, args.port, checkpoint=args.checkpoint)
    return 0


if __name__ == "__main__":
    main()
