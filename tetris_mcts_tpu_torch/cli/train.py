"""`train` entry point of the port: offline training of the VV or the VP net
from saved self-play rows (counterpart of the reference package's
`cli/train.py`, the step of the offline cycle that `cycle` drives).

Loads `utils/data.DataSaver` files (`--data`, a glob, ordered by their
cycle number), builds TD or Monte-Carlo targets, weights them, splits a
validation tail (random, or whole held-out episodes with
`--validation`), trains one session with early stopping, saves the
checkpoint and, with `--save_loss`, the loss history.

Targets:
- TD (`--td`): the stored search statistics, value and variance (the
  variance floored at 0.1);
- MC: the return to the episode's end (its final score minus the score
  at the row), variance 1.
Weights (`--weighted`): `--weighted_mode 0` the root's visits (at least
1), 1 the inverse variance; else ones.

`--model vp` trains the VP net on [states, value, the saved root policy
normalised to a distribution, weight], with Adam-amsgrad at lr 1e-4 by
default and no grad-norm watchdog. `--model dist` trains the
distributional net on [states, target distribution, weight]: the targets
(value, variance) projected onto its `--atoms` bins on [0, `--vmax`] as a
normalised Gaussian pmf (`gaussian_dist_targets`), with Yogi at lr 1e-3
and no grad-norm watchdog. `--ensemble K` (K >= 2) trains a K-member deep
ensemble of VV nets (`train/ensemble.py`), with `--ewc` one Fisher a
member. `--ewc`, `--loss_type` and `--ensemble` apply to the VV net only
and are ignored with a message, as in the reference. The VP, dist and
ensemble checkpoints default to their nets' own (`cli.resolve_ckpt`).

    python -m tetris_mcts_tpu_torch train --td --weighted --early_stopping --validation
"""

from __future__ import annotations

import argparse
import glob
import re
import time

import numpy as np
import torch

from tetris_mcts_tpu_torch.train.trainer import DEFAULT_CKPT


def build_parser():
    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch train")
    p.add_argument("--data", default="./data/data*.rec", help="glob of DataSaver files")
    p.add_argument("--td", action="store_true", help="TD targets (else MC)")
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--weighted_mode", type=int, default=1, choices=(0, 1))
    p.add_argument("--early_stopping", action="store_true")
    p.add_argument("--early_stopping_patience", type=int, default=10,
                   help="validation windows without improvement before stopping")
    p.add_argument("--validation", action="store_true",
                   help="episodic validation split (else a random tail)")
    p.add_argument("--val_fraction", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--iters_per_val", type=int, default=500)
    p.add_argument("--epoch_mode", action="store_true",
                   help="an epoch (n_rows // batch_size iterations) a validation window; "
                        "with --early_stopping stop after patience epochs without a "
                        "lower validation loss (threshold 0), else run --epochs epochs")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--min_iters", type=int, default=-1,
                   help="never stop early before this many iterations (-1 = no floor)")
    p.add_argument("--max_iters", type=int, default=100000)
    p.add_argument("--last_nfiles", type=int, default=-1,
                   help="train on the last n data files by cycle number (-1 = all)")
    p.add_argument("--new", action="store_true",
                   help="train a fresh model even with --load_model")
    p.add_argument("--model", default="vv", choices=("vv", "vp", "dist"))
    p.add_argument("--ensemble", type=int, default=0,
                   help="K-member deep ensemble of VV nets (0 = one net; vv model only)")
    p.add_argument("--atoms", type=int, default=50, help="bins of the dist net (--model dist)")
    p.add_argument("--vmax", type=float, default=1000.0,
                   help="the dist net's support is [0, vmax] (--model dist)")
    p.add_argument("--loss_type", default="kldiv",
                   choices=("kldiv", "mle", "weak", "mle_approx", "mae", "mse"))
    p.add_argument("--lr", type=float, default=None,
                   help="learning rate (default 1e-3 vv and dist, 1e-4 vp)")
    p.add_argument("--cycle", type=int, default=0)
    p.add_argument("--save_loss", default="", help="loss-history directory ('' = off)")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT)
    p.add_argument("--load_model", action="store_true")
    p.add_argument("--dump_dir", default="./data",
                   help="the grad-norm watchdog's dump directory")
    p.add_argument("--ewc", action="store_true")
    p.add_argument("--ewc_lambda", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def build_targets(loader, td: bool, weighted: bool, weighted_mode: int):
    """(states, value, variance, weight) from a DataLoader's columns."""
    boards = loader.board.astype(np.int8)
    if td:
        value = loader.value.astype(np.float32)
        variance = np.maximum(loader.variance.astype(np.float32), 1e-1)
    else:
        # the return to the episode's end: its final score - the score here
        score = loader.score.astype(np.float64)
        ep = loader.episode.astype(np.int64)
        final = {}
        for e, s in zip(ep, score):
            final[e] = max(final.get(e, s), s)
        value = np.asarray([final[e] - s for e, s in zip(ep, score)], np.float32)
        variance = np.ones_like(value)
    if not weighted:
        weight = np.ones(len(boards), np.float32)
    elif weighted_mode == 0:
        weight = np.maximum(loader.child_stats[:, 0, :].sum(axis=1).astype(np.float32), 1.0)
    else:
        weight = 1.0 / np.maximum(variance, 1e-1)
    return boards, value, variance, weight


def gaussian_dist_targets(value, variance, atoms: int, vmax: float):
    """Scalar (value, variance) targets as normalised Gaussian pmfs over the
    dist net's bins (centers (b + 0.5) vmax / atoms, the search's grid), in
    float64, returned as float32 (n, atoms)."""
    centers = (np.arange(atoms, dtype=np.float64) + 0.5) * (vmax / atoms)
    sd = np.sqrt(np.maximum(variance.astype(np.float64), 1e-2))[:, None]
    logits = -0.5 * ((centers[None, :] - value[:, None]) / sd) ** 2
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits)
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def episodic_split(loader, frac: float, rng):
    """(train mask, validation mask) holding out whole episodes."""
    eps = np.unique(loader.episode)
    n_val = max(int(len(eps) * frac), 1)
    val_eps = set(rng.choice(eps, n_val, replace=False).tolist())
    val_mask = np.asarray([e in val_eps for e in loader.episode])
    return ~val_mask, val_mask


def cycle_no(path: str) -> int:
    """The cycle number a DataSaver file name ends with (-1 for none), so
    data10.rec sorts after data2.rec."""
    m = re.search(r"(\d+)\.rec$", path)
    return int(m.group(1)) if m else -1


def main(argv=None):
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"not supported by the port yet: {' '.join(unknown)}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: no CUDA device is available "
                     "(pass --device cpu to train on the CPU)")
    from tetris_mcts_tpu_torch.cli import resolve_ckpt
    from tetris_mcts_tpu_torch.train.ensemble import EnsembleVVModel
    from tetris_mcts_tpu_torch.train.trainer import DistModel, VPModel, VVModel
    from tetris_mcts_tpu_torch.utils.data import DataLoader, LossSaver

    paths = sorted(glob.glob(args.data), key=cycle_no)
    if args.last_nfiles > 0:
        paths = paths[-args.last_nfiles:]
    loader = DataLoader(paths)
    print(f"Loaded {len(loader)} rows from {len(paths)} file(s) ({args.data})", flush=True)
    cols = list(build_targets(loader, args.td, args.weighted, args.weighted_mode))
    vp = args.model == "vp"
    if vp:
        pol = loader.policy.astype(np.float32)
        cols[2] = pol / np.maximum(pol.sum(axis=1, keepdims=True), 1e-9)
    elif args.model == "dist":
        states, value, variance, weight = cols
        cols = [states, gaussian_dist_targets(value, variance, args.atoms, args.vmax), weight]

    rng = np.random.RandomState(args.seed)
    val_rows = None
    shuffle = True
    if args.validation:
        tr, va = episodic_split(loader, args.val_fraction, rng)
        order = np.concatenate([np.nonzero(tr)[0], np.nonzero(va)[0]])
        cols = [c[order] for c in cols]
        shuffle = False  # the held-out episodes are the tail
        val_rows = int(va.sum())  # the tail ends exactly at their boundary

    vv = args.model == "vv"
    if not vv:
        for flag, on in (("--ewc", args.ewc), ("--loss_type", args.loss_type != "kldiv"),
                         ("--ensemble", args.ensemble > 0)):
            if on:
                print(f"{flag} applies to the vv model only; ignored", flush=True)
    if vp:
        model = VPModel(args.seed, args.device,
                        checkpoint_path=resolve_ckpt(args.checkpoint, "vp"),
                        lr=1e-4 if args.lr is None else args.lr, weighted=args.weighted)
    elif args.model == "dist":
        model = DistModel(args.atoms, args.seed, args.device,
                          checkpoint_path=resolve_ckpt(args.checkpoint, "dist"),
                          lr=1e-3 if args.lr is None else args.lr, weighted=args.weighted)
    elif args.ensemble > 0:
        model = EnsembleVVModel(args.ensemble, args.seed, args.device,
                                checkpoint_path=resolve_ckpt(args.checkpoint, "ens"),
                                loss_type=args.loss_type, weighted=args.weighted,
                                lr=1e-3 if args.lr is None else args.lr, ewc=args.ewc,
                                ewc_lambda=args.ewc_lambda)
    else:
        model = VVModel(args.seed, args.device, checkpoint_path=args.checkpoint,
                        loss_type=args.loss_type, weighted=args.weighted,
                        lr=1e-3 if args.lr is None else args.lr, ewc=args.ewc,
                        ewc_lambda=args.ewc_lambda)
    if args.load_model and not args.new:
        model.load()

    iters_per_val, max_iters = args.iters_per_val, args.max_iters
    # only the VV net runs the grad-norm watchdog
    extra = {"dump_dir": args.dump_dir} if vv else {}
    if args.epoch_mode:
        iters_per_val = max(len(cols[1]) // args.batch_size, 1)
        max_iters = 10**9 if args.early_stopping else args.epochs * iters_per_val
        extra["early_stopping_threshold"] = 0.0
    t0 = time.perf_counter()
    history = model.train_data(
        cols, batch_size=args.batch_size, iters_per_val=iters_per_val,
        validation_fraction=args.val_fraction, validation_rows=val_rows,
        early_stopping=args.early_stopping,
        early_stopping_patience=args.early_stopping_patience, shuffle=shuffle,
        min_iters=max(args.min_iters, 0), max_iters=max_iters, **extra)
    seconds = time.perf_counter() - t0
    iters = history[-1][0] if history else 0
    print(f"Trained {iters} iterations in {seconds:.2f}s "
          f"({iters / max(seconds, 1e-9):.1f} iterations/s)", flush=True)
    if args.ewc and vv:
        model.compute_fisher(cols)
    model.save(verbose=True)
    if args.save_loss:
        saver = LossSaver(args.save_loss, cycle=args.cycle)
        saver.add_history(history)
        saver.close()
    return history


if __name__ == "__main__":
    main()
