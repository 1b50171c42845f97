"""`tools`: the inspection commands (counterpart of the reference package's
`cli/tools.py`), on the port's nets, checkpoints and records:

  sanity           a net's parameter count, its predictions on synthetic
                   boards, the horizontal-flip RMSE, and the entropies
                   (the dist net's per board, the vp net's policy's)
  inference_speed  a timed loop of VV inferences (CUDA events on a card)
  train_dump       re-train offline from a training-set dump (dump.npz)
  print_dump_grad  print the grad-norm watchdog's dump (dump_grad.npz)
  plot             static SVG charts: episode lines or score and session
                   losses from a metrics JSONL, the loss history of loss
                   .rec files, the search-policy entropy of data .rec
                   files, a dump's histograms, a net's response on a dump

The nets run on the card unless `--device cpu`, and a card is refused
where there is none, as `play` does. Checkpoints are the port's, or the
JAX package's (read by `train/flax_msgpack.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _synthetic_boards(n=5, seed=0):
    """Stacks of random garbage rows, each row with a hole."""
    rng = np.random.RandomState(seed)
    boards = np.zeros((n, 20, 10), np.int8)
    for i in range(n):
        height = rng.randint(0, 12)
        for r in range(20 - height, 20):
            row = rng.randint(0, 2, 10)
            row[rng.randint(10)] = 0  # keep a hole: not a full line
            boards[i, r] = row
    return boards


def _entropy(p):
    return float(-np.sum(p * np.log(np.maximum(p, 1e-12))))


def cmd_sanity(args):
    """Parameter count, predictions on synthetic boards, horizontal-flip
    invariance; the dist net also prints each board's distribution
    entropy, the vp net its policy's."""
    from tetris_mcts_tpu_torch.cli import resolve_ckpt
    from tetris_mcts_tpu_torch.train.trainer import DistModel, VPModel, VVModel

    cls = {"vv": VVModel, "vp": VPModel, "dist": DistModel}[args.model]
    model = cls(device=args.device, checkpoint_path=resolve_ckpt(args.checkpoint, args.model))
    model.load()
    print(f"Parameters: {sum(p.numel() for p in model.net.parameters())}")

    boards = _synthetic_boards()
    flipped = np.ascontiguousarray(boards[:, :, ::-1])
    if args.model == "dist":
        d = model.inference(boards)
        centers = np.arange(d.shape[1]) + 0.5
        for i in range(len(boards)):
            print(f"board {i}: mean atom {float((d[i] * centers).sum()):7.2f}   "
                  f"entropy {_entropy(d[i]):6.3f}")
        rmse = float(np.sqrt(np.mean((d - model.inference(flipped)) ** 2)))
        print(f"flip-invariance RMSE (distribution): {rmse:.6f}")
        return 0
    if args.model == "vp":
        v, pol = model.inference(boards)
        for i in range(len(boards)):
            print(f"board {i}: value {float(v[i, 0]):8.3f}   "
                  f"policy entropy {_entropy(pol[i]):6.3f}")
    else:
        v, var = model.inference(boards)
        for i in range(len(boards)):
            print(f"board {i}: value {float(v[i, 0]):8.3f}   "
                  f"variance {float(var[i, 0]):8.3f}")
    v2, _ = model.inference(flipped)
    print(f"flip-invariance RMSE: {float(np.sqrt(np.mean((v - v2) ** 2))):.4f}")
    return 0


def cmd_inference_speed(args):
    """`iters` inferences of the VV net on `batch` boards (each a host read
    of its outputs), timed between CUDA events on a card."""
    import torch

    from tetris_mcts_tpu_torch.train.trainer import VVModel

    model = VVModel(device=args.device)
    boards = _synthetic_boards(args.batch)
    model.inference(boards)  # warm-up: cuDNN's choice, the allocator
    cuda = model.device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        model.inference(boards)
    if cuda:
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        dt = time.perf_counter() - t0
    print(json.dumps({"iters": args.iters, "batch": args.batch, "seconds": round(dt, 3),
                      "inferences_per_s": round(args.iters * args.batch / dt, 1),
                      "device": str(model.device)}))
    return 0


def cmd_train_dump(args):
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    blob = np.load(args.dump)
    model = VVModel(device=args.device, checkpoint_path=args.checkpoint)
    if args.load_model:
        model.load()
    data = [blob["states"], blob["values"], blob["variance"], blob["weights"]]
    model.train_data(data, batch_size=args.batch_size, iters_per_val=args.iters_per_val,
                     max_iters=args.max_iters, shuffle=True)
    # a reproducibility probe, not a trainer: saving is opt-in
    if args.save_model:
        model.save(verbose=True)
    return 0


def cmd_print_dump_grad(args):
    blob = np.load(args.dump)
    for i in range(len(blob["states"])):
        print(f"sample {i}: target value {float(blob['value'][i]):.3f} "
              f"variance {float(blob['variance'][i]):.3f} "
              f"weight {float(blob['weight'][i]):.3f} "
              f"pred value {float(blob['pred_value'][i]):.3f} "
              f"pred variance {float(blob['pred_variance'][i]):.3f}")
    return 0


def _svg_line(series, w=640, h=240, pad=36, colors=("#2a78d6", "#eb6834")):
    """A static SVG line chart, one hue a series, 2px strokes."""
    allv = [v for s in series for v in s if v is not None]
    if not allv:
        return "<svg/>"
    ymin, ymax = min(min(allv), 0), max(allv)
    nmax = max(max(len(s) for s in series) - 1, 1)
    X = lambda i: pad + (w - 2 * pad) * i / nmax
    Y = lambda v: h - pad - (h - 2 * pad) * (v - ymin) / (ymax - ymin or 1)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
             f'style="background:#fcfcfb">']
    for f in (ymin, (ymin + ymax) / 2, ymax):
        parts.append(f'<line x1="{pad}" x2="{w - pad}" y1="{Y(f):.1f}" '
                     f'y2="{Y(f):.1f}" stroke="#e3e2dd"/>')
        parts.append(f'<text x="2" y="{Y(f) + 3:.1f}" font-size="10" '
                     f'fill="#52514e">{f:.3g}</text>')
    for k, s in enumerate(series):
        pts = " ".join(f"{X(i):.1f},{Y(v):.1f}" for i, v in enumerate(s))
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{colors[k % len(colors)]}" stroke-width="2"/>')
    parts.append("</svg>")
    return "".join(parts)


def _svg_hists(panels, w=260, h=160, pad=28):
    """Histogram / heatmap panels in one SVG grid: ("hist", title, counts,
    lo, hi) with log-scaled bar heights, or ("hist2d", title, counts2d,
    (xlo, xhi), (ylo, yhi)) as a log-shaded heatmap with the y = x guide."""
    cols = min(len(panels), 2)
    rows = (len(panels) + cols - 1) // cols
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{cols * w}" '
             f'height="{rows * h}" style="background:#fcfcfb">']
    for k, panel in enumerate(panels):
        x0, y0 = (k % cols) * w, (k // cols) * h
        kind, title = panel[0], panel[1]
        parts.append(f'<text x="{x0 + pad}" y="{y0 + 12}" font-size="11" '
                     f'fill="#0b0b0b">{title}</text>')
        if kind == "hist":
            counts, lo, hi = panel[2], panel[3], panel[4]
            lc = np.log1p(np.asarray(counts, np.float64))
            top = lc.max() or 1.0
            bw = (w - 2 * pad) / len(counts)
            for i, v in enumerate(lc):
                if not v:
                    continue
                bh = (h - 2 * pad) * v / top
                parts.append(f'<rect x="{x0 + pad + i * bw:.1f}" '
                             f'y="{y0 + h - pad - bh:.1f}" width="{max(bw - .5, .5):.1f}" '
                             f'height="{bh:.1f}" fill="#2a78d6"/>')
            for x, v, anchor in ((x0 + pad, lo, "start"), (x0 + w - pad, hi, "end")):
                parts.append(f'<text x="{x}" y="{y0 + h - pad + 12}" '
                             f'font-size="10" text-anchor="{anchor}" '
                             f'fill="#52514e">{v:.3g}</text>')
        else:
            c2, (xlo, xhi), (ylo, yhi) = panel[2], panel[3], panel[4]
            lc = np.log1p(np.asarray(c2, np.float64))
            top = lc.max() or 1.0
            nx, ny = lc.shape
            cw, ch = (w - 2 * pad) / nx, (h - 2 * pad) / ny
            for i in range(nx):
                for j in range(ny):
                    if not lc[i, j]:
                        continue
                    op = 0.15 + 0.85 * lc[i, j] / top
                    parts.append(f'<rect x="{x0 + pad + i * cw:.1f}" '
                                 f'y="{y0 + h - pad - (j + 1) * ch:.1f}" '
                                 f'width="{cw + .3:.1f}" height="{ch + .3:.1f}" '
                                 f'fill="#2a78d6" fill-opacity="{op:.2f}"/>')
            parts.append(f'<line x1="{x0 + pad}" y1="{y0 + h - pad}" '
                         f'x2="{x0 + w - pad}" y2="{y0 + pad}" '
                         f'stroke="#eb6834" stroke-width="1"/>')
            for x, v, anchor in ((x0 + pad, xlo, "start"), (x0 + w - pad, xhi, "end")):
                parts.append(f'<text x="{x}" y="{y0 + h - pad + 12}" '
                             f'font-size="10" text-anchor="{anchor}" '
                             f'fill="#52514e">{v:.3g}</text>')
    parts.append("</svg>")
    return "".join(parts)


def _plot_entropy(data_glob):
    """Mean search-policy entropy of each data file, by cycle, beside the
    ln(7) ceiling: p = the root's child visit fractions, or the policy
    column where the search keeps no visit statistics (VP, dist, S2)."""
    import glob

    from tetris_mcts_tpu_torch.utils.data import DataLoader

    xs, ys = [], []
    for f in sorted(glob.glob(data_glob)):
        d = DataLoader([f])
        if len(d) == 0:  # a run ended before its first move
            continue
        n = d.child_stats[:, 0, :].astype(np.float64)
        n_sum = n.sum(axis=1, keepdims=True)
        ok = n_sum[:, 0] > 0
        if not ok.any():
            p = d.policy.astype(np.float64)
            p_sum = p.sum(axis=1, keepdims=True)
            ok = p_sum[:, 0] > 0
            p = p[ok] / p_sum[ok]
        else:
            p = n[ok] / n_sum[ok]
        ent = -np.sum(np.where(p > 0, p * np.log(np.maximum(p, 1e-30)), 0.0), axis=1)
        xs.append(int(d.cycle[0]))
        ys.append(float(ent.mean()) if len(ent) else 0.0)
    ent_series = [ys[i] for i in np.argsort(xs)]
    return [ent_series, [float(np.log(7))] * len(ent_series)]


def _plot_dump(dump_path, out, bins=60):
    """Value, variance and weight histograms of a training-set dump."""
    blob = np.load(dump_path)
    panels = []
    for name in ("values", "variance", "weights"):
        v = np.squeeze(blob[name]).astype(np.float64)
        lo, hi = float(v.min()), float(v.max())
        counts, _ = np.histogram(v, bins=bins, range=(lo, hi or 1.0))
        panels.append(("hist", name, counts, lo, hi))
    with open(out, "w") as f:
        f.write(_svg_hists(panels))


def _plot_response(dump_path, checkpoint, out, device, bins=50, pclip=1.0):
    """A net's response against a dump's targets: the dumped states
    re-inferred, truth against prediction heatmapped for value and
    variance, split 90/10 into train and validation as the dump was."""
    from tetris_mcts_tpu_torch.train.trainer import VVModel

    blob = np.load(dump_path)
    states = blob["states"]
    value_t = np.squeeze(blob["values"]).astype(np.float64)
    var_t = np.squeeze(blob["variance"]).astype(np.float64)
    model = VVModel(device=device, checkpoint_path=checkpoint)
    model.load()
    vp, varp = [], []
    for i in range(0, len(states), 256):
        v, var = model.inference(states[i:i + 256])
        vp.append(np.squeeze(v, -1))
        varp.append(np.squeeze(var, -1))
    value_p = np.concatenate(vp).astype(np.float64)
    var_p = np.concatenate(varp).astype(np.float64)
    v_size = max(int(len(states) * 0.1), 1)
    panels = []
    for name, t, p_ in (("value", value_t, value_p), ("variance", var_t, var_p)):
        for split, sl in (("train", slice(None, -v_size)), ("valid", slice(-v_size, None))):
            ts, ps = t[sl], p_[sl]
            lo = min(np.percentile(ts, pclip), np.percentile(ps, pclip))
            hi = max(np.percentile(ts, 100 - pclip), np.percentile(ps, 100 - pclip))
            if hi <= lo:
                hi = lo + 1.0
            c2, _, _ = np.histogram2d(ts, ps, bins=bins, range=((lo, hi), (lo, hi)))
            panels.append(("hist2d", f"{name} truth vs pred ({split})", c2, (lo, hi),
                           (lo, hi)))
    with open(out, "w") as f:
        f.write(_svg_hists(panels))


def cmd_plot(args):
    if args.what == "dump":
        _plot_dump(args.dump, args.out)
        print(f"wrote {args.out}")
        return 0
    if args.what == "response":
        _plot_response(args.dump, args.checkpoint, args.out, args.device)
        print(f"wrote {args.out}")
        return 0
    series = []
    if args.what == "entropy":
        series = _plot_entropy(args.data)
    elif args.metrics:
        from tetris_mcts_tpu_torch.obs.metrics import MetricsReader

        r = MetricsReader(args.metrics)
        r.poll()
        eps = r.of_kind("episode")
        if args.what == "lines":
            series = [[e["lines"] for e in eps]]
        elif args.what == "score":
            series = [[e["score"] for e in eps]]
        else:
            tr = [e for e in r.of_kind("train_session") if e.get("loss_train") is not None]
            series = [[e["loss_train"] for e in tr], [e["loss_val"] for e in tr]]
    elif args.loss:
        from tetris_mcts_tpu_torch.utils.data import LossLoader

        ld = LossLoader(args.loss)
        series = [ld.loss_train.tolist(), ld.loss_val.tolist()]
    with open(args.out, "w") as f:
        f.write(_svg_line(series))
    print(f"wrote {args.out}")
    return 0


def main(argv=None):
    from tetris_mcts_tpu_torch.cli import DEFAULT_CKPT

    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    dev = lambda s: s.add_argument("--device", default="cuda",
                                   help="where the net runs (cpu: the CPU)")

    s = sub.add_parser("sanity")
    s.add_argument("--checkpoint", default=DEFAULT_CKPT,
                   help="defaults to the chosen net's own checkpoint path")
    s.add_argument("--model", default="vv", choices=("vv", "vp", "dist"))
    dev(s)

    s = sub.add_parser("inference_speed")
    s.add_argument("--iters", type=int, default=10000)
    s.add_argument("--batch", type=int, default=5)
    dev(s)

    s = sub.add_parser("train_dump")
    s.add_argument("dump", help="npz with states/values/variance/weights")
    s.add_argument("--checkpoint", default=DEFAULT_CKPT)
    s.add_argument("--load_model", action="store_true",
                   help="start from the checkpoint instead of a fresh net")
    s.add_argument("--save_model", action="store_true",
                   help="overwrite the checkpoint with the retrained net (off by default)")
    s.add_argument("--batch_size", type=int, default=128)
    s.add_argument("--iters_per_val", type=int, default=100)
    s.add_argument("--max_iters", type=int, default=10000)
    dev(s)

    s = sub.add_parser("print_dump_grad")
    s.add_argument("dump", nargs="?", default="./data/dump_grad.npz")

    s = sub.add_parser("plot")
    s.add_argument("--metrics", default="")
    s.add_argument("--loss", default="", help="loss*.rec glob")
    s.add_argument("--data", default="data/data*.rec", help="self-play .rec glob (entropy)")
    s.add_argument("--dump", default="./data/dump.npz",
                   help="training-set dump (dump and response)")
    s.add_argument("--checkpoint", default=DEFAULT_CKPT, help="the net of response")
    s.add_argument("--what", default="lines",
                   choices=("lines", "score", "loss", "entropy", "dump", "response"))
    s.add_argument("--out", default="plot.svg")
    dev(s)

    args = p.parse_args(argv)
    device = getattr(args, "device", "cpu")
    net_runs = args.cmd != "plot" or args.what == "response"
    if net_runs and device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            p.error(f"--device {device}: no CUDA device is available "
                    "(pass --device cpu to run on the CPU)")
    return {"sanity": cmd_sanity, "inference_speed": cmd_inference_speed,
            "train_dump": cmd_train_dump, "print_dump_grad": cmd_print_dump_grad,
            "plot": cmd_plot}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main() or 0)
