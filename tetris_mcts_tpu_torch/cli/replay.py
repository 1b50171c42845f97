"""`replay`: step through saved self-play games in the terminal
(counterpart of the reference package's `cli/replay.py`): `render` draws a
board (also for `play --printboard` and `play --interactive`), `main`
shows an episode of the port's `.rec` rows (`utils/data.DataLoader`)
frame by frame, and `write_gif` renders one to an animated GIF.

Keys: Enter/n = next, p = prev, j <n> = jump, q = quit. `--dump` prints
every frame instead; `--model` re-runs a checkpoint (the port's, or the
JAX package's read by `train/flax_msgpack.py`) on every frame, on the
card unless `--device cpu`: value and variance for `--model_type vv`,
value and policy for `vp`; `--gif PATH` writes the episode as a GIF.

The GIF is written with numpy and the standard library (the card's
machine has no PIL): GIF89a, a 256-level greyscale palette, one LZW-coded
image a frame (variable-width codes from 9 bits, a clear code when the
4096-entry table is full), a graphic control block with each frame's
delay, and the NETSCAPE2.0 loop extension. As PIL's writer does, a frame
equal to the one before it is merged into it, its duration added.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

_CHARS = {0: "·", 1: "█", -1: "▒"}
ACTION_NAMES = ["noop", "left", "right", "soft", "ccw", "cw", "hard"]


def render(board, score, lines, combo, value=None, variance=None, policy=None,
           action=None):
    """board (20, 10) of 0 empty, 1 locked, -1 the falling piece -> text."""
    out = ["┌" + "─" * 20 + "┐"]
    for r in range(20):
        out.append("│" + "".join(_CHARS[int(v)] * 2 for v in board[r]) + "│")
    out.append("└" + "─" * 20 + "┘")
    out.append(f"score {score}   lines {lines}   combo {combo}")
    if action is not None:
        out.append(f"action: {ACTION_NAMES[int(action)]}")
    if policy is not None:
        out.append("policy: " + " ".join(f"{p:.2f}" for p in policy))
    if value is not None:
        out.append(f"stored value {value:.2f}  variance {variance:.2f}")
    return "\n".join(out)


def _lzw(pixels: bytes, min_size: int = 8) -> bytes:
    """GIF LZW codes of one image's palette indices, packed LSB first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width, table, nxt = min_size + 1, {}, eoi + 1
    emit(clear, width)
    prefix = pixels[0]
    for c in pixels[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if nxt == 4096:  # the table is full: start again
            emit(clear, width)
            width, table, nxt = min_size + 1, {}, eoi + 1
        else:
            table[key] = nxt
            if nxt == 1 << width and width < 12:
                width += 1
            nxt += 1
        prefix = c
    emit(prefix, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(boards, path, scale: int = 20, duration_ms: int = 80):
    """Render int8 (T, 20, 10) getState boards to an animated GIF: white
    empty cells, near-black locked ones, a mid-grey falling piece, each
    cell scale x scale pixels, `duration_ms` a frame, looping."""
    boards = np.asarray(boards)
    shade = np.where(boards == 1, 40, np.where(boards == -1, 128, 255)).astype(np.uint8)
    big = np.kron(shade, np.ones((scale, scale), np.uint8))
    frames, durations = [], []
    for f in big:  # a frame equal to the one before it lengthens that one
        if frames and np.array_equal(f, frames[-1]):
            durations[-1] += duration_ms
        else:
            frames.append(f)
            durations.append(duration_ms)
    h, w = big.shape[1:]
    grey = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), grey,
             b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f, ms in zip(frames, durations):
        parts += [b"\x21\xF9\x04\x00" + struct.pack("<HB", ms // 10, 0) + b"\x00",
                  b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08",
                  _sub_blocks(_lzw(f.tobytes()))]
    parts.append(b"\x3B")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tetris_mcts_tpu_torch replay")
    p.add_argument("data", help="the port's self-play .rec file (or glob)")
    p.add_argument("--episode", type=int, default=None,
                   help="episode id to view (default: the file's first)")
    p.add_argument("--model", default="", help="checkpoint to re-run on each frame")
    p.add_argument("--model_type", default="vv", choices=("vv", "vp"),
                   help="the checkpoint's net: vv prints value/variance, vp value/policy")
    p.add_argument("--dump", action="store_true", help="print all frames non-interactively")
    p.add_argument("--gif", default="", help="render the episode to this animated-GIF path")
    p.add_argument("--gif_scale", type=int, default=20, help="pixels per cell in --gif")
    p.add_argument("--gif_ms", type=int, default=80, help="frame duration in ms for --gif")
    p.add_argument("--device", default="cuda", help="where --model runs (cpu: the CPU)")
    args = p.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        p.error(f"--device {args.device}: no CUDA device is available "
                "(pass --device cpu to run on the CPU)")
    from tetris_mcts_tpu_torch.utils.data import DataLoader

    loader = DataLoader(args.data)
    ep = args.episode if args.episode is not None else int(loader.episode[0])
    sel = np.nonzero(loader.episode == ep)[0]
    if len(sel) == 0:
        print(f"episode {ep} not found; available: "
              f"{sorted(set(loader.episode.tolist()))[:20]}...", file=sys.stderr)
        return 1

    model = None
    if args.model:
        from tetris_mcts_tpu_torch.train.trainer import VPModel, VVModel

        cls = VPModel if args.model_type == "vp" else VVModel
        model = cls(device=args.device, checkpoint_path=args.model)
        model.load()

    def frame(i):
        j = sel[i]
        txt = render(loader.board[j], int(loader.score[j]), int(loader.lines[j]),
                     int(loader.combo[j]), float(loader.value[j]), float(loader.variance[j]),
                     loader.policy[j], loader.action[j])
        if model is not None:
            if args.model_type == "vp":
                v, pol = model.inference(loader.board[j][None])
                txt += (f"\nmodel value {float(v[0, 0]):.2f}  policy "
                        + " ".join(f"{q:.2f}" for q in np.asarray(pol)[0]))
            else:
                v, var = model.inference(loader.board[j][None])
                txt += f"\nmodel value {float(v[0, 0]):.2f}  variance {float(var[0, 0]):.2f}"
        return f"frame {i + 1}/{len(sel)} (episode {ep})\n" + txt

    if args.gif:
        write_gif(loader.board[sel], args.gif, scale=args.gif_scale, duration_ms=args.gif_ms)
        print(f"wrote {len(sel)} frames to {args.gif}")
        return 0

    if args.dump:
        for i in range(len(sel)):
            print(frame(i))
            print()
        return 0

    i = 0
    while True:
        print("\033[2J\033[H" + frame(i), flush=True)
        try:
            cmd = input("[n]ext/[p]rev/j <i>/[q]uit> ").strip()
        except EOFError:
            break
        if cmd in ("q", "quit"):
            break
        if cmd in ("p", "prev"):
            i = max(i - 1, 0)
        elif cmd.startswith("j"):
            try:
                i = min(max(int(cmd.split()[1]) - 1, 0), len(sel) - 1)
            except (IndexError, ValueError):
                pass
        else:
            i = min(i + 1, len(sel) - 1)
    return 0


if __name__ == "__main__":
    sys.exit(main() or 0)
