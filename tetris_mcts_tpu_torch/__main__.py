"""`python -m tetris_mcts_tpu_torch {play,train,cycle} [args...]`."""

import sys

COMMANDS = ("play", "train", "cycle")


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(f"usage: python -m tetris_mcts_tpu_torch {{{','.join(COMMANDS)}}} [args...]")
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r} (the port has: {', '.join(COMMANDS)})",
              file=sys.stderr)
        return 2
    if cmd == "play":
        from tetris_mcts_tpu_torch.cli.play import main as run
    elif cmd == "train":
        from tetris_mcts_tpu_torch.cli.train import main as run
    else:
        from tetris_mcts_tpu_torch.cli.cycle import main as run
    rc = run(argv)  # cycle returns its exit code; play and train return objects
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
