"""`python -m tetris_mcts_tpu_torch {play,train,cycle,dashboard,replay,tools} [args...]`."""

import sys

COMMANDS = ("play", "train", "cycle", "dashboard", "replay", "tools")


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(f"usage: python -m tetris_mcts_tpu_torch {{{','.join(COMMANDS)}}} [args...]")
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r} (the port has: {', '.join(COMMANDS)})",
              file=sys.stderr)
        return 2
    import importlib

    run = importlib.import_module(f"tetris_mcts_tpu_torch.cli.{cmd}").main
    rc = run(argv)  # cycle, replay and tools return exit codes; play and train objects
    return rc if isinstance(rc, int) else 0


if __name__ == "__main__":
    sys.exit(main())
