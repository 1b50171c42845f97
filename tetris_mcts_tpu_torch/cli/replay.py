"""Text rendering of a Tetris board (counterpart of the reference
package's `cli/replay.py` `render`), for `play --printboard` and
`play --interactive`. The replay command itself is not ported yet."""

from __future__ import annotations

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
