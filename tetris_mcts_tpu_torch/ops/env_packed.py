"""The Tetris engine step on packed (B, 44) states, in plain torch.

Counterpart of the reference package's `ops/env_packed.py`. A packed state
is the 44-word `engine.pack_state` layout (rows[0:20], piece, rot, px, py,
bag[24:31], bag_pos, k0, k1, ctr, gravity, score, combo, lines,
line_stats[39:43], end[43]) stored as an int32 tensor of u32 bit patterns.

Every helper here has a `__device__` twin in `csrc/env_packed.cuh`, which the
select kernel (`ops/tree_walk.py`) uses to step each lane's env inline while
it descends. The torch forms are the semantics the device forms are held
against; `engine.step` is itself `packed_step` on packed states, and both are
held bit-exact against the JAX engine in the tests.

The JAX module spells table lookups as masked sums and u32 division as float
reciprocals because Mosaic has no gathers or integer division; torch and
CUDA have both, so the helpers here gather from the piece table, take `%`
directly, and index the permutation table.
"""

from __future__ import annotations

import torch

from tetris_mcts_tpu_torch.env.pieces import (
    BOARD_H,
    BOARD_W,
    CLEAR_SCORE,
    COMBO_SCORE,
    FULL_ROW,
    PIECE_CELLS,
    SPAWN_X,
    SPAWN_Y,
)
from tetris_mcts_tpu_torch.env.rng import MASK32, PERM7, i32, threefry2x32

STATE_WORDS = 44
_TABLES = {}


def _table(name, device):
    """Constant tables on `device` (built once per device)."""
    key = (name, str(device))
    if key not in _TABLES:
        src = {
            "cells": PIECE_CELLS.reshape(28, 4, 2),
            "perm7": PERM7,
            "clear": CLEAR_SCORE,
        }[name]
        _TABLES[key] = torch.as_tensor(src, dtype=torch.int64, device=device)
    return _TABLES[key]


def _cells(combo):
    """combo (B,) = piece * 4 + rot -> (dy, dx), each (B, 4) int64."""
    c = _table("cells", combo.device)[combo]
    return c[..., 0], c[..., 1]


def _cells_spawn(piece):
    """piece (B,) -> spawn-orientation (rot 0) cells, each (B, 4)."""
    return _cells(piece * 4)


def _prow(ys, xs):
    """Absolute cells (B, 4) -> piece bit-rows (B, 20) int64; off-board
    cells drop (`engine.piece_rows`)."""
    ok = (xs >= 0) & (xs < BOARD_W) & (ys >= 0) & (ys < BOARD_H)
    bits = torch.where(ok, 1 << xs.clamp(0, BOARD_W - 1), 0)       # (B, 4)
    r = torch.arange(BOARD_H, device=ys.device)
    hit = ys[:, :, None] == r                                       # (B, 4, 20)
    return (torch.where(hit, bits[:, :, None], 0)).sum(1)           # cells unique


def _collides(rows, ys, xs):
    """(B,) bool: any cell off the board or over the stack."""
    oob = ((xs < 0) | (xs >= BOARD_W) | (ys < 0) | (ys >= BOARD_H)).any(1)
    return oob | ((rows & _prow(ys, xs)) != 0).any(1)


def _max_drop(rows, ys, xs):
    """(B,) largest d >= 0 with the piece free at py + d (`engine.max_drop`)."""
    r = torch.arange(BOARD_H, device=ys.device)
    xc = xs.clamp(0, BOARD_W - 1)
    colbits = (rows[:, None, :] >> xc[:, :, None]) & 1               # (B, 4, 20)
    below = (colbits == 1) & (r > ys[:, :, None])
    first = torch.where(below, r, BOARD_H).amin(2)                  # (B, 4)
    lim = torch.where(first < BOARD_H, first - ys - 1, BOARD_H - 1 - ys)
    return lim.amin(1).clamp_min(0)


def _threefry(k0, k1, c0):
    """threefry2x32 lane 0 on int64 u32 words (the `rng.next_u32` draw)."""
    return threefry2x32(k0, k1, c0, torch.zeros_like(c0))[0]


def _mod_const(word, m):
    """u32 word mod m (the JAX form avoids integer division for Mosaic)."""
    return word % m


def _perm7_decode(r):
    """Lexicographic permutation #r of 0..6, r (B,) in [0, 5040) -> (B, 7)."""
    return _table("perm7", r.device)[r]


def predraw(k0, k1, ctr, randomizer):
    """The piece-draw product of state (k0, k1, ctr): the uniform piece id
    (B,), or the decoded refill bag (B, 7)."""
    word = _threefry(k0, k1, ctr)
    if randomizer == 1:
        return _mod_const(word, 7)
    return _perm7_decode(_mod_const(word, 5040))


def _draw_piece(bag, bag_pos, k0, k1, ctr, randomizer):
    """`engine._draw_piece` on columns: returns (piece, bag, bag_pos, ctr).
    ctr advances only when a draw is taken."""
    predrawn = predraw(k0, k1, ctr, randomizer)
    if randomizer == 1:
        return predrawn, bag, bag_pos, (ctr + 1) & MASK32
    need = bag_pos >= 7
    bag = torch.where(need[:, None], predrawn, bag)
    pos = torch.where(need, 0, bag_pos)
    ctr = torch.where(need, (ctr + 1) & MASK32, ctr)
    piece = bag.gather(1, pos[:, None])[:, 0]
    return piece, bag, pos + 1, ctr


def unpack_columns(env):
    """(B, 44) int32 -> dict of int64 columns (u32 fields masked to
    [0, 2^32), int fields signed)."""
    e = env.to(torch.int64)
    u = e & MASK32
    return dict(
        rows=u[:, 0:20], piece=e[:, 20], rot=e[:, 21], px=e[:, 22],
        py=e[:, 23], bag=e[:, 24:31], bag_pos=e[:, 31], k0=u[:, 32],
        k1=u[:, 33], ctr=u[:, 34], gravity=e[:, 35], score=e[:, 36],
        combo=e[:, 37], lines=e[:, 38], line_stats=e[:, 39:43],
        end=e[:, 43],
    )


def pack_columns(c):
    """Inverse of `unpack_columns`: int64 columns -> (B, 44) int32."""
    col = lambda x: x[:, None]
    parts = [
        c["rows"], col(c["piece"]), col(c["rot"]), col(c["px"]),
        col(c["py"]), c["bag"], col(c["bag_pos"]), col(c["k0"]),
        col(c["k1"]), col(c["ctr"]), col(c["gravity"]), col(c["score"]),
        col(c["combo"]), col(c["lines"]), c["line_stats"], col(c["end"]),
    ]
    return i32(torch.cat([p.to(torch.int64) for p in parts], 1))


def packed_obs(env):
    """`engine.pack_obs` on packed states: bits 0-9 locked row, bits 10-19
    piece row. (B, 44) int32 -> (B, 20) int32."""
    c = unpack_columns(env)
    dy, dx = _cells(c["piece"] * 4 + c["rot"])
    prow = _prow(c["py"][:, None] + dy, c["px"][:, None] + dx)
    return (c["rows"] | (prow << 10)).to(torch.int32)


def spawn_columns(c, randomizer):
    """`engine._spawn` on columns: draw the next piece, place it at the
    spawn point, end the game if it collides. Returns new columns."""
    piece, bag, bag_pos, ctr = _draw_piece(
        c["bag"], c["bag_pos"], c["k0"], c["k1"], c["ctr"], randomizer,
    )
    dy, dx = _cells_spawn(piece)
    dead = _collides(c["rows"], SPAWN_Y + dy, SPAWN_X + dx)
    zero = torch.zeros_like(piece)
    return dict(
        c, piece=piece, rot=zero, px=zero + SPAWN_X, py=zero + SPAWN_Y,
        bag=bag, bag_pos=bag_pos, ctr=ctr, gravity=zero,
        end=c["end"] | dead.to(torch.int64),
    )


def packed_step(env, act, *, actions_per_drop=1, scoring=0, randomizer=0):
    """`engine.step` on packed states. env (B, 44) int32, act (B,) integer.
    Returns the stepped (B, 44) int32; ended games are unchanged."""
    c = unpack_columns(env)
    a = act.reshape(-1).to(torch.int64)
    rows = c["rows"]

    # ---- lateral effect (engine._step_alive) ------------------------------
    dx = torch.where(a == 1, -1, torch.where(a == 2, 1, 0))
    drot = torch.where(a == 4, 1, torch.where(a == 5, 3, 0))
    npx = c["px"] + dx
    nrot = (c["rot"] + drot) & 3
    cy, cx = _cells(c["piece"] * 4 + nrot)
    blocked = _collides(rows, c["py"][:, None] + cy, npx[:, None] + cx)
    px = torch.where(blocked, c["px"], npx)
    rot = torch.where(blocked, c["rot"], nrot)
    dy, dx4 = _cells(c["piece"] * 4 + rot)

    # ---- vertical effect --------------------------------------------------
    hard = a == 6
    soft = a == 3
    lateral = ~hard & ~soft
    g_next = c["gravity"] + 1
    if actions_per_drop <= 0:  # auto-gravity off
        grav_fires = torch.zeros_like(lateral)
        g_keep = torch.zeros_like(g_next)
    else:
        grav_fires = lateral & (g_next >= actions_per_drop)
        g_keep = g_next
    ys = c["py"][:, None] + dy
    xs = px[:, None] + dx4
    md = _max_drop(rows, ys, xs)
    want_down = soft | grav_fires
    drop_n = torch.where(hard, md, torch.where(want_down, md.clamp_max(1), 0))
    lock_now = hard | (want_down & (md == 0))
    py = c["py"] + drop_n
    score = c["score"]
    if scoring == 0:  # guideline drop points
        score = score + torch.where(
            hard, 2 * md, torch.where(soft, md.clamp_max(1), 0))
    gravity = torch.where(hard | soft | grav_fires, 0, g_keep)
    moved = dict(c, px=px, rot=rot, py=py, score=score, gravity=gravity)

    # ---- lock + clear + spawn (engine._lock) -------------------------------
    merged = rows | _prow(ys + drop_n[:, None], xs)
    full = merged == FULL_ROW
    notfull = (~full).to(torch.int64)
    # below[r] = number of non-full rows strictly below row r
    below = notfull.flip(1).cumsum(1).flip(1) - notfull
    dst = BOARD_H - 1 - below
    keep = torch.where(full, 0, merged)
    cleared_rows = torch.zeros_like(merged).scatter_add_(1, dst, keep)
    n = full.sum(1)
    cleared = n > 0
    if scoring == 0:
        gained = torch.where(
            cleared, _table("clear", n.device)[n] + COMBO_SCORE * c["combo"], 0)
    else:
        gained = n
    stats = c["line_stats"] + (
        (torch.arange(4, device=n.device) == (n - 1)[:, None])
        & cleared[:, None]).to(torch.int64)
    locked = spawn_columns(dict(
        moved, rows=cleared_rows, score=score + gained,
        combo=torch.where(cleared, c["combo"] + 1, 0),
        lines=c["lines"] + n, line_stats=stats,
    ), randomizer)

    out = pack_columns({
        k: torch.where(
            lock_now.view(-1, *([1] * (v.dim() - 1))), locked[k], v)
        for k, v in moved.items()
    })
    return torch.where((c["end"] != 0)[:, None], env, out)
