"""Edge inputs of the insert and backup walks, made with numpy from a seed.

Shared by tests/test_torch_walk_edges.py (the plain versions against the
JAX package on the CPU), tests/test_torch_cuda.py and chip_smoke.py (the
kernels against the plain versions on the card). Imports torch and the
port only, never JAX, so it runs on the card's machine.

- `lp_case`: synthetic trees and traces for the LP backup. Trace lengths
  cycle through `LP_LENGTHS` (1, chunk edges at 32 and 64, up to 96), the
  nodes' obs ids come from a small range so one trace holds the same obs
  twice within a chunk of 32 levels and across chunks, every other leaf
  with children has one child whose obs also lies on its trace, every
  fourth leaf has no children, every fifth lane is not expanded, and a
  fifth of the nodes (children too) have ended. A third of the statistics
  have no visits, so children are seeded and levels take first visits.
- `backup_case`: an `lp_case`'s trees and traces with (v0, var0) given per
  lane, for the backup from given values (the leaf and rollout paths); the
  last lane of a batch of several has an empty trace (length 0).
- `insert_case`: insert rounds into a 16-slot table with a 12-id obs pool,
  from a pool of 16 boards whose home slots crowd at 14, 15 and 0: distinct
  keys contend for one slot, lanes hold duplicates, probes wrap from slot
  15 to 0, and the id pool runs out within a round.
"""

import numpy as np
import torch

from tetris_mcts_tpu_torch.env import engine as E
from tetris_mcts_tpu_torch.search import tree as T

LP_LENGTHS = (1, 2, 7, 31, 32, 33, 40, 63, 64, 65, 95, 96)
LP_N, LP_M, LP_OBS = 256, 64, 24   # nodes, obs pool, obs ids the nodes use

INSERT_CFG = T.TreeConfig(max_nodes=64, max_obs=12, table_size=16, max_depth=8)
INSERT_ROUNDS = 8                    # inserts in a case's sequence
_HOME_SLOTS = {15: 4, 14: 3, 0: 3}   # boards of the pool by home slot
_POOL = 16


def lp_case(seed, B, D):
    """numpy arrays of one LP backup call: the tree fields it reads and
    updates (cbase, nstat, end, visits, values, vars_) and its arguments
    (traces, lengths, v_nn, var_nn, expanded)."""
    rng = np.random.RandomState(seed)
    N, M = LP_N, LP_M
    cbase = np.zeros((B, N), np.int32)
    nstat = np.zeros((B, 2, N), np.float32)
    nstat[:, 0] = rng.randint(0, 6, (B, N))
    nstat[:, 1] = rng.randint(0, LP_OBS, (B, N))
    end = rng.rand(B, N) < 0.2
    lengths = np.array([min(LP_LENGTHS[b % len(LP_LENGTHS)], D) for b in range(B)],
                       np.int32)
    traces = np.zeros((B, D), np.int32)
    for b in range(B):
        n = lengths[b]
        traces[b, :n] = rng.randint(1, N - 8, n)
        if b % 4 != 3:  # the leaf has children
            c = rng.randint(1, N - 7)
            cbase[b, traces[b, n - 1]] = c
            if b % 2 == 0:  # one child's obs also lies on the trace
                nstat[b, 1, c + rng.randint(7)] = nstat[b, 1, traces[b, rng.randint(n)]]
    return dict(
        cbase=cbase, nstat=nstat, end=end,
        visits=rng.randint(0, 3, (B, M)).astype(np.float32),
        values=rng.uniform(0, 10, (B, M)).astype(np.float32),
        vars_=rng.uniform(0, 5, (B, M)).astype(np.float32),
        traces=traces, lengths=lengths,
        v_nn=rng.uniform(0, 10, (B, 7)).astype(np.float32),
        var_nn=rng.uniform(0, 5, (B, 7)).astype(np.float32),
        expanded=np.arange(B) % 5 != 4)


def backup_case(seed, B, D):
    """numpy arrays of one backup call: an `lp_case` (its v_nn, var_nn and
    expanded unused) with v0 (B,) and var0 (B,), the last lane's trace
    emptied when B > 1."""
    case = lp_case(seed, B, D)
    if B > 1:
        case["lengths"][-1] = 0
    rng = np.random.RandomState(seed + 1000)
    case["v0"] = rng.uniform(0, 70, B).astype(np.float32)
    case["var0"] = rng.uniform(0, 5, B).astype(np.float32)
    return case


def lp_tree(case, device="cpu"):
    """The port's Tree holding an `lp_case`'s fields (the rest zero)."""
    B, N = case["cbase"].shape
    M = case["visits"].shape[1]
    t = lambda k: torch.tensor(case[k], device=device)  # a copy: the call updates it
    z = lambda *s, dt=torch.int32: torch.zeros(*s, dtype=dt, device=device)
    return T.Tree(cbase=t("cbase"), nstat=t("nstat"), end=t("end"),
                  n_nodes=z(B) + N, root_env=z(B, 44), visits=t("visits"),
                  values=t("values"), vars_=t("vars_"), obs_end=z(B, M, dt=torch.bool),
                  obs_bits=z(B, 20, M), n_obs=z(B) + M, tbl_h1=z(B, 16),
                  tbl_h2=z(B, 16), tbl_obs=z(B, 16), root=z(B))


def lp_args(case, device="cpu"):
    """(traces, lengths, v_nn, var_nn, expanded) of an `lp_case` as tensors."""
    return tuple(torch.as_tensor(case[k], device=device)
                 for k in ("traces", "lengths", "v_nn", "var_nn", "expanded"))


def backup_args(case, device="cpu"):
    """(traces, lengths, v0, var0) of a `backup_case` as tensors."""
    return tuple(torch.as_tensor(case[k], device=device)
                 for k in ("traces", "lengths", "v0", "var0"))


def repeats(case):
    """(a trace holds an obs twice within 32 levels, ... 32 or more levels
    apart, a leaf child's obs lies on its trace) over the case's lanes."""
    same_chunk = across = child_on_trace = False
    for b, n in enumerate(case["lengths"]):
        obs = case["nstat"][b, 1, case["traces"][b, :n]].astype(np.int64)
        for i in range(n):
            for j in range(i + 1, n):
                if obs[i] == obs[j]:
                    if (n - 1 - i) // 32 == (n - 1 - j) // 32:
                        same_chunk = True
                    if j - i >= 32:
                        across = True
        c = case["cbase"][b, case["traces"][b, n - 1]]
        if c:
            child_on_trace |= bool(np.isin(case["nstat"][b, 1, c:c + 7], obs).any())
    return same_chunk, across, child_on_trace


def _home(packed):
    h1, _ = T._hash_packed(torch.as_tensor(packed))
    return (h1 & (INSERT_CFG.table_size - 1)).numpy()


def insert_case(seed, B):
    """A sequence of INSERT_ROUNDS insert calls into fresh trees of
    INSERT_CFG: numpy (packed7 (R, B, 7, 20) int32, end7 (R, B, 7) bool,
    ok (R, B) bool). The first call puts two distinct keys with home slot 15
    in actions 0 and 1 of every lane."""
    rng = np.random.RandomState(seed)
    cand = rng.randint(0, 2**20, (4096, 20)).astype(np.int32)
    homes = _home(cand)
    crowd = np.concatenate([np.flatnonzero(homes == h)[:k] for h, k in _HOME_SLOTS.items()])
    rest = np.setdiff1d(np.arange(len(cand)), crowd)[:_POOL - len(crowd)]
    pool = cand[np.concatenate([crowd, rest])]  # pool[0] and pool[1]: home slot 15
    pick = rng.randint(0, _POOL, (INSERT_ROUNDS, B, 7))
    pick[0, :, 0], pick[0, :, 1] = 0, 1
    return (pool[pick], rng.rand(INSERT_ROUNDS, B, 7) < 0.3,
            rng.rand(INSERT_ROUNDS, B) < 0.85)


def insert_trees(seed, B, device="cpu"):
    """Fresh trees of INSERT_CFG (the root's obs inserted, n_obs = 2)."""
    env = E.pack_state(E.reset_batch(seed, B, device="cpu"))
    trees = T.init_tree(env, INSERT_CFG)
    return T.Tree(**{f: getattr(trees, f).to(device) for f in trees.__dataclass_fields__})


def wrapped(trees):
    """Whether some occupied slot holds a key whose home slot lies above it
    (its probe wrapped from the table's last slot to slot 0)."""
    home = trees.tbl_h1 & (INSERT_CFG.table_size - 1)
    slot = torch.arange(INSERT_CFG.table_size, device=home.device)
    return bool(((trees.tbl_obs != 0) & (home > slot)).any())


def ran_out(n_before, n_after, obs7, ok):
    """Whether the id pool ran out during an insert call: a lane that had
    ids left fills the pool, and an action of it gets obs 0."""
    M = INSERT_CFG.max_obs
    filled = (n_before < M) & (n_after == M) & ok
    return bool((filled & (obs7 == 0).any(1)).any())
