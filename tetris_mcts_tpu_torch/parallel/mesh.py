"""Ranks as a data x model grid, and the sharded self-play move and VV
learner over it (counterpart of the reference package's
`parallel/mesh.py`).

One process a device, joined by `torch.distributed` (NCCL on a card, gloo
on the CPU or for several ranks on one card). `make_mesh` lays the ranks out
as the reference lays its devices out, `ranks.reshape(n // mp, mp)`: the
data axis runs down the grid's columns, the model axis along its rows.
Each rank joins one group a column (`Mesh.data_group`, the ranks it shares
its model index with) and one a row (`Mesh.model_group`).

- **Self-play** (`sharded_move_fn`): each rank runs the port's move program
  (its kernels on its own device through `ops/build.launch`) on its own
  rows of the global game batch. Its randomness is its rows of the global
  draw (`ShardedPlanes`), so W ranks of B/W lanes compute what one process
  computes at B. A playout loop (the rollout, the policy playouts) asks
  `Mesh.all_ended` whether to stop, which counts the live lanes over the
  data axis, so every rank steps, and draws, as long as any lane plays on:
  the reference's `jnp.any` over the global batch. The replay ring is
  replicated: the harvested rows of every rank enter it in global lane
  order, rank by rank, where the reference's cumsum over the global mask
  puts them.
- **Learning** (`make_sharded_learner`, `sharded_train_step`): every rank
  takes the same global minibatch indices; a data rank computes the loss
  on its rows of them, scaled by its rows over the minibatch, and the
  gradients are summed over the data group before the grad norm and Yogi.
  On a model axis fc1 is split by output features and fc_out by input
  features (`vv_param_specs`), the Megatron pair: an identity forward /
  all-reduce backward at fc1's input, an all-reduce forward / identity
  backward after fc_out.

Collectives: gloo reduces and broadcasts CUDA tensors but does not gather
them, so a gather is an all-reduce of zero-filled slots, one slot a rank,
summed as integers (a float's bits plus zeros are its bits). The same code
runs under NCCL and gloo. Without a process group a mesh is one rank and
every collective is skipped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tetris_mcts_tpu_torch.models.nets import tf32_off
from tetris_mcts_tpu_torch.train.optim import Yogi
from tetris_mcts_tpu_torch.train.trainer import ewc_terms

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the one parameter stored whole but used split (fc1's bias, beside its
# column-split kernel): its gradient is summed over the model group
_MODEL_SUMMED = ("fc1.bias",)


def mesh_grid(world: int, model_parallel: int = 1) -> np.ndarray:
    """The ranks as the reference lays devices out: (world,) for a data
    mesh, (world // mp, mp) with a model axis."""
    if model_parallel > 1:
        if world % model_parallel:
            raise ValueError(f"{world} ranks do not split into model groups of "
                             f"{model_parallel}")
        return np.arange(world).reshape(world // model_parallel, model_parallel)
    return np.arange(world)


class Mesh:
    """This rank's place in the grid and its two groups. `devices` is the
    grid of ranks; `data_size` / `model_size` the axes' lengths and
    `data_index` / `model_index` this rank's coordinates."""

    def __init__(self, world: int, rank: int, model_parallel: int = 1):
        self.devices = mesh_grid(world, model_parallel)
        self.axis_names = (DATA_AXIS,) if model_parallel <= 1 else (DATA_AXIS, MODEL_AXIS)
        grid = self.devices.reshape(world // max(model_parallel, 1), -1)
        self.world, self.rank = world, rank
        self.data_size, self.model_size = grid.shape
        self.data_index, self.model_index = (int(i) for i in np.argwhere(grid == rank)[0])
        self.model_root = int(grid[self.data_index, 0])  # the first rank of this row
        self.data_group = self.model_group = None
        self._groups = []
        if dist.is_available() and dist.is_initialized():
            # every rank makes every group, in the same order
            for col in grid.T:
                g = dist.new_group(col.tolist())
                self._groups.append(g)
                if rank in col:
                    self.data_group = g
            for row in grid:
                g = dist.new_group(row.tolist())
                self._groups.append(g)
                if rank in row:
                    self.model_group = g

    def close(self):
        """Destroy the groups this mesh made."""
        for g in self._groups:
            dist.destroy_process_group(g)
        self._groups = []
        self.data_group = self.model_group = None

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's `x` (rows first) in data order: (data_size *
        rows, ...). One all-reduce over the data group."""
        if self.data_group is None:
            return x
        return _all_gather(x, self.data_size, self.data_index, self.data_group)

    def all_ended(self, env: torch.Tensor) -> bool:
        """Whether every lane of every data rank has ended, `env` this rank's
        packed states (B, 44), column 43 the end flag: its live lanes
        counted, summed over the data group (one int32 all-reduce) and read
        once. A playout loop that stops on it runs as many steps, and draws
        as often, on every rank as one process at the global batch."""
        live = (env[:, 43] == 0).sum(dtype=torch.int32).reshape(1)
        if self.data_group is not None:
            dist.all_reduce(live, group=self.data_group)
        return int(live) == 0

    def gather_rows(self, cols, mask, cand):
        """A ring append's columns (n-row tensors of 4-byte elements), its
        mask and its candidate mask (or None), gathered over the data axis
        in lane order, as one all-reduce."""
        n = mask.shape[0]
        parts = [c.reshape(n, -1) for c in cols] + [mask[:, None]]
        if cand is not None:
            parts.append(cand[:, None])
        widths = [p.shape[1] for p in parts]
        packed = torch.cat([_int32_bits(p) for p in parts], 1)
        g = self.gather_lanes(packed)
        out = list(torch.split(g, widths, 1))
        cols = [o.view(c.dtype).reshape((-1,) + tuple(c.shape[1:]))
                for o, c in zip(out, cols)]
        mask = out[len(cols)][:, 0] != 0
        cand = None if cand is None else out[len(cols) + 1][:, 0] != 0
        return cols, mask, cand


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The data (x model) mesh over every rank of the default process group;
    one rank when there is no group. `n_devices`, when given, must be the
    world size: a mesh spans every rank."""
    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if n_devices not in (None, world):
        raise ValueError(f"a mesh spans every rank: {n_devices} devices asked, "
                         f"{world} ranks in the process group")
    return Mesh(world, rank, model_parallel)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_INT_OF = {torch.float32: torch.int32, torch.int32: torch.int32, torch.int64: torch.int64,
           torch.uint8: torch.uint8}


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """x (4-byte elements or bool) as int32: floats by their bits, bools as
    0 / 1."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.element_size() != 4:
        raise TypeError(f"a ring column of {x.dtype}: want 4-byte elements")
    return x.contiguous().view(torch.int32)


def _all_gather(x: torch.Tensor, n: int, index: int, group) -> torch.Tensor:
    """Gather x from the n members of `group` in member order: an all-reduce
    of n zero-filled slots, each member filling its own, summed as integers
    so every value arrives bit for bit."""
    dt = x.dtype
    v = x.to(torch.uint8) if dt == torch.bool else x.contiguous()
    v = v.view(_INT_OF[v.dtype])
    buf = torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    buf[index] = v
    dist.all_reduce(buf, group=group)
    out = buf.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out != 0 if dt == torch.bool else out.view(dt)


def _tensors(tree):
    """The tensors of a tree of dataclasses, NamedTuples, tuples, lists and
    dicts, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return tree


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a tree whose every tensor holds the global batch
    first (trees, envs), the same on every rank: data rank d keeps rows
    [d * n / D, (d + 1) * n / D). Scalars stay whole."""

    def rows(x):
        if x.dim() == 0:
            return x
        n = x.shape[0]
        if n % mesh.data_size:
            raise ValueError(f"a batch of {n} does not split over {mesh.data_size} data ranks")
        k = n // mesh.data_size
        return x[mesh.data_index * k:(mesh.data_index + 1) * k].contiguous()

    return _tree_map(rows, tree)


def shard_batch_from_local(mesh: Mesh, tree, global_batch: int):
    """A tree of this rank's own rows (its own-seeded games), checked to be
    its share of `global_batch`: data size x local rows == global batch."""
    for x in _tensors(tree):
        if x.dim() and x.shape[0] * mesh.data_size != global_batch:
            raise ValueError(f"{mesh.data_size} data ranks x {x.shape[0]} local rows != "
                             f"the global batch {global_batch}")
    return tree


def replicate(mesh: Mesh, tree):
    """Broadcast every tensor of `tree` from rank 0, in place; returns tree."""
    if mesh.world > 1:
        for t in _tensors(tree):
            dist.broadcast(t, src=0)
    return tree


def model_tensors(model):
    """Every tensor a model's session updates: the net's params, the
    optimizer's moments and, for the VV model, its output bounds."""
    ts = [p.data for p in model.net.parameters()]
    for name in ("mu", "nu", "nu_max"):
        ts += list(getattr(model.opt, name, []))
    for name in ("ubound", "lbound", "_ubound_floor"):
        t = getattr(model, name, None)
        if isinstance(t, torch.Tensor):
            ts.append(t)
    return ts


def replicate_model(mesh: Mesh, model):
    """Make every rank's model rank 0's, bit for bit (after a session that
    each rank ran on the same rows: cuDNN's backward may differ between
    them)."""
    replicate(mesh, model_tensors(model))


# ---------------------------------------------------------------------------
# the sharded move
# ---------------------------------------------------------------------------

class ShardedPlanes:
    """This rank's rows of the randomness source `planes` (the methods of
    `search/mcts.TorchPlanes`): every draw is made at the global batch, this
    rank's lanes x the data axis's length, and sliced to this rank's rows,
    so the ranks together see what one process at the global batch sees.
    A playout draws at every step its loop runs, its own lanes ended or
    not; the loop stops on `Mesh.all_ended`, so the ranks draw alike."""

    def __init__(self, planes, mesh: Mesh):
        self.planes = planes
        self._n, self._i = mesh.data_size, mesh.data_index

    def _mine(self, x, B):
        return x[self._i * B:(self._i + 1) * B]

    def __call__(self, B, D):
        return tuple(self._mine(x, B) for x in self.planes(B * self._n, D))

    def actions(self, B, step):
        return self._mine(self.planes.actions(B * self._n, step), B)

    def gumbels(self, B, step):
        return self._mine(self.planes.gumbels(B * self._n, step), B)

    def level_gumbels(self, B, D):
        return self._mine(self.planes.level_gumbels(B * self._n, D), B)

    def uniforms(self, B, D):
        return self._mine(self.planes.uniforms(B * self._n, D), B)

    def drop(self, shape):
        return self._mine(self.planes.drop((shape[0] * self._n,) + tuple(shape[1:])),
                          shape[0])

    def __getattr__(self, name):  # gen, device, policy
        return getattr(self.planes, name)


class ShardedRing:
    """A replicated ring as a sharded move sees it: `search/mcts.append_rows`
    calls `gather` (`Mesh.gather_rows`) before it appends, so every rank
    appends every rank's rows in global lane order. Everything else is the
    ring's own."""

    def __init__(self, ring, mesh: Mesh):
        self.ring = ring
        self.gather = mesh.gather_rows

    def __getattr__(self, name):
        return getattr(self.ring, name)


def sharded_move_fn(move, mesh: Mesh):
    """`move(trees, envs, replay=None)` of the port (`search/mcts.py`,
    `vp.py`, `distributional.py`, `stochastic.py`) on this rank's rows
    (`shard_batch`), its draws from `ShardedPlanes`, and the replicated
    ring's appends gathered over the data axis."""

    def smove(trees, envs, replay=None):
        return move(trees, envs, None if replay is None else ShardedRing(replay, mesh))

    return smove


# ---------------------------------------------------------------------------
# the VV learner
# ---------------------------------------------------------------------------

def vv_param_specs(mesh: Mesh, params) -> dict:
    """name -> partition spec of each `VVNet` param, a tuple of axis names
    (or None) a dim, () for a replicated tensor: on a model axis fc1's
    weight (out, in) is split by output features ("model", None) and
    fc_out's weight by input features (None, "model"). torch's Linear
    weight is (out, in), the transpose of the reference's (in, out) Dense
    kernel, so these are the reference's P(None, "model") and
    P("model", None). Everything else is replicated."""
    specs = {n: () for n in params}  # a dict of the net's params by name
    if MODEL_AXIS in mesh.axis_names:
        specs["fc1.weight"] = (MODEL_AXIS, None)
        specs["fc_out.weight"] = (None, MODEL_AXIS)
    return specs


def _shard(mesh: Mesh, spec, x: torch.Tensor) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == MODEL_AXIS:
            k = x.shape[dim] // mesh.model_size
            return x.narrow(dim, mesh.model_index * k, k)
    return x


def _unshard(mesh: Mesh, spec, x: torch.Tensor) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == MODEL_AXIS and mesh.model_group is not None:
            g = _all_gather(x.movedim(dim, 0), mesh.model_size, mesh.model_index,
                            mesh.model_group)
            return g.movedim(0, dim).contiguous()
    return x


class LearnerState(NamedTuple):
    """The learner's state on this rank for a whole session: its shards of
    the params, the Yogi moments (over those shards), the Fisher and p0."""

    params: dict
    opt: Yogi
    fisher: dict
    p0: dict


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_vv_forward(mesh: Mesh, net, p: dict, x, ubound, lbound):
    """`net`'s forward (a `VVNet`) in float32 on this rank's shards `p`
    (name -> tensor), through `torch.func.functional_call`: the net's own
    forward, with fc1 and fc_out split on a model axis (the Megatron pair,
    one all-reduce of fc_out's partial outputs) in place of its head."""
    head = None
    if mesh.model_size > 1:
        def head(x):
            x = _CopyToModel.apply(x, mesh.model_group)
            k = p["fc1.weight"].shape[0]
            h = F.relu(F.linear(x, p["fc1.weight"],
                                p["fc1.bias"].narrow(0, mesh.model_index * k, k)))
            out = _ReduceFromModel.apply(F.linear(h, p["fc_out.weight"]), mesh.model_group)
            return out + p["fc_out.bias"]
    return torch.func.functional_call(net, p, (x, ubound, lbound), {"head": head})


def _learner_state(mesh, model, params, opt_state, fisher, p0):
    specs = vv_param_specs(mesh, params)
    own = lambda d: {n: _shard(mesh, specs[n], d[n].detach()).clone() for n in specs}
    mine = own(params)
    for t in mine.values():
        t.requires_grad_(True)
    opt = Yogi(list(mine.values()), lr=model.opt.lr, weight_decay=model.opt.weight_decay)
    mu, nu, count = opt_state
    opt.load([_shard(mesh, specs[n], m).clone() for n, m in zip(specs, mu)],
             [_shard(mesh, specs[n], v).clone() for n, v in zip(specs, nu)], count)
    return LearnerState(mine, opt, own(fisher), own(p0))


def gather_params(mesh: Mesh, state: LearnerState) -> dict:
    """The whole params (a `VVNet` state dict) from the ranks' shards."""
    specs = vv_param_specs(mesh, state.params)
    return {n: _unshard(mesh, specs[n], t.detach()).clone() for n, t in state.params.items()}


def gather_opt_state(mesh: Mesh, state: LearnerState):
    """The whole Yogi state (mu, nu, count) from the ranks' shards."""
    specs = vv_param_specs(mesh, state.params)
    whole = lambda xs: [_unshard(mesh, specs[n], x).clone() for n, x in zip(specs, xs)]
    mu, nu, count = state.opt.state()
    return whole(mu), whole(nu), count


def _flat_collective(tensors, op, **kw):
    """`op` (an all-reduce or a broadcast) on `tensors` as one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    op(flat, **kw)
    return [f.view_as(t) for f, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                         tensors)]


def _param_sum(mesh: Mesh, specs: dict, terms: dict):
    """The sum over every param of the whole net of a per-param scalar
    (name -> device scalar of this rank's shard): the split params' terms
    summed over the model group, the replicated ones' taken once."""
    whole = torch.stack([t for n, t in terms.items() if not specs[n]]).sum()
    split = [t for n, t in terms.items() if specs[n]]
    if not split:
        return whole
    split = torch.stack(split).sum()
    if mesh.model_group is not None:
        dist.all_reduce(split, group=mesh.model_group)
    return whole + split


def _train_step(model, mesh: Mesh, state: LearnerState, ubound, data, idx, lam: float = 0.0):
    """One step of `VVModel.train_step` on the global minibatch `idx`, over
    the mesh; returns (state, metrics, batch)."""
    bs = idx.shape[0]
    if bs % mesh.data_size:
        raise ValueError(f"a minibatch of {bs} does not split over {mesh.data_size} data ranks")
    k = bs // mesh.data_size
    batch = tuple(d[idx] for d in data)
    states, value, variance, weight = (d[mesh.data_index * k:(mesh.data_index + 1) * k]
                                       for d in batch)
    names = list(state.params)
    leaves = list(state.params.values())
    specs = vv_param_specs(mesh, state.params)
    with tf32_off():
        out = sharded_vv_forward(mesh, model.net, state.params, states, ubound, model.lbound)
        per = model._weighted_loss(out, value, variance, weight)
        # VVModel's objective, this rank's rows' share of the mean: the EWC
        # penalty's term of a param enters on one rank of those whose
        # gradients are summed for it (data rank 0; fc1's bias, summed over
        # the model group too, on model rank 0)
        objective = per.sum() / bs
        terms = ewc_terms(state.fisher, state.p0, state.params.items()) if lam else {}
        if terms and mesh.data_index == 0:
            objective = objective + 0.5 * lam * sum(
                t for n, t in terms.items() if mesh.model_index == 0 or n not in _MODEL_SUMMED)
        grads = list(torch.autograd.grad(objective, leaves))
    with torch.no_grad():
        if mesh.model_size > 1:
            for i, n in enumerate(names):
                if n in _MODEL_SUMMED:
                    dist.all_reduce(grads[i], group=mesh.model_group)
        if mesh.data_group is not None:
            grads = _flat_collective(grads, dist.all_reduce, group=mesh.data_group)
        if mesh.model_size > 1:
            # a replicated param's gradient comes from each model rank's own
            # backward, which cuDNN need not make bit-equal: the row's first
            # rank's is taken, so the replicas stay equal
            whole = [i for i, n in enumerate(names) if not specs[n]]
            got = _flat_collective([grads[i] for i in whole], dist.broadcast,
                                   src=mesh.model_root, group=mesh.model_group)
            for i, g in zip(whole, got):
                grads[i] = g
        # sums of squares, not VVModel's `_foreach_norm`s: on the CPU those
        # part from the reference's norm by 1.2e-5 at batch 32 (fc1's 458752)
        gnorm = torch.sqrt(_param_sum(mesh, specs, {n: (g * g).sum()
                                                    for n, g in zip(names, grads)}))
        per_all = mesh.gather_lanes(per.detach())
        loss = per_all.mean()
        if terms:
            loss = loss + 0.5 * lam * _param_sum(mesh, specs,
                                                 {n: t.detach() for n, t in terms.items()})
        state.opt.step(grads)
    metrics = {"loss": loss, "loss_std": per_all.std(correction=0), "grad_norm": gnorm}
    return state, metrics, batch


def make_sharded_learner(model, mesh: Mesh):
    """The learner of the actor-learner loop: `(state, step)`, `state` a
    `LearnerState` holding this rank's shards of `model`'s params, Yogi
    state, Fisher and p0 (`vv_param_specs`) for the whole session, and

        step(state, ubound, data, idx, lam=0.0) -> (state, metrics, batch)

    one data- (and, on a model axis, tensor-) parallel `VVModel.train_step`
    on the rows `idx` (the global minibatch, the same on every rank) of
    `data` = (states (n, 1, 20, 10), value, variance, weight), the whole
    columns on every rank (the ring is replicated)."""
    params = dict(model.net.named_parameters())
    mu, nu, count = model.opt.state()
    state = _learner_state(mesh, model, params, (mu, nu, count), model.fisher, model.p0)

    def step(state, ubound, data, idx, lam=0.0):
        return _train_step(model, mesh, state, ubound, data, idx, lam)

    return state, step


def sharded_train_step(model, mesh: Mesh):
    """`VVModel.train_step`'s whole-state form over the mesh:

        step(params, opt_state, ubound, data, idx, fisher, p0, lam=0.0)
            -> (params, opt_state, metrics, batch)

    params, fisher and p0 whole state dicts, opt_state (mu, nu, count) as
    `Yogi.state()` gives it; the results are whole too. Each call shards
    its inputs and gathers its outputs: a session keeps its state on the
    ranks with `make_sharded_learner`."""

    def step(params, opt_state, ubound, data, idx, fisher, p0, lam=0.0):
        state = _learner_state(mesh, model, params, opt_state, fisher, p0)
        state, metrics, batch = _train_step(model, mesh, state, ubound, data, idx, lam)
        return gather_params(mesh, state), gather_opt_state(mesh, state), metrics, batch

    return step
