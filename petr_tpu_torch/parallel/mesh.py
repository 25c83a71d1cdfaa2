"""The (data, model) grid of ranks, and the mesh in context.

Counterpart of `petr_tpu/parallel/mesh.py`. petr_tpu lays its devices out
on a (data, model) mesh and lets GSPMD partition one jitted program over
the global batch: ``data`` splits the batch, ``model`` splits the decoder's
N*H*W key tokens while the queries stay replicated. PyTorch has no GSPMD,
so here one process (a rank) plays one device and the program says its
collectives itself: a ``Mesh`` holds the grid of ranks and one process
group per row (the ranks that share a batch shard and split its tokens:
the model group) and per column (the ranks that hold one token range of
different batch shards: the data group). Ranks are numbered row by row,
rank = data_index * model + model_index, petr_tpu's
``devices.reshape(data, model)``.

The mesh in context (``use_mesh``) is what petr_tpu's ``constrain`` reads:
the decoder splits its keys over the model group, the dropout draws take
this rank's rows of the global batch's masks, batch-moments BN combines
its moments over the data group, and the loss averages its normaliser
there. Outside a mesh, or on a mesh of one rank, each is a no-op.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """This rank's place on a (data, model) grid of ``data * model`` ranks.

    ``data_group`` and ``model_group`` are the process groups of this
    rank's column and row, None where the axis has one rank (nothing to
    reduce). Build it with ``make_mesh``: every rank must create every
    group, in one order."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 data_group=None, model_group=None):
        self.shape = (data, model)
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group = data_group
        self.model_group = model_group

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    def batch_rows(self, local: int) -> Tuple[int, int]:
        """(global batch, first global row of this rank) for ``local`` rows
        per rank: the data axis splits the batch into equal contiguous
        shards, as ``shard_batch`` does."""
        return local * self.data, local * self.data_index

    def token_range(self, L: int) -> Tuple[int, int, int]:
        """(start, stop, shard length) of this rank's contiguous slice of
        ``L`` tokens over the model axis: shards of ceil(L / model), the last
        one short (or empty) when ``model`` does not divide L."""
        size = -(-L // self.model)
        start = min(self.model_index * size, L)
        return start, min(start + size, L), size


def _groups(data: int, model: int) -> Tuple[List, List]:
    """Every row's and every column's process group, created on every rank
    in the same order (``torch.distributed.new_group`` is collective)."""
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    cols = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    return rows, cols


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the ``n_devices`` ranks of the process group
    (all of them by default), with petr_tpu's factorisation: all ranks on
    ``data`` (pure data parallelism) unless ``model`` or ``data`` is given,
    the other axis taking the rest. Without an initialised process group
    it is the one-rank mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh spans every rank: {n} devices asked for, {world} ranks")
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh (data={data}, model={model}) does not cover {n} ranks")
    if n == 1:
        return Mesh(1, 1)
    rank = dist.get_rank()
    rows, cols = _groups(data, model)
    d, m = divmod(rank, model)
    return Mesh(data, model, rank,
                data_group=cols[m] if data > 1 else None,
                model_group=rows[d] if model > 1 else None)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a global batch along ``data``: the contiguous
    ``B / data`` rows at ``data_index`` of every array with a batch axis
    (petr_tpu's ``P("data")`` placement); 0-d entries and non-array
    entries stay as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1:
            B = v.shape[0]
            if B % mesh.data:
                raise ValueError(f"batch {k!r} of {B} rows does not split over data={mesh.data}")
            local = B // mesh.data
            out[k] = v[mesh.data_index * local:(mesh.data_index + 1) * local]
        else:
            out[k] = v
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.data * mesh.model == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def replicate_state(state, mesh: Mesh):
    """Broadcast rank 0's ``train.TrainState`` to every rank, in place: its
    parameters and buffers, its AdamW state and its step. Each rank builds,
    loads and restores its own state from what it sees; where the ranks
    share no file system only rank 0 sees the checkpoints it wrote, so rank
    0's state is the run's. Returns ``state``."""
    from petr_tpu_torch.train.forensics import _to_cpu

    if mesh.data * mesh.model == 1:
        return state
    replicate(state.model, mesh)
    payload = [{"optimizer": _to_cpu(state.optimizer.state_dict()), "step": int(state.step)}
               if mesh.rank == 0 else None]
    dist.broadcast_object_list(payload, src=0)
    state.optimizer.load_state_dict(payload[0]["optimizer"])
    state.step = payload[0]["step"]
    return state


class _DataMean(torch.autograd.Function):
    """The mean over the data group; its backward averages the cotangent
    over the group too: each rank's input reaches every rank's loss, and
    the step averages the ranks' losses."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _mean(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.mesh), None


def _mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out / mesh.data


def data_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of every rank's ``x`` over the data group, differentiable
    (``x`` itself without data parallelism)."""
    if mesh is None or mesh.data == 1:
        return x
    return _DataMean.apply(x, mesh)


_STACK: List[Mesh] = []


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the mesh in context for the block (None: none)."""
    _STACK.append(mesh)
    try:
        yield mesh
    finally:
        _STACK.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh in context, or None outside one or on a one-rank mesh."""
    mesh = _STACK[-1] if _STACK else None
    if mesh is None or mesh.data * mesh.model == 1:
        return None
    return mesh


def data_parallel() -> Optional[Mesh]:
    """The mesh in context when its data axis has more than one rank."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.data > 1 else None


def token_parallel() -> Optional[Mesh]:
    """The mesh in context when its model axis has more than one rank."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.model > 1 else None
