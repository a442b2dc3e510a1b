"""Data parallelism over `torch.distributed`, held against the JAX package's
`parallel/mesh.py` (`make_mesh`, `shard_batch`, `replicate`,
`data_axis_name`) and its trainers' `barrier`.

One process a rank; the process group is given its address, world size and
rank by the caller (`init_process_group`): NCCL on the card, gloo on the CPU
(gloo also all-reduces CUDA tensors, which lets two ranks share one card).
`make_mesh` lays the ranks on a 1-D `DeviceMesh` whose one dimension is
`data_axis_name`, or with `num_model` > 1 on a 2-D one over
(`data_axis_name`, `model_axis_name`), the ranks of a model group
consecutive, as the JAX package lays its devices; the model dimension is
tensor parallelism's (`parallel/tp.py`). Every rank reads the same whole
batch and keeps its rows (`shard_batch`, rank r of the data group the r-th
of its `world` equal slices); everything here acts on the data group
alone.

Inside `data_parallel(mesh)` the model's collectives and draws see the
group: the quantizers' EMA statistics are summed over it (`all_reduce_sum`,
JAX's `_maybe_psum`), their candidate rows gathered from every rank
(`gather_rows`), LFQ's mean bit probabilities averaged over it
(`mean_over_ranks`), and every random draw over the batch is made for the whole
batch and cut to this rank's rows (`local_rows`), so the ranks together
compute what one process computes on the whole batch. The scope is a
context variable, set for the length of a step and reset after it, because
the draws and the statistics sit deep inside the model (dropout in every
layer, the quantizers of every residual stage). Outside one every function
here does nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["data_axis_name", "model_axis_name", "model_coords", "init_process_group", "make_mesh", "shard_batch", "replicate",
           "data_parallel", "current", "all_reduce_sum", "all_reduce_mean", "mean_over_ranks",
           "gather_rows",
           "local_rows", "barrier", "is_main"]

data_axis_name = "data"
model_axis_name = "model"


@dataclass(frozen=True)
class _Scope:
    group: "dist.ProcessGroup"
    rank: int
    world: int


_SCOPE: "contextvars.ContextVar[_Scope | None]" = contextvars.ContextVar(
    "data_parallel", default=None)


def init_process_group(rank: int, world_size: int, *, init_method: str,
                       device: "str | torch.device" = "cuda", backend: "str | None" = None):
    """Join the default process group at `init_method` (for example
    `tcp://localhost:29500`): NCCL for a CUDA device (which is set to this
    rank's card) and gloo for the CPU unless `backend` says otherwise."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(num_data: "int | None" = None, num_model: int = 1):
    """A DeviceMesh over num_data x num_model ranks (num_data: all the ranks
    over num_model by default): 1-D, its one dimension named
    `data_axis_name`, when num_model is 1; else 2-D over (`data_axis_name`,
    `model_axis_name`), rank r at (r // num_model, r % num_model). The
    device type follows the default group's backend (NCCL: cuda, else
    cpu)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_process_group first")
    world = dist.get_world_size()
    num_data = world // num_model if num_data is None else num_data
    if num_data * num_model > world:
        raise ValueError(f"mesh of {num_data} x {num_model} exceeds the {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if num_model == 1:
        return init_device_mesh(device_type, (num_data,), mesh_dim_names=(data_axis_name,))
    return init_device_mesh(device_type, (num_data, num_model),
                            mesh_dim_names=(data_axis_name, model_axis_name))


def _coords(mesh):
    group = mesh.get_group(data_axis_name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def model_coords(mesh):
    """(group, rank in it, its size) of this rank's model group; (None, 0, 1)
    for None or a mesh without a model dimension."""
    if mesh is None or model_axis_name not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    group = mesh.get_group(model_axis_name)
    return group, dist.get_rank(group), dist.get_world_size(group)


def shard_batch(mesh, batch, axis: int = 0):
    """This rank's slice of `axis` of every tensor in `batch` (a tensor, or a
    list, tuple or dict of them); the axis must split evenly."""
    _, rank, world = _coords(mesh)

    def cut(x):
        n = x.shape[axis]
        if n % world:
            raise ValueError(f"batch {n} does not split over {world} ranks")
        return x.narrow(axis, rank * (n // world), n // world)

    return _tree_map(cut, batch)


def replicate(mesh, tree):
    """Every tensor of `tree` (a tensor, or a list, tuple or dict of them,
    such as `list(model.parameters())`) set to rank 0's, in place (a
    broadcast over the data group); returns the tree."""
    group, _, _ = _coords(mesh)
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        dist.broadcast(x.data, src, group=group)
        return x

    return _tree_map(bcast, tree)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


@contextlib.contextmanager
def data_parallel(mesh):
    """The scope of one data-parallel step over `mesh`'s data dimension (None:
    no scope, one process)."""
    if mesh is None:
        yield None
        return
    group, rank, world = _coords(mesh)
    token = _SCOPE.set(_Scope(group, rank, world))
    try:
        yield _SCOPE.get()
    finally:
        _SCOPE.reset(token)


def current() -> "_Scope | None":
    return _SCOPE.get()


def all_reduce_sum(t):
    """t summed over the data group, in place (t itself outside a scope)."""
    scope = _SCOPE.get()
    if scope is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=scope.group)
    return t


def all_reduce_mean(tensors):
    """Each tensor of the list averaged over the data group, in place, in one
    all-reduce of their concatenation."""
    scope = _SCOPE.get()
    if scope is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=scope.group)
    flat /= scope.world
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


def mean_over_ranks(t):
    """t averaged over the data group, differentiably (the backward sums
    the ranks' gradients, as JAX's psum transposes), so a function of the
    whole batch's mean (LFQ's batch entropy) gets one process's gradient
    once the ranks' gradients are averaged. t itself outside a scope."""
    scope = _SCOPE.get()
    if scope is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=scope.group) / scope.world


def gather_rows(x):
    """The rows of every rank's x (N, ...) stacked in rank order, (world * N,
    ...): one process's rows of the whole batch. An all-reduce of a zeroed
    buffer with each rank's rows in its slot, exact (each element is one
    rank's value plus zeros), so it runs on every backend, gloo on CUDA
    tensors too."""
    scope = _SCOPE.get()
    if scope is None or scope.world == 1:
        return x
    n = x.shape[0]
    buf = x.new_zeros((scope.world * n, *x.shape[1:]))
    buf[scope.rank * n:(scope.rank + 1) * n] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=scope.group)
    return buf


def local_rows(draw, shape):
    """draw(shape) for this rank's rows: draw(world * shape[0], ...) cut to
    the rank's slice of the first axis, so every rank draws the same whole
    batch from its generator (seeded alike) and keeps what one process would
    give its rows. Outside a scope, draw(shape)."""
    scope = _SCOPE.get()
    shape = tuple(shape)
    if scope is None or scope.world == 1:
        return draw(shape)
    n = shape[0]
    return draw((scope.world * n, *shape[1:]))[scope.rank * n:(scope.rank + 1) * n]


def barrier():
    """Wait for every rank of the default group (JAX's `barrier`: around
    saving and resuming a checkpoint); nothing without one."""
    if dist.is_initialized():
        dist.barrier()


def is_main() -> bool:
    """True on rank 0 of the default group, and without one."""
    return not dist.is_initialized() or dist.get_rank() == 0
