"""The device mesh as a process group: one process per card.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
controller and lets GSPMD emit the collectives. Here each rank of a
``torch.distributed`` process group drives one device: NCCL between CUDA
ranks, gloo between CPU ranks (how the tests run 2 and 4 ranks). A world of
one process, with or without a process group, is a valid mesh of one rank.

Axes:
  * ``data``  — per-clip / per-sample data parallelism, and the frame axis
    of temporal sharding (parallel/temporal.py).
  * ``model`` — tensor parallelism: each rank of a ``model`` axis computes
    a share of the conv output channels (``tp_param_sharding``,
    parallel/tp.py).

Ranks lie on the mesh in row-major order; a mesh of several axes also
holds, for each axis, the process group of the ranks that differ from this
one along that axis only (``Mesh.along``), which that axis's collectives
use.

Every rank holds the whole host input and computes its own shard; the
helpers below move the shards between ranks. A CUDA tensor crosses a gloo
group through host memory, and only there: NCCL groups take it as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from datetime import timedelta
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dvsg_tpu_torch import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks 0..size-1 of the default process group along named axes.

    ``rank`` is this process's place in the mesh, or None when the process
    is outside it (a mesh smaller than the world); ``group`` is the process
    group of the mesh's ranks, or None for a mesh of one process without a
    process group (no collective is made then); ``device`` is this rank's
    device.
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: Optional[int]
    device: torch.device
    group: Any = None
    axis_groups: Tuple[Any, ...] = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def shard(self, n: int, what: str = "batch") -> slice:
        """This rank's contiguous rows of a leading axis of ``n`` (the
        counterpart of ``data_sharding``); ``n`` must divide over the
        ranks."""
        if self.rank is None:
            raise ValueError("this process is not in the mesh")
        if n % self.size:
            raise ValueError(f"{what} {n} must divide evenly over "
                             f"{self.size} devices")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def along(self, axis: str) -> "Mesh":
        """The 1-D mesh of the ranks that differ from this one along
        ``axis`` only, with this rank's place on that axis; its collectives
        run in that axis's process group."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")
        if self.rank is None:
            raise ValueError("this process is not in the mesh")
        if len(self.shape) == 1:
            return self
        i = self.axis_names.index(axis)
        coord = int(np.unravel_index(self.rank, self.shape)[i])
        group = self.axis_groups[i] if self.axis_groups else None
        return Mesh((self.shape[i],), (axis,), coord, self.device, group)


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def _local_index() -> int:
    """The card index of this rank: ``LOCAL_RANK`` (torchrun), else the
    global rank, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return world_rank()


def rank_device(device="cuda") -> torch.device:
    """The device this rank drives: ``cuda`` without an index is the card
    ``_local_index()``; anything else as given. A card this process cannot
    see raises: one rank per card, never a wrapped or shared index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_index())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {world_rank()} would drive {dev}, but this process sees "
            f"{torch.cuda.device_count()} card(s): start at most one rank "
            "per visible card")
    return dev


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              device="cuda") -> Mesh:
    """A mesh over the ranks of the initialized default process group, or
    over this one process when there is none.

    ``shape=None`` takes every rank on one ``data`` axis. A shape that
    needs more ranks than the world has raises; a smaller one takes ranks
    0..n-1 as a new group (every rank of the world must make the same
    call: creating a group is collective). ``device`` is this rank's device
    (``rank_device``).
    """
    world = world_size()
    if shape is None:
        shape = (world,)
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {world}")
    names = tuple(axis_names[:len(shape)])
    if len(names) != len(shape) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} distinct "
                         f"axis names, got {tuple(axis_names)}")
    dev = rank_device(device)
    if not dist.is_initialized():
        return Mesh(shape, names, 0, dev)
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    rank = dist.get_rank()
    axis_groups = _axis_groups(shape, rank) if len(shape) > 1 else ()
    if rank >= n:
        return Mesh(shape, names, None, dev)
    return Mesh(shape, names, rank, dev, group, axis_groups)


def _axis_groups(shape: Tuple[int, ...], rank: int) -> Tuple[Any, ...]:
    """For each axis, the process group of the ranks that share every other
    coordinate with ``rank`` (None where the axis has one rank, or where
    ``rank`` is outside the mesh). Creating a group is collective: every
    rank of the world creates every group, in the same order."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out = []
    for i, k in enumerate(shape):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, k)
        mine = None
        for line in lines:
            g = dist.new_group(line.tolist()) if k > 1 else None
            if rank in line:
                mine = g
        out.append(mine)
    return tuple(out)


def tp_param_sharding(mesh: Mesh, params: dict) -> dict:
    """Tensor-parallel sharding spec of a ``MotionEstimator`` state dict:
    the reference's rule on torch's layouts. A conv kernel, (cout, cin, kh,
    kw), whose output-channel count is a multiple of the ``model`` axis's
    size shards dim 0 over ``model``: ``(MODEL_AXIS, None, None, None)``.
    Every other leaf (biases, GroupNorm scales and shifts, a kernel whose
    count is not) is replicated: ``()``. parallel/tp.py runs the model this
    spec describes. Raises ``ValueError`` on a mesh without a ``model``
    axis."""
    if MODEL_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh has no {MODEL_AXIS!r} axis: "
                         f"{mesh.axis_names}")
    n_model = mesh.shape[mesh.axis_names.index(MODEL_AXIS)]
    return {name: ((MODEL_AXIS, None, None, None)
                   if t.dim() == 4 and t.shape[0] % n_model == 0 else ())
            for name, t in params.items()}


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", timeout_s: float = 600.0
                     ) -> Optional[str]:
    """Join the default process group: over ``tcp://<coordinator>`` with
    ``num_processes`` ranks of which this is ``process_id``, or, without a
    coordinator, from the environment ``torchrun`` sets (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``). One process that is neither needs no group:
    returns None. Otherwise returns the backend: NCCL when this rank's
    device is a card, gloo on the CPU. A failed NCCL start is an error.
    A process already in a group stays in it (returns its backend)."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator is None and not ("MASTER_ADDR" in os.environ
                                    and "WORLD_SIZE" in os.environ):
        return None
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    return backend


# --- collectives -------------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the mesh's backend takes it: CUDA tensors through host
    memory on gloo, host tensors onto the rank's card on NCCL."""
    if mesh.backend == "gloo":
        return t.cpu()
    return t.to(mesh.device)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along the
    leading axis in rank order, on every rank; on ``t``'s device."""
    if mesh.group is None:
        return t
    src = _staged(mesh, t.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_gather_rows(mesh: Mesh, rows: np.ndarray) -> np.ndarray:
    """A host array's rows from every rank, in rank order, on every rank."""
    if mesh.group is None:
        return rows
    return all_gather(mesh, torch.from_numpy(np.ascontiguousarray(rows))
                      ).numpy()


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` on every rank (a new tensor on ``t``'s
    device)."""
    if mesh.group is None:
        return t.clone()
    buf = _staged(mesh, t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(t.device)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> None:
    """Overwrite ``t`` in place with rank ``src``'s."""
    if mesh.group is None:
        return
    buf = _staged(mesh, t)
    dist.broadcast(buf, src=src, group=mesh.group)
    if buf is not t:
        with torch.no_grad():
            t.copy_(buf)


def ring_shift(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Send ``t`` to the right neighbour and return the left neighbour's
    (the last rank's goes to rank 0): the ``ppermute`` of the temporal
    halo exchange. One rank gets its own back."""
    if mesh.size == 1:
        return t
    src = _staged(mesh, t.contiguous())
    buf = torch.empty_like(src)
    right = (mesh.rank + 1) % mesh.size
    left = (mesh.rank - 1) % mesh.size
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, right, mesh.group),
        dist.P2POp(dist.irecv, buf, left, mesh.group)])
    for r in reqs:
        r.wait()
    return buf.to(t.device)


def all_gather_object(mesh: Mesh, obj) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank.

    torch stages the pickles on the current CUDA device, not on a tensor's:
    a rank that never called ``torch.cuda.set_device`` stages on cuda:0,
    and NCCL refuses two ranks on one card. So the rank's card is made
    current for the call."""
    if mesh.group is None:
        return [obj]
    out: List[Any] = [None] * mesh.size
    with (torch.cuda.device(mesh.device) if mesh.device.type == "cuda"
          else contextlib.nullcontext()):
        dist.all_gather_object(out, obj, group=mesh.group)
    return out
