"""Process groups and the collectives of data-parallel runs, counterpart
of ``jcfszxc_unet_tpu/parallel/mesh.py`` (a 1-D ``data`` mesh, the batch
sharded, the gradient all-reduce inserted by GSPMD).

The JAX package runs one program over a mesh and keeps the batch's
semantics **global**: BatchNorm statistics over the global batch, one
Dice over the global batch, the gradient of that one loss.  PyTorch runs
one process per device (a *rank*), so the port makes each global
reduction explicit:

  * :class:`World` is the caller's handle on the job: rank, size, this
    rank's device and the process group; ``None`` everywhere means one
    process, and every helper below is then the identity;
  * :func:`all_reduce_sum` is a sum over ranks that autograd goes
    through (its backward sums the incoming gradients over ranks), for
    the BatchNorm sums (``ops/layers.py``) and the Dice sums
    (``train/losses.py``);
  * :func:`average_gradients` all-reduces every parameter's gradient as
    one flattened f32 buffer after ``backward()`` and divides by the
    size, in place of ``DistributedDataParallel`` (whose ``module.``
    prefix, unused-parameter search and per-bucket hooks the port does
    not need: TransFuseNet's unused head contributes zeros, state-dict
    keys stay the reference's, and the NaN guard decides once for all
    ranks on the all-reduced loss);
  * :func:`shard_rows` / :func:`gather_rows` split axis 0 over the ranks
    and put the rows back together, :func:`gather_rows` by one
    ``all_reduce`` of a zeroed buffer, since gloo on CUDA tensors offers
    only ``broadcast``, ``all_reduce`` and ``barrier``.

The row-sharded whole-image forward (``parallel/spatial.py``) builds on
:func:`row_bounds` and the same zeroed-buffer ``all_reduce``: its
``halo_slab`` brings each rank the rows above and below its slab that a
window op reads, and ``gather_h`` all of a map's rows.

Backends: NCCL for CUDA with one device per rank, gloo for the CPU, and
gloo on CUDA only when the caller names it (several ranks sharing one
card, where NCCL refuses).  The group's timeout is short (60 s by
default, for tests and smoke runs), so a hung collective fails the run
instead of holding it; the CLIs take torch's default unless
``--dist-timeout`` names one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of a data-parallel job.  ``group`` None is the
    default process group."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def is_main(world: Optional[World]) -> bool:
    """True in a single process and on rank 0 of a job."""
    return world is None or world.is_main


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The backend rule: ``backend`` when the caller names one, else NCCL
    for a CUDA device and gloo for the CPU."""
    if backend is not None:
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` without an index is ``cuda:local_rank``
    (one card per rank); ``cuda:N`` and ``cpu`` are taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *,
                           local_rank: Optional[int] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: Optional[float] = DEFAULT_TIMEOUT_S
                           ) -> Optional[World]:
    """Join this process into a job and return its :class:`World`.

    From the arguments, or from the environment torchrun sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` via
    ``env://``).  With neither (one process) it does nothing and returns
    None, as the JAX function does.  NCCL needs a card per rank: a CUDA
    rank without one raises, naming gloo as the way to share a card.
    ``timeout_s`` bounds every collective (None: torch's default, 10 min
    for NCCL and 30 for gloo)."""
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return None
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env.get("RANK", 0) if rank is None else rank)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    backend = backend_for(dev, backend)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: device {str(dev)!r} requested "
                               "but CUDA is not available")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: {dev} does not exist "
                f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(dev)
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"NCCL needs one card per rank: {world_size} ranks, "
            f"{torch.cuda.device_count()} cards; pass backend='gloo' to "
            "share a card")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=None if timeout_s is None
        else datetime.timedelta(seconds=timeout_s))
    return World(rank=rank, size=world_size, device=dev, backend=backend)


def shutdown(world: Optional[World]) -> None:
    """Leave the job (no-op for None)."""
    if world is not None and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda",
              axis_name: str = "data"):
    """1-D ``data`` mesh over the first ``n_devices`` ranks (default: all)
    of the initialized job (``torch.distributed.device_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def make_2d_mesh(data: int, model: int, device_type: str = "cuda"):
    """(data, model) mesh; the model axis is unused, as in the JAX
    package (the zoo's conv-dominant compute shards only the batch)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def row_bounds(n: int, world: Optional[World]) -> tuple[int, int]:
    """[start, stop) of this rank's rows of ``n``: contiguous, sizes
    differing by at most one (``numpy.array_split``'s split)."""
    if world is None:
        return 0, n
    base, extra = divmod(n, world.size)
    start = world.rank * base + min(world.rank, extra)
    return start, start + base + (world.rank < extra)


def shard_rows(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """This rank's contiguous equal slice of axis 0 (JAX
    ``shard_batch``); raises when the rows do not divide."""
    if world is None or world.size == 1:
        return x
    if x.shape[0] % world.size:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"{world.size} ranks")
    start, stop = row_bounds(x.shape[0], world)
    return x[start:stop]


def gather_rows(local: torch.Tensor, n: int, world: Optional[World]
                ) -> torch.Tensor:
    """The (n, ...) tensor whose rows :func:`row_bounds` gives each rank,
    from this rank's ``local`` rows, on every rank: each rank fills its
    rows of a zeroed buffer and one ``all_reduce`` sums them (x + 0 is x,
    so the rows arrive bit for bit)."""
    if world is None or world.size == 1:
        return local
    start, stop = row_bounds(n, world)
    if local.shape[0] != stop - start:
        raise ValueError(f"rank {world.rank} holds {local.shape[0]} rows, "
                         f"expected {stop - start} of {n}")
    out = local.new_zeros((n,) + tuple(local.shape[1:]))
    out[start:stop] = local
    dist.all_reduce(out, group=world.group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the incoming gradients over ranks
    (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=world.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.world.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """Sum of ``x`` over the ranks, differentiable (identity for None or
    one rank)."""
    if world is None or world.size == 1:
        return x
    return _AllReduceSum.apply(x, world)


def mean_over_ranks(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """Mean of a (detached) tensor over the ranks, on every rank."""
    if world is None or world.size == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=world.group)
    return y / world.size


def average_gradients(params: Iterable[torch.nn.Parameter],
                      world: Optional[World]) -> None:
    """Replace every parameter's gradient by its mean over the ranks: one
    flattened f32 buffer, one ``all_reduce``.  A parameter without a
    gradient contributes zeros and gets the mean as its gradient, so
    every rank holds the same gradients afterwards."""
    if world is None or world.size == 1:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    flat = torch.cat([
        (p.grad if p.grad is not None else torch.zeros_like(p))
        .reshape(-1).float() for p in params])
    dist.all_reduce(flat, group=world.group)
    flat /= world.size
    offset = 0
    for p in params:
        n = p.numel()
        g = flat[offset:offset + n].view_as(p).to(p.dtype)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        offset += n


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, world: Optional[World],
                     src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank."""
    if world is None or world.size == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_contiguous():
            dist.broadcast(t.data, src, group=world.group)
        else:
            buf = t.data.contiguous()
            dist.broadcast(buf, src, group=world.group)
            t.data.copy_(buf)


def barrier(world: Optional[World]) -> None:
    """Every rank waits for the others (no-op for None)."""
    if world is not None and world.size > 1:
        dist.barrier(group=world.group)


@contextlib.contextmanager
def global_batch_norm(model: torch.nn.Module, world: Optional[World]):
    """Inside, every BatchNorm of ``model`` that is an
    ``ops.layers.GlobalStatsBatchNorm`` (the port's ``BatchNorm1d`` and
    ``BatchNorm2d``) takes its train-mode statistics over the ranks of
    ``world``; at the exit they take them locally again."""
    from jcfszxc_unet_tpu_torch.ops.layers import GlobalStatsBatchNorm

    if world is None or world.size == 1:
        yield
        return
    bns = [m for m in model.modules()
           if isinstance(m, GlobalStatsBatchNorm)]
    for m in bns:
        m.world = world
    try:
        yield
    finally:
        for m in bns:
            m.world = None
