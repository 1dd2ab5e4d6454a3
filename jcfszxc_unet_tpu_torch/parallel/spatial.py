"""The whole-image forward with the image's rows sharded over the ranks,
counterpart of ``jcfszxc_unet_tpu/parallel/spatial.py``.

JAX shards the padded image's H axis over the mesh and lets GSPMD insert
a halo exchange for every op whose output row reads other rows.  torch
has no such partitioner, so the port makes each exchange explicit: under
:func:`row_sharded` every spatially coupled op of the port
(``ops/layers.py``, ``ops/blocks.py``, ``ops/s2d.py`` and the models that
reduce over the map) calls one of the helpers below on this rank's slab,
and outside it, or with one rank, every helper is the identity, so the
one-process forward does not change by a bit.

  * :func:`halo_slab` adds the rows a window op reads above and below the
    slab (from any rank, however deep the halo), zeros past the image's
    edges, as the op's own zero padding would be;
  * :func:`row_sum`, :func:`row_max` and :func:`row_mean` reduce over the
    whole map, :func:`gather_h` brings every rank all of a map's rows
    (the attention's keys and values, the output);
  * :func:`fetch_rows` moves any set of global rows to the ranks that ask
    for them (a center crop or pad of the whole map).

The collectives are ``all_reduce`` alone, so one code path runs on gloo
(CPU or CUDA tensors) and NCCL: a rank writes the rows it owns into a
zeroed buffer that holds what every rank asks for, and one sum delivers
them (x + 0 is x, so rows arrive bit for bit).  :data:`counter` counts
the collectives, their bytes and their host time.

A map's rows are split as the input's are: rank r holds
``row_bounds(global_h)``'s rows of the input, and a map whose local
height is k times its input's holds k times every rank's rows.
:func:`make_spatial_forward` pads H to a multiple of ``size * divisor``
(JAX's padding), so every rank holds the same even number of rows at
every level of the model.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from fractions import Fraction
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from jcfszxc_unet_tpu_torch.parallel.mesh import World, row_bounds


class CollectiveCounter:
    """The collectives that the helpers issued since :meth:`reset`, their
    bytes and the host milliseconds spent in them."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0

    def snapshot(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes, "ms": self.ms}


counter = CollectiveCounter()


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """The split of a row-sharded forward: ``world`` and each rank's rows
    of the input, ``counts`` (``row_bounds`` of the input's global H)."""

    world: World
    counts: tuple

    def layout(self, n_local: int) -> tuple[list, list]:
        """(starts, counts) of every rank's rows of a map of which this
        rank holds ``n_local`` rows: the input's split times
        n_local / (this rank's input rows)."""
        ratio = Fraction(n_local, self.counts[self.world.rank])
        counts = [ratio * c for c in self.counts]
        if any(c.denominator != 1 for c in counts):
            raise ValueError(
                f"a map of {n_local} local rows does not split as the "
                f"input's rows {list(self.counts)} do")
        counts = [int(c) for c in counts]
        starts = [sum(counts[:j]) for j in range(len(counts))]
        return starts, counts


_ACTIVE: contextvars.ContextVar[Optional[RowSharding]] = (
    contextvars.ContextVar("row_sharding", default=None))


def active() -> Optional[RowSharding]:
    """The sharding of the enclosing :func:`row_sharded`, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def row_sharded(world: Optional[World], global_h: int):
    """Inside, the port's spatial ops treat each tensor as this rank's
    rows of a map whose input had ``global_h`` rows, split by
    ``row_bounds``.  With ``world`` None or of one rank it does nothing."""
    if world is None or world.size == 1:
        yield
        return
    counts = tuple(b - a for a, b in (
        row_bounds(global_h, dataclasses.replace(world, rank=r))
        for r in range(world.size)))
    if min(counts) < 1:
        raise ValueError(f"{global_h} rows do not give each of "
                         f"{world.size} ranks one")
    token = _ACTIVE.set(RowSharding(world, counts))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _all_reduce(buf: torch.Tensor, world: World,
                op=dist.ReduceOp.SUM) -> None:
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=world.group)
    counter.calls += 1
    counter.bytes += buf.numel() * buf.element_size()
    counter.ms += (time.perf_counter() - t0) * 1e3


def fetch_rows(x: torch.Tensor, dim: int,
               wants: Sequence[Sequence[tuple[int, int]]],
               sharding: RowSharding) -> torch.Tensor:
    """The global rows (along ``dim``) that this rank asks for, from the
    ranks that hold them: ``wants[j]`` lists the [lo, hi) ranges rank j
    receives, in order, the same list on every rank; a row outside the
    map arrives as zeros.  One ``all_reduce`` of a zeroed buffer that
    holds every rank's request; returns this rank's, concatenated along
    ``dim``, contiguous."""
    starts, counts = sharding.layout(x.shape[dim])
    rank = sharding.world.rank
    own_lo, own_hi = starts[rank], starts[rank] + counts[rank]
    sizes = [sum(hi - lo for lo, hi in w) for w in wants]
    shape = list(x.shape)
    shape[dim] = sum(sizes)
    buf = x.new_zeros(shape)
    off = 0
    for w in wants:
        for lo, hi in w:
            a, b = max(lo, own_lo), min(hi, own_hi)
            if a < b:
                buf.narrow(dim, off + a - lo, b - a).copy_(
                    x.narrow(dim, a - own_lo, b - a))
            off += hi - lo
    _all_reduce(buf, sharding.world)
    return buf.narrow(dim, sum(sizes[:rank]), sizes[rank])


def halo_slab(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """This rank's rows of the NCHW map ``x`` with ``above`` rows from the
    ranks before it and ``below`` from the ranks after it (zeros past the
    map's top and bottom edges), in channels_last; a negative count drops
    that many of the slab's own rows instead.  Outside
    :func:`row_sharded` the map is whole, and the halo is zeros."""
    sharding = active()
    xh = x.permute(0, 2, 3, 1)  # NHWC: rows on dim 1
    if above < 0:
        xh, above = xh[:, -above:], 0
    if below < 0:
        xh, below = xh[:, :xh.shape[1] + below], 0
    if above == 0 and below == 0:
        return xh.permute(0, 3, 1, 2)
    if sharding is None:
        halo = [xh.new_zeros((xh.shape[0], n) + tuple(xh.shape[2:]))
                for n in (above, below)]
        return torch.cat([halo[0], xh, halo[1]], dim=1).permute(0, 3, 1, 2)
    starts, counts = sharding.layout(x.shape[2])
    wants = [[(s - above, s), (s + c, s + c + below)]
             for s, c in zip(starts, counts)]
    got = fetch_rows(xh, 1, wants, sharding)
    out = torch.cat([got[:, :above], xh, got[:, above:]], dim=1)
    return out.permute(0, 3, 1, 2)


def gather_h(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """All rows (along ``dim``) of the map of which ``x`` holds this
    rank's, on every rank (identity outside :func:`row_sharded`)."""
    sharding = active()
    if sharding is None:
        return x
    starts, counts = sharding.layout(x.shape[dim])
    rank = sharding.world.rank
    shape = list(x.shape)
    shape[dim] = sum(counts)
    out = x.new_zeros(shape)
    out.narrow(dim, starts[rank], counts[rank]).copy_(x)
    _all_reduce(out, sharding.world)
    return out


def _sum_over_ranks(x: torch.Tensor, dim, keepdim: bool,
                    sharding: RowSharding) -> torch.Tensor:
    s = x.sum(dim=dim, keepdim=keepdim, dtype=torch.float32).contiguous()
    _all_reduce(s, sharding.world)
    return s


def row_sum(x: torch.Tensor, dim=(2, 3), keepdim: bool = False
            ) -> torch.Tensor:
    """``x.sum(dim)`` over the whole map (``dim`` covers the sharded row
    axis), in f32 across the ranks, returned in x.dtype."""
    sharding = active()
    if sharding is None:
        return x.sum(dim=dim, keepdim=keepdim)
    return _sum_over_ranks(x, dim, keepdim, sharding).to(x.dtype)


def row_mean(x: torch.Tensor, dim=(2, 3), keepdim: bool = False
             ) -> torch.Tensor:
    """``x.mean(dim)`` over the whole map; the first axis of ``dim`` is
    the sharded one (rows, or row-major tokens)."""
    sharding = active()
    if sharding is None:
        return x.mean(dim=dim, keepdim=keepdim)
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n_rows = x.shape[dims[0]]
    total = sum(sharding.layout(n_rows)[1])
    for d in dims[1:]:
        total *= x.shape[d]
    return (_sum_over_ranks(x, dim, keepdim, sharding) / total).to(x.dtype)


def row_max(x: torch.Tensor, dim=(2, 3), keepdim: bool = False
            ) -> torch.Tensor:
    """``x.amax(dim)`` over the whole map."""
    sharding = active()
    if sharding is None:
        return x.amax(dim=dim, keepdim=keepdim)
    m = x.amax(dim=dim, keepdim=keepdim).contiguous()
    _all_reduce(m, sharding.world, dist.ReduceOp.MAX)
    return m


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int):
    """Zero-pad ``axis`` at its end up to the next multiple; returns
    (padded, original size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, target - size]
    return F.pad(x, pads), size


def spatial_forward(forward: Callable[[torch.Tensor], torch.Tensor],
                    images: torch.Tensor, world: Optional[World],
                    divisor: int = 32) -> torch.Tensor:
    """The steps of JAX ``make_spatial_forward``'s forward on (N, H, W, C)
    images: H padded to a multiple of ``size * divisor`` and W to one of
    ``divisor``, this rank's rows through ``forward`` (a (B, h, W', C) ->
    (B, h, W', 1) map, run under :func:`row_sharded`), the rows gathered
    on every rank and cropped back: (N, H, W)."""
    size = 1 if world is None else world.size
    x, orig_h = pad_to_multiple(images, 1, size * divisor)
    x, orig_w = pad_to_multiple(x, 2, divisor)
    hp = x.shape[1]
    rows = hp // size
    if rows % divisor:  # every level of the model splits evenly
        raise ValueError(f"{hp} padded rows over {size} ranks leave "
                         f"{rows} a rank, not a multiple of {divisor}")
    start = 0 if world is None else world.rank * rows
    with row_sharded(world, hp):
        out = gather_h(forward(x[:, start:start + rows].contiguous()), 1)
    return out[:, :orig_h, :orig_w, 0]


def make_spatial_forward(model: torch.nn.Module, world: Optional[World],
                         divisor: int = 32, compute_dtype=torch.float32,
                         apply_sigmoid: bool = True):
    """fn(images (N, H, W, C)) -> (N, H, W) maps of ``model`` (eval mode,
    on the world's device), with the rows sharded over ``world``'s ranks
    (every rank passes the same images and gets the whole maps): the
    model in ``compute_dtype``, its output in f32, then the sigmoid
    unless ``apply_sigmoid`` is False (JAX ``make_spatial_forward``)."""
    model.eval()

    def slab_forward(batch):
        out = model(batch.permute(0, 3, 1, 2).to(compute_dtype)).float()
        if apply_sigmoid:
            out = torch.sigmoid(out)
        return out.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def forward(images):
        return spatial_forward(slab_forward, images, world, divisor)

    return forward
