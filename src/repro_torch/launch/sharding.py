"""The collectives of a sharded train step, written out.

The JAX package states layouts (``PartitionSpec``s) and XLA's GSPMD
inserts the collectives; the port calls them itself, over the axis
sub-groups of a ``launch.mesh.Mesh``.  A spec is a tuple with one entry
per dim: ``None``, a mesh axis name, or a tuple of names, major first (a
dim over ("pod", "data") is cut into pod x data pieces, the pod index
major).  Rank (i, j, ...) holds piece ``index`` of each dim; a leaf is
replicated along every axis its spec does not name.

This module does five things: it cuts a leaf to a rank's slice
(``shard``, ``slices``), gathers a leaf from the slices (``gather``),
sums a gradient over the data-parallel axes and cuts it to the rank's
slice (``reduce_grad``: a reduce-scatter along a dim the spec shards over
a summed axis, an all-reduce over a summed axis the spec does not name,
a plain cut over any other axis), makes a sum of squares over
sharded leaves count each element once (``sum_squares``: a leaf
replicated along an axis contributes from index 0 of that axis only),
and sums a few small tensors and flags over one axis in one call
(``sum_over``: the multi-workflow fleet's per-workflow reductions over
"task").

The backend is the process group's (``mesh.init_process_group``): gloo
on the CPU and for ranks that share a card, NCCL for one card a rank.
gloo takes CUDA tensors in every collective used here (all-gather,
reduce-scatter, all-reduce, barrier; probed on torch 2.11.0+cu128), so
nothing is staged through host memory.  ``BYTES`` and ``CALLS`` count,
for this process, the payload of each collective kind (the bytes of the
whole tensor a rank gives to or takes from it) and its calls.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.models.common import local_shape, mesh_axis_sizes

#: payload bytes and calls of each collective kind in this process
BYTES: Counter = Counter()
CALLS: Counter = Counter()


def reset_counts() -> None:
    BYTES.clear()
    CALLS.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    BYTES[kind] += t.numel() * t.element_size()
    CALLS[kind] += 1


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True, eq=False)
class Sharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple[int, ...]:
        return local_shape(shape, self.spec, mesh_axis_sizes(self.mesh))

    def global_shape(self, shape) -> tuple[int, ...]:
        """The leaf's shape from one rank's slice of ``shape``."""
        sizes = mesh_axis_sizes(self.mesh)
        return tuple(n * math.prod(sizes[a] for a in axes_of(e))
                     for n, e in zip(shape, self.spec))

    def slices(self, shape) -> tuple[slice, ...]:
        """This rank's slice of a leaf of global ``shape``."""
        out = []
        for dim, entry in zip(shape, self.spec):
            start, size = 0, dim
            for a in axes_of(entry):
                size //= self.mesh.shape[a]
                start += self.mesh.index(a) * size
            out.append(slice(start, start + size))
        return tuple(out)

    def owner(self) -> bool:
        """Whether this rank holds its slice at index 0 of every axis the
        spec does not name (one rank of each set holding equal slices)."""
        named = {a for e in self.spec for a in axes_of(e)}
        return all(self.mesh.index(a) == 0 for a in self.mesh.axis_names
                   if a not in named)


def shard(x: torch.Tensor, sh: Sharding) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x`` (a view)."""
    return x[sh.slices(x.shape)]


def _all_gather(x: torch.Tensor, dim: int, group, n: int,
                kind: str = "all_gather") -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count(kind, out)
    return out


def gather(x: torch.Tensor, sh: Sharding, kind: str = "all_gather"
           ) -> torch.Tensor:
    """The whole leaf from each rank's slice ``x`` (``x`` itself where
    no axis of the spec has more than one rank).  Along a dim over several
    axes the minor axis is gathered first, then the next.  The all-gathers
    are counted under ``kind``."""
    for d, entry in enumerate(sh.spec):
        for a in reversed(axes_of(entry)):
            n = sh.mesh.shape[a]
            if n > 1:
                x = _all_gather(x, d, sh.mesh.group(a), n, kind)
    return x


class ExpertSlice(torch.autograd.Function):
    """The MoE's dispatch onto this rank's experts: ``apply(x, mesh,
    axis)`` is this rank's piece of dim 0 of ``x`` along ``axis`` (x
    whole and alike on the axis's ranks; no traffic).  The backward
    all-gathers the pieces' gradients over ``axis`` (counted as
    "exchange"): every rank gets the whole gradient of ``x``, the
    one-process bits in the one-process order, and sums no partial
    gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        n = x.shape[0] // mesh.shape[axis]
        return x.narrow(0, mesh.index(axis) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        return (_all_gather(g, 0, mesh.group(axis), mesh.shape[axis],
                            "exchange"), None, None)


class ExpertGather(torch.autograd.Function):
    """The MoE's exchange of expert outputs: ``apply(y, mesh, axis)``
    all-gathers this rank's experts' outputs ``y`` (dim 0) over ``axis``
    (counted as "exchange"), so that every rank combines all K outputs of
    each of its tokens.  The backward is the rank's own piece of the
    gradient: what follows runs alike on the axis's ranks, so a
    reduce-scatter would add up identical copies of one gradient."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather(y, 0, mesh.group(axis), mesh.shape[axis],
                           "exchange")

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        n = g.shape[0] // mesh.shape[axis]
        return g.narrow(0, mesh.index(axis) * n, n).contiguous(), None, None


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int, index: int
                    ) -> torch.Tensor:
    chunks = [c.contiguous() for c in g.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[index])
    dist.reduce_scatter(out, chunks, group=group)
    _count("reduce_scatter", g)
    return out


def all_reduce(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` summed in place over each of ``axes`` (those of more than
    one rank)."""
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(t, group=mesh.group(a))
            _count("all_reduce", t)
    return t


def sum_over(tensors, axis: str, mesh) -> tuple[torch.Tensor, ...]:
    """``tensors`` summed over the mesh axis ``axis`` in one counted
    all-reduce (``all_reduce`` of their float64 concatenation), each
    returned in its own shape and dtype; a bool tensor is a flag, true
    where it is true on any rank of the axis.  Along an axis of one rank
    the tensors come back as they are, and nothing is launched."""
    if mesh.shape[axis] == 1:
        return tuple(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    all_reduce(flat, (axis,), mesh)
    out = []
    for part, t in zip(flat.split([t.numel() for t in tensors]), tensors):
        part = part.reshape(t.shape)
        out.append(part > 0 if t.dtype == torch.bool else part.to(t.dtype))
    return tuple(out)


def reduce_grad(g: torch.Tensor, sh: Sharding, summed: tuple[str, ...]
                ) -> torch.Tensor:
    """A whole gradient ``g`` summed over the ``summed`` axes and cut to
    this rank's slice.  Dims with no summed axis are cut first (no
    traffic); a dim over a summed axis is reduce-scattered over it, its
    axes taken major first; a summed axis the spec does not name is an
    all-reduce of what is left."""
    mesh = sh.mesh
    live = [a for a in summed if mesh.shape[a] > 1]
    for d, entry in enumerate(sh.spec):
        if not any(a in live for a in axes_of(entry)):
            for a in axes_of(entry):
                n = g.shape[d] // mesh.shape[a]
                g = g.narrow(d, mesh.index(a) * n, n)
    for d, entry in enumerate(sh.spec):
        axes = axes_of(entry)
        if any(a in live for a in axes):
            for a in axes:
                n = mesh.shape[a]
                if a in live:
                    g = _reduce_scatter(g, d, mesh.group(a), n,
                                        mesh.index(a))
                elif n > 1:
                    size = g.shape[d] // n
                    g = g.narrow(d, mesh.index(a) * size, size)
    named = {a for e in sh.spec for a in axes_of(e)}
    rest = [a for a in live if a not in named]
    if rest:
        g = all_reduce(g.contiguous(), rest, mesh)
    return g.contiguous()


def sum_squares(tensors, shardings) -> torch.Tensor:
    """The fp32 sum of squares of the whole leaves whose slices are
    ``tensors``, each element counted once: each leaf's slice sum, from
    its ``owner`` ranks only, then one all-reduce over the mesh's ranks
    (none on a mesh of one process)."""
    sums = [torch.sum(torch.square(x.float())) if sh.owner()
            else torch.zeros((), dtype=torch.float32, device=x.device)
            for x, sh in zip(tensors, shardings)]
    total = torch.sum(torch.stack(sums))
    if shardings and shardings[0].mesh.size > 1:
        dist.all_reduce(total)       # the mesh's ranks are the world's
        _count("all_reduce", total)
    return total


def dp_axes(mesh, rules) -> tuple[str, ...]:
    """The rules' data-parallel axes of more than one rank on ``mesh``."""
    return tuple(a for a in rules.dp_axes if mesh.shape.get(a, 1) > 1)


def batch_rows(global_batch: int, microbatches: int, dp: int, index: int
               ) -> list[int]:
    """The rows of a global batch that data-parallel rank ``index`` of
    ``dp`` takes, microbatch by microbatch: microbatch i is rows [i B/mb,
    (i+1) B/mb) of the global batch, split over the dp ranks in order (the
    JAX package's reshape of the batch into microbatches, each sharded
    over the dp axes)."""
    if global_batch % (microbatches * dp):
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"split into {microbatches} microbatches over "
                         f"{dp} data-parallel ranks")
    per_mb = global_batch // microbatches
    n = per_mb // dp
    return [i * per_mb + index * n + j
            for i in range(microbatches) for j in range(n)]


def dp_index(mesh, axes) -> int:
    """This rank's index over ``axes`` (row-major, the first major)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def local_batch(batch: dict, mesh, rules, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch (``batch_rows`` over the rules'
    dp axes; every row where the mesh has no dp axis of more than one
    rank), in microbatch order."""
    axes = dp_axes(mesh, rules)
    if not axes:
        return batch
    B = next(iter(batch.values())).shape[0]
    dp = math.prod(mesh.shape[a] for a in axes)
    rows = batch_rows(B, microbatches, dp, dp_index(mesh, axes))
    idx = torch.tensor(rows, dtype=torch.long)
    return {k: v.index_select(0, idx.to(v.device)) for k, v in batch.items()}


def init_local(defs, gen: torch.Generator, device, shardings):
    """Each leaf of ``defs`` drawn whole from ``gen`` in the one-process
    order (``tree_defs_init``), this rank's slice kept: the same
    parameters as the one-process init, sharded."""
    from repro_torch.models.common import init_leaf, is_def

    def build(d, sh):
        if is_def(d):
            return shard(init_leaf(gen, d, device), sh).clone()
        return {k: build(d[k], sh[k]) for k in sorted(d)}
    return build(defs, shardings)


def tree_shardings(specs, mesh):
    """A tree of ``Sharding`` from a tree of specs."""
    if isinstance(specs, dict):
        return {k: tree_shardings(v, mesh) for k, v in specs.items()}
    return Sharding(mesh, specs)
