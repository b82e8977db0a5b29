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

For serving (``launch.steps.make_prefill_step`` / ``make_decode_step``)
it also holds the "model" axis as the steps use it (``ModelAxis``,
``model_axis``), the rows of a serving batch a rank takes (``Rows``,
``serve_rows``, ``gather_rows``), a rank's serving copy of a leaf
(``serve_shard``, ``init_serving``: the leaf whole over the fsdp axes, its
"model" slice or, for the Mamba-2 leaves cut along heads, its columns),
the two operators of tensor-parallel compute (``CopyIn``: identity
forward, all-reduce backward; ``SumOut``: all-reduce forward, identity
backward) and the greedy token over vocab slices (``greedy``).  The
train step (``launch.steps.make_train_step``) computes in the same
layout: ``train_axis`` is its "model" handle, ``AllSum`` a sum whose
backward sums too (the Mamba-2 gated norm's squares), ``GatherOut`` the
vocab-parallel cross-entropy's merge, and ``gather``'s ``kinds`` count
a leaf's gather over "model" apart ("all_gather_model").

The backend is the process group's (``mesh.init_process_group``): gloo
on the CPU and for ranks that share a card, NCCL for one card a rank.
gloo takes CUDA tensors in every collective used here (all-gather,
reduce-scatter, all-reduce, barrier; probed on torch 2.11.0+cu128), so
nothing is staged through host memory.  Each collective is called at
one of five sites (``_all_gather``, ``_reduce_scatter``, ``all_reduce``,
``sum_squares``, ``axis_sum``), and each hands every call to
``analysis.collectives.record`` with its kind, its op, the size of its
group and its payload (the whole tensor a rank gives to or takes from
it): ``BYTES`` and ``CALLS`` count, for this process, the payload of
each kind and its calls, and a ``step_stats`` block takes the census of
its ops and ring-model wire bytes.  The serving kinds: "tp_sum" (a row-parallel product's sum over "model"),
"embed_sum" (the vocab-parallel embedding's), "norm_sum" (the Mamba-2
gated norm's sum of squares, both ways in training), "argmax" (the
greedy token's (value, index) pairs), "rows" (a step's tokens over the
dp axes) and "tp_grad" (``CopyIn``'s backward); with the KV cache's
sequence over "model" (context-parallel decode, ``model_axis``'s
``seq``), "cp_q" (a decode step's query heads gathered over "model",
``gather_heads``) and "cp_merge" (the ranks' partial attention rows and
their log-sum-exps, ``merge_partials``); "moe_tokens" (a MoE decode
step's tokens gathered over the dp axes where they fall back to one
group, ``models.moe``); the training kinds: "kv_grad"
(the KV leaves' gradients where the KV heads are whole), "xent" (the
cross-entropy's merge) and "all_gather_model".
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.analysis.collectives import BYTES, CALLS, record
from repro_torch.models.common import (axes_of, check_spec, local_shape,
                                       mesh_axis_sizes)

def reset_counts() -> None:
    BYTES.clear()
    CALLS.clear()


@dataclass(frozen=True, eq=False)
class Sharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    def __post_init__(self):
        check_spec(self.spec)

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
    record(kind, "all-gather", n, out)
    return out


def gather(x: torch.Tensor, sh: Sharding, kind: str = "all_gather",
           kinds: dict | None = None) -> torch.Tensor:
    """The whole leaf from each rank's slice ``x`` (``x`` itself where
    no axis of the spec has more than one rank).  Along a dim over several
    axes the minor axis is gathered first, then the next.  The all-gathers
    are counted under ``kind``, or under ``kinds[axis]`` where given."""
    for d, entry in enumerate(sh.spec):
        for a in reversed(axes_of(entry)):
            n = sh.mesh.shape[a]
            if n > 1:
                x = _all_gather(x, d, sh.mesh.group(a), n,
                                (kinds or {}).get(a, kind))
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


class GatherOut(torch.autograd.Function):
    """An all-gather whose result every rank then uses alike:
    ``apply(y, mesh, axis, kind)`` all-gathers the ranks' ``y`` along dim
    0 over ``axis`` (counted under ``kind``; "exchange" for the MoE's
    expert outputs, each rank then combining all K outputs of each of its
    tokens; "xent" for the vocab-parallel cross-entropy's per-rank
    log-sum-exps and label logits).  The backward is the rank's own piece
    of the gradient: what follows runs alike on the axis's ranks, so a
    reduce-scatter would add up identical copies of one gradient."""

    @staticmethod
    def forward(ctx, y, mesh, axis, kind="exchange"):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_gather(y, 0, mesh.group(axis), mesh.shape[axis], kind)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        n = g.shape[0] // mesh.shape[axis]
        return (g.narrow(0, mesh.index(axis) * n, n).contiguous(), None,
                None, None)


def _reduce_scatter(g: torch.Tensor, dim: int, group, n: int, index: int
                    ) -> torch.Tensor:
    chunks = [c.contiguous() for c in g.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[index])
    dist.reduce_scatter(out, chunks, group=group)
    record("reduce_scatter", "reduce-scatter", n, g)
    return out


def all_reduce(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``t`` summed in place over each of ``axes`` (those of more than
    one rank)."""
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(t, group=mesh.group(a))
            record("all_reduce", "all-reduce", mesh.shape[a], t)
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
        record("all_reduce", "all-reduce", dist.get_world_size(), total)
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


# ---------------------------------------------------------------------------
# Serving: the "model" axis, the rows, a rank's serving copy of a leaf
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class ModelAxis:
    """The "model" axis of a mesh as the serving steps use it: ``size``
    ranks (tp), this rank's ``index`` along it, ``name`` the mesh axis
    (None where it has one rank) and ``group()`` their process sub-group.
    A leaf split over it holds piece ``index`` of ``size`` (``part``).
    ``seq``: whether the KV caches' sequence is split over it (each rank
    holding positions [index L, (index + 1) L) of every KV head, L the
    caches' length over ``size``: context-parallel decode); None where
    the rules split it but the caches' length was not given
    (``model_axis``)."""
    mesh: object
    name: str | None
    size: int
    index: int
    seq: bool | None = False

    def group(self):
        return self.mesh.group(self.name)

    def part(self, n: int) -> tuple[int, int]:
        """(start, length) of this rank's piece of a dim of ``n``."""
        k = n // self.size
        return self.index * k, k


#: the "model" axis of a mesh without one (or of one rank): nothing is split
ONE_RANK = ModelAxis(None, None, 1, 0)


def model_axis(mesh, rules, max_len: int | None = None) -> ModelAxis:
    """The "model" axis of ``mesh`` (``ONE_RANK`` where the mesh has none,
    or one of a single rank).  Where ``rules`` put the KV cache's sequence
    ("kv_seq") over it, its ``seq`` says whether caches of ``max_len``
    positions are split by sequence: the rules' dimension-aware
    resolution, so a ``max_len`` that does not divide over "model" keeps
    the caches whole along the sequence (the path without the rule), as
    in the JAX package.  Without ``max_len`` ``seq`` is None: the greedy
    token and the serving loop's handle need no cache, and a layer that
    meets a cache raises.  ``kv_seq`` over any other axis raises."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return ONE_RANK
    axis = train_axis(mesh)
    over = axes_of(rules.resolve("kv_seq")[0])
    if not over:
        return axis
    if over != ("model",):
        raise NotImplementedError(
            f"kv_seq over {over}: the port splits a KV cache's sequence "
            "over \"model\" alone")
    seq = (None if max_len is None else
           bool(axes_of(rules.resolve("kv_seq", dims=(max_len,))[0])))
    return dataclasses.replace(axis, seq=seq)


def cache_len(n: int, rules, mesh) -> int:
    """``n`` positions rounded up to a multiple of the "model" ranks where
    ``rules`` put the KV cache's sequence over "model" (so that the
    caches split; the positions past ``n`` are never attended), ``n``
    itself otherwise."""
    tp = model_axis(mesh, rules)
    if tp.seq is False:
        return n
    return -(-n // tp.size) * tp.size


def train_axis(mesh) -> ModelAxis:
    """The "model" axis of a training mesh: ``ONE_RANK`` where the mesh
    has none, or one of a single rank (the train step's tensor-parallel
    compute, ``launch.steps.make_train_step``; no cache rule applies)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return ONE_RANK
    return ModelAxis(mesh, "model", mesh.shape["model"], mesh.index("model"))


def axis_sum(t: torch.Tensor, axis: ModelAxis, kind: str) -> torch.Tensor:
    """``t`` summed in place over ``axis`` (counted under ``kind``);
    ``t`` as it is on an axis of one rank."""
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group())
        record(kind, "all-reduce", axis.size, t)
    return t


class CopyIn(torch.autograd.Function):
    """The input of a column-parallel product: ``apply(x, axis, kind)`` is
    ``x`` (whole and alike on the axis's ranks); the backward sums the
    ranks' partial gradients of ``x`` over ``axis`` (counted under
    ``kind``, default "tp_grad").  Applied to a weight that every rank
    holds whole but uses in part (the KV projections where the KV heads do
    not split), it sums that weight's partial gradients once."""

    @staticmethod
    def forward(ctx, x, axis, kind="tp_grad"):
        ctx.axis, ctx.kind = axis, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (axis_sum(g.contiguous().clone(), ctx.axis, ctx.kind), None,
                None)


class SumOut(torch.autograd.Function):
    """The output of a row-parallel product: ``apply(x, axis, kind)`` sums
    the ranks' partial outputs ``x`` over ``axis`` (counted under
    ``kind``); the backward passes the gradient through, since what
    follows runs alike on the axis's ranks."""

    @staticmethod
    def forward(ctx, x, axis, kind="tp_sum"):
        return axis_sum(x.contiguous().clone(), axis, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class AllSum(torch.autograd.Function):
    """A sum over ``axis`` whose result each rank uses for its own slice
    (the Mamba-2 gated norm's sum of squares, each rank normalising its
    heads' channels): ``apply(x, axis, kind)`` sums the ranks' partial
    ``x``, and the backward sums the ranks' gradients of the result too,
    since each rank's holds only its own slice's share; both counted
    under ``kind``.  ``SumOut``'s pass-through backward would keep only
    the rank's own share."""

    @staticmethod
    def forward(ctx, x, axis, kind="norm_sum"):
        ctx.axis, ctx.kind = axis, kind
        return axis_sum(x.contiguous().clone(), axis, kind)

    @staticmethod
    def backward(ctx, g):
        return (axis_sum(g.contiguous().clone(), ctx.axis, ctx.kind), None,
                None)


def greedy(logits: torch.Tensor, axis: ModelAxis, vocab: int
           ) -> torch.Tensor:
    """The greedy token of each row of ``logits`` (..., V_local), this
    rank's slice of a vocab of ``vocab`` (the whole where V_local is
    ``vocab``): the max over the slice, then the (value, global index)
    pairs all-gathered over ``axis`` (counted as "argmax"), the largest
    value kept and, among equal ones, the lowest index, as
    ``torch.argmax`` and ``jnp.argmax`` keep the first."""
    idx = torch.argmax(logits, dim=-1)
    if logits.shape[-1] == vocab:
        return idx
    start, _ = axis.part(vocab)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    # float64 holds every fp32 value and every index of a vocab exactly
    pair = torch.stack([val.to(torch.float64),
                        (idx + start).to(torch.float64)])
    both = _all_gather(pair[None], 0, axis.group(), axis.size, "argmax")
    best = torch.argmax(both[:, 0], dim=0)          # the lowest rank's max
    return torch.gather(both[:, 1], 0, best[None])[0].to(idx.dtype)


def gather_heads(q: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Every rank's query heads of a decode step: this rank's (B, T, H/tp,
    D) all-gathered along dim 2 over ``axis`` (counted as "cp_q"), the
    heads in global order."""
    return _all_gather(q, 2, axis.group(), axis.size, "cp_q")


def merge_partials(o: torch.Tensor, lse: torch.Tensor, axis: ModelAxis,
                   heads: int | None = None) -> torch.Tensor:
    """Context-parallel decode's merge over ``axis``.  ``o`` (B, T, Hq, D)
    is this rank's attention of every query head over its part of the
    cache's positions, ``lse`` (B, Hq, T) its rows' log-sum-exps (-inf
    where its part holds no key a row sees).  The ranks' (o, lse) are
    all-gathered in one call (counted as "cp_merge") and this rank keeps
    its ``heads`` query heads (piece ``index`` of ``size``; every head
    where ``heads`` is None): o = sum_r exp(lse_r - m) o_r / sum_r
    exp(lse_r - m), m the ranks' largest lse, summed in rank order in
    fp32 (fp64 for fp64 ``o``) and cast once to o's dtype.  A part with
    lse -inf drops out; a row that no part sees gives 0."""
    ct = torch.promote_types(o.dtype, torch.float32)
    D = o.shape[-1]
    mine = torch.cat([o.transpose(1, 2).to(ct),
                      lse.to(ct)[..., None]], dim=-1)     # (B, Hq, T, D + 1)
    every = _all_gather(mine[None], 0, axis.group(), axis.size, "cp_merge")
    if heads is not None:
        every = every.narrow(2, axis.index * heads, heads)
    parts, lses = every[..., :D], every[..., D]
    m = lses.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)                                # 0 where -inf
    num = torch.sum(w[..., None] * parts, dim=0)
    den = torch.sum(w, dim=0)[..., None]
    out = num / torch.where(den > 0, den, torch.ones_like(den))
    return out.transpose(1, 2).to(o.dtype)


@dataclass(frozen=True)
class Rows:
    """The rows of a serving batch that this rank serves: ``count`` rows
    from ``start``, split over the dp ``axes`` (``()`` where every rank
    serves all of them)."""
    start: int
    count: int
    axes: tuple[str, ...] = ()

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch leaf ``x`` (a view)."""
        return x.narrow(0, self.start, self.count)


def serve_rows(mesh, rules, B: int) -> Rows:
    """The rows of a batch of ``B`` this rank serves: where the cache
    specs put "batch" over the dp axes (B a multiple of their ranks), its
    contiguous piece in dp order, else all of them (the spec replicates
    the rows, and every dp rank serves the whole batch)."""
    if mesh is None:
        return Rows(0, B)
    axes = tuple(a for a in axes_of(rules.resolve("batch", dims=(B,))[0])
                 if mesh.shape.get(a, 1) > 1)
    dp = math.prod(mesh.shape[a] for a in axes)
    if not axes or B % dp:
        return Rows(0, B)
    n = B // dp
    return Rows(dp_index(mesh, axes) * n, n, axes)


def gather_rows(t: torch.Tensor, rows: Rows, mesh, kind: str = "rows"
                ) -> torch.Tensor:
    """The whole batch's ``t`` (dim 0) from each rank's rows, all-gathered
    over ``rows.axes`` (the minor axis first; counted under ``kind``);
    ``t`` itself where the rows are not split."""
    for a in reversed(rows.axes):
        t = _all_gather(t, 0, mesh.group(a), mesh.shape[a], kind)
    return t


def serve_shard(x: torch.Tensor, layout, mesh) -> torch.Tensor:
    """This rank's serving copy of the whole leaf ``x`` under ``layout``
    (``models.common.ServingLayout``): its slice of the layout's spec,
    then, where the layout names columns, those of the last dim."""
    x = x[Sharding(mesh, layout.spec).slices(x.shape)]
    if layout.columns is not None:
        x = x.index_select(-1, torch.tensor(layout.columns,
                                            device=x.device))
    return x


def init_serving(defs, gen: torch.Generator, device, layouts, mesh):
    """Each leaf of ``defs`` drawn whole from ``gen`` in the one-process
    order (``tree_defs_init``), this rank's serving copy kept
    (``serve_shard``): the one-process parameters, each whole over the
    fsdp axes (gathered once, at load) and cut over "model"."""
    from repro_torch.models.common import init_leaf, is_def

    def build(d, lay):
        if is_def(d):
            return serve_shard(init_leaf(gen, d, device), lay, mesh).clone()
        return {k: build(d[k], lay[k]) for k in sorted(d)}
    return build(defs, layouts)


def serve_tree(tree, layouts, mesh):
    """``serve_shard`` of each leaf of a whole tree (copies)."""
    if isinstance(tree, dict):
        return {k: serve_tree(v, layouts[k], mesh) for k, v in tree.items()}
    return serve_shard(tree, layouts, mesh).clone()
