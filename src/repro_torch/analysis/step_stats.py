"""FLOP, byte and memory accounting of one step, counted op by op.

Counterpart of ``repro.analysis.hlo_stats``, which parses compiled XLA
HLO.  PyTorch has no HLO: ``step_stats`` is a ``TorchDispatchMode`` that
sees every operator the step dispatches, on any device (``meta`` for the
dry run, where the kernels take their counting route,
``kernels/_meta.py``).  It fills a ``StepStats`` with the fields of
``HloStats`` that the dry run reads:

* ``flops``: products only, as ``hlo_stats`` counts dots and
  convolutions.  Dots (``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the
  rest) and a convolution as ``torch.utils.flop_counter.FlopCounterMode``
  counts them (a convolution 2 x its output elements x its window x its
  input channels per group: ``hlo_stats``' 2 x window x output for the
  port's depthwise conv); each gradient of a convolution (input, weight)
  as its forward, where ``FlopCounterMode`` prices a grouped
  convolution's weight gradient as a dense one (~40x mamba2's depthwise
  conv); a kernel call the FLOPs it records.
* ``hbm_bytes_kernel_adj``: each tensor written once and read once a
  step (a view as what it covers), as the reference's kernel-adjusted
  view; a kernel call on the ``meta`` route counts only its inputs and
  outputs (on the CPU the plain version's ops count one by one).  Views
  move nothing.
* ``peak_bytes``: the most bytes that tensors made during the step held
  at once (storages freed are released through weakref finalizers);
  tensors that existed before (parameters, optimizer state, caches,
  the batch) are not counted.
* ``collective_bytes``: 0 on one card.  The census of collectives comes
  with more than one device (ROADMAP.md, Queue A item 6).
"""
from __future__ import annotations

import itertools
import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels._meta import kernel_call

aten = torch.ops.aten


@dataclass
class StepStats:
    flops: float = 0.0                   # products, per device
    hbm_bytes_kernel_adj: float = 0.0    # each tensor written and read once
    peak_bytes: int = 0                  # made during the step, at once
    collective_bytes: int = 0            # one card: none
    flops_by_op: dict = field(default_factory=dict)


def _convolution_backward(grad_out, x, w, *args, out_val=None,
                          **kwargs) -> int:
    """Each gradient asked for (input, weight) at its forward's cost, 2 x
    output elements x (input channels per group x window)."""
    output_mask = args[-1] if len(args) == 8 else kwargs["output_mask"]
    forward = 2 * math.prod(grad_out.shape) * math.prod(w.shape[1:])
    return forward * (bool(output_mask[0]) + bool(output_mask[1]))


_FORMULAS = {**flop_registry,
             aten.convolution_backward: _convolution_backward}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stats = StepStats()
        self._live = 0
        self._sid: dict[int, int] = {}   # storage address -> serial
        self._serial = itertools.count()
        self._read: set = set()
        self._written: set = set()

    def _release(self, addr: int, nbytes: int) -> None:
        self._sid.pop(addr, None)
        self._live -= nbytes

    def _storage(self, t: torch.Tensor, new: bool) -> int:
        """The serial of t's storage; a storage first seen as an output of
        a non-mutating op (``new``) was made by the step."""
        st = t.untyped_storage()
        addr = st._cdata
        sid = self._sid.get(addr)
        if sid is None:
            sid = self._sid[addr] = next(self._serial)
            nbytes = st.nbytes() if new else 0
            self._live += nbytes
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)
            weakref.finalize(st, self._release, addr, nbytes)
        return sid

    def _move(self, seen: set, t: torch.Tensor, sid: int) -> None:
        """Charge t's bytes the first time ``seen`` meets this view."""
        key = (sid, t.storage_offset(), tuple(t.shape), t.stride(), t.dtype)
        if key not in seen:
            seen.add(key)
            self.stats.hbm_bytes_kernel_adj += t.numel() * t.element_size()

    def _flops(self, name: str, n: float) -> None:
        if n:
            self.stats.flops += n
            by = self.stats.flops_by_op
            by[name] = by.get(name, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        formula = _FORMULAS.get(packet)
        if formula is None:
            # a composite op that reached the mode undecomposed (under
            # inference_mode): count its parts, as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func is kernel_call:
            inputs, outputs, flops, name = args
            for t in inputs:
                self._move(self._read, t, self._storage(t, False))
            for t in outputs:
                self._move(self._written, t, self._storage(t, False))
            self._flops(name, flops)
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_sids = [self._storage(t, False) for t in ins]
        mutates = func._schema.is_mutable
        moved = []
        for t in outs:
            sid = self._storage(t, new=not mutates)
            if mutates or sid not in in_sids:      # not a view of an input
                moved.append((t, sid))
        if moved:
            for t, sid in zip(ins, in_sids):
                self._move(self._read, t, sid)
            for t, sid in moved:
                self._move(self._written, t, sid)
        if formula is not None:
            self._flops(str(packet), formula(*args, **kwargs, out_val=out))
        return out


@contextmanager
def step_stats():
    """``with step_stats() as stats: step(...)``: ``stats`` (a
    ``StepStats``) counts what the block dispatches."""
    counter = _Counter()
    with counter:
        yield counter.stats
