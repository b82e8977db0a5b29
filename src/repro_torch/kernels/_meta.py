"""The kernels' route on ``meta`` tensors: shapes and counts, no data.

The dry run (``repro_torch.launch.dryrun``) traces a step on ``meta``
tensors, which hold no data.  There ``ops.mha`` and ``ops.ssd`` run
neither the CUDA kernel nor its plain version: they make their outputs
(shapes and dtypes only) and record the call with ``kernel_call``, an
operator that does nothing itself and that
``repro_torch.analysis.step_stats`` reads as one kernel launch: its
inputs read once, its outputs written once, and the FLOPs that the plain
version's products would take on the same shapes.
"""
from __future__ import annotations

import torch

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("kernel_call(Tensor[] inputs, Tensor[] outputs, float flops, "
            "str name) -> ()")
_LIB.impl("kernel_call", lambda inputs, outputs, flops, name: None, "Meta")

#: kernel_call(inputs, outputs, flops, name): defined for meta tensors only
kernel_call = torch.ops.repro_torch.kernel_call.default
