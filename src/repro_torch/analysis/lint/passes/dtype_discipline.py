"""RA002 — dtype discipline in the estimator plane and model products.

The port of ``repro.analysis.lint.passes.dtype_discipline``: the same two
bug classes, read in torch's spelling.

* the ``blr.predict`` class: a hard-coded 32-bit cast on the prediction
  path silently downcasts the float64 posterior, costing ~7 decimal
  digits of agreement.  The port's numeric dtype follows one policy
  helper, ``_default_dtype`` in ``repro_torch/core/blr.py`` (float64
  unless the caller passes another dtype), so in the estimator-plane
  modules any *literal* float32 / float16 / bf16 in a cast or a
  construction is flagged: ``torch.zeros(..., dtype=torch.float32)``,
  ``x.to(torch.float32)``, ``x.float()``, ``x.half()``, ``np.float32(x)``,
  ``x.astype(np.float32)``.  float64 stays exempt, as in the JAX package;
* the zamba2 conv class: the decode path ran an fp32 product while
  prefill ran the same product in bf16, and the drift compounded past
  tolerance.  Statically we catch the call-site-visible version: a
  ``torch.einsum`` / ``torch.matmul`` / ``torch.bmm`` in ``models/``
  whose operands carry *different* literal casts at their top level (or a
  literal cast on some operands and none on others).  A cast through a
  variable (``.to(dt)``) is not literal and is not flagged.  torch has no
  ``preferred_element_type``: the accumulator is the operands' type, so
  unlike the JAX package's pass there is no keyword that sanctions a
  mixed product — cast the operands alike.

Scoping matters: the kernels and the optimiser legitimately pin fp32
accumulators, so the literal-dtype check only applies to the
estimator-plane modules in :data:`POLICY_MODULES`, and the product check
only to ``models/``.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..core import Diagnostic, LintPass, Project, SourceFile, register
from .common import cast_dtypes, const_str, dotted, operand_cast

#: path fragments of modules under the ``_default_dtype`` policy (the
#: numeric estimator plane)
POLICY_MODULES = ("core/", "online/", "sched/")

#: path fragment for the mixed-product check
MODEL_MODULES = ("models/",)

#: the products whose operands are checked
_PRODUCTS = ("torch.einsum", "torch.matmul", "torch.bmm")


@register
class DtypeDisciplinePass(LintPass):
    rule = "RA002"
    doc = ("dtype discipline: literal float32/float16/bf16 casts in "
           "estimator-plane modules (use blr._default_dtype), products in "
           "models/ whose operands carry different literal casts")

    def check(self, src: SourceFile, project: Project) -> Iterable[Diagnostic]:
        path = src.path.replace("\\", "/")
        if any(m in path for m in POLICY_MODULES):
            yield from self._check_policy(src)
        if any(m in path for m in MODEL_MODULES):
            yield from self._check_products(src)

    def _check_policy(self, src: SourceFile) -> Iterable[Diagnostic]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            for dt_node, dt in cast_dtypes(node):
                if dt == "float64":
                    # float64 is the policy's own width (and the width of
                    # every serialisation path)
                    continue
                yield self.diag(
                    src, dt_node,
                    f"literal {dt} cast in an estimator-plane module — "
                    "the numeric dtype follows the caller's dtype= "
                    "argument; use blr._default_dtype so float64 runs stay "
                    "float64 (the blr.predict bug class)")

    def _check_products(self, src: SourceFile) -> Iterable[Diagnostic]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or \
                    dotted(node.func) not in _PRODUCTS:
                continue
            operands = [a for a in node.args if const_str(a) is None]
            casts = [operand_cast(a) for a in operands]
            literal = [c for c in casts if c]
            if not literal:
                continue
            if len(set(literal)) > 1 or len(literal) != len(operands):
                got = [c or "<uncast>" for c in casts]
                yield self.diag(
                    src, node,
                    f"{dotted(node.func)} mixes operand dtypes {got} — cast "
                    "every operand alike; torch accumulates in the operands' "
                    "type (the zamba2 fp32/bf16 conv mismatch class)")
