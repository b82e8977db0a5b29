"""RA004 — schema round-trip completeness for to_dict/from_dict pairs.

A copy of the JAX package's pass (pure AST, framework-free), so it gives
that pass's diagnostics line for line.  The estimator checkpoint is at
schema v6 and every version since v2 has grown it; the failure mode
this pass encodes is the quiet one where a writer gains a key
(``to_dict``/``save`` serialises new state) and the matching reader
never consumes it — the save→load round trip "works",
silently dropping the new state, and nothing notices until a loaded
estimator predicts differently from the one that was saved.

For every scope (class body or module top level) that defines BOTH a
writer (``to_dict`` / ``to_json`` / ``save``) and its reader
(``from_dict`` / ``from_json`` / ``load``), the pass collects:

* **written keys** — string keys of every dict literal inside the
  writer, plus ``out["key"] = ...`` constant subscript stores;
* **consumed keys** — constant keys read anywhere in the reader:
  ``d["key"]``, ``d.get("key", ...)``, ``d.pop("key")``,
  ``"key" in d``, and ``**``-splat loads are approximated by
  constructor-keyword names (``cls(freq_reduction=...)`` consumes
  nothing by itself — the reader must name the key).

Every written key must be consumed under *some* guard.  Version guards
themselves must be **monotone**: a reader may test ``version >= N``
(or ``> N``) with ``1 <= N <= SCHEMA_VERSION`` — an equality or
upper-bound pin (``version == 3``, ``version < 4``) silently drops
data written by every *newer* schema and is flagged, as is a guard
constant outside the known version range.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..core import Diagnostic, LintPass, Project, SourceFile, register

WRITERS = ("to_dict", "to_json", "save")
READERS = ("from_dict", "from_json", "load")

#: keys a writer may stamp purely for humans / external tools; never
#: required to be read back (Chrome trace viewers read "traceEvents",
#: our own loaders don't re-consume pretty-printed duplicates)
_DOC_ONLY_KEYS = frozenset()


def _schema_version_bound(src: SourceFile) -> int | None:
    """Largest module-level ``*SCHEMA_VERSION*`` int constant, if any."""
    best = None
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            for t in node.targets:
                if isinstance(t, ast.Name) and "SCHEMA_VERSION" in t.id:
                    best = max(best or 0, node.value.value)
    return best


def _written_keys(fn: ast.AST) -> dict[str, int]:
    """{key: first line} of every constant string dict key / constant
    subscript store inside the writer."""
    out: dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.setdefault(k.value, k.lineno)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.slice, ast.Constant) and \
                        isinstance(t.slice.value, str):
                    out.setdefault(t.slice.value, t.lineno)
    return out


def _consumed_keys(fn: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.slice, ast.Constant) and \
                isinstance(node.slice.value, str) and \
                isinstance(node.ctx, ast.Load):
            out.add(node.slice.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "pop") and node.args:
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                out.add(a.value)
        elif isinstance(node, ast.Compare) and \
                any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            left = node.left
            if isinstance(left, ast.Constant) and isinstance(left.value, str):
                out.add(left.value)
    return out


def _version_guards(fn: ast.AST) -> Iterable[tuple[ast.Compare, ast.cmpop, int]]:
    """Compare nodes testing a ``version`` value against an int constant."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1:
            continue
        left, op, right = node.left, node.ops[0], node.comparators[0]

        def names_version(n: ast.AST) -> bool:
            if isinstance(n, ast.Name) and "version" in n.id.lower():
                return True
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "get" and n.args:
                a = n.args[0]
                return isinstance(a, ast.Constant) and a.value == "version"
            return False

        if names_version(left) and isinstance(right, ast.Constant) \
                and isinstance(right.value, int):
            yield node, op, right.value
        elif names_version(right) and isinstance(left, ast.Constant) \
                and isinstance(left.value, int):
            # mirrored form: 3 <= version — normalise the operator
            mirror = {ast.Lt: ast.Gt, ast.LtE: ast.GtE,
                      ast.Gt: ast.Lt, ast.GtE: ast.LtE}
            yield node, mirror.get(type(op), type(op))(), left.value


@register
class SchemaRoundTripPass(LintPass):
    rule = "RA004"
    doc = ("schema round-trip: every key a to_dict/save writer emits is "
           "consumed by the paired from_dict/load reader; version guards "
           "are monotone (>= N, N within the schema range)")

    def check(self, src: SourceFile, project: Project) -> Iterable[Diagnostic]:
        bound = _schema_version_bound(src)
        scopes: list[list[ast.stmt]] = [src.tree.body]
        scopes += [n.body for n in ast.walk(src.tree)
                   if isinstance(n, ast.ClassDef)]
        for body in scopes:
            fns = {n.name: n for n in body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            writers = [fns[w] for w in WRITERS if w in fns]
            readers = [fns[r] for r in READERS if r in fns]
            if not writers or not readers:
                continue
            consumed: set[str] = set()
            for r in readers:
                consumed |= _consumed_keys(r)
            for w in writers:
                for key, line in sorted(_written_keys(w).items(),
                                        key=lambda kv: kv[1]):
                    if key in consumed or key in _DOC_ONLY_KEYS:
                        continue
                    rnames = "/".join(r.name for r in readers)
                    yield self.diag(
                        src, line,
                        f"key {key!r} written by {w.name}() is never "
                        f"consumed by {rnames}() — the round trip silently "
                        "drops it; read it under a version guard or remove "
                        "the write")
            for r in readers:
                for node, op, const in _version_guards(r):
                    if isinstance(op, (ast.Eq, ast.NotEq, ast.Lt, ast.LtE)):
                        yield self.diag(
                            src, node,
                            f"version guard pins `{ast.unparse(node)}` — "
                            "non-monotone guards drop data from newer "
                            "schemas; use `version >= N` so every later "
                            "version satisfies earlier guards")
                    elif bound is not None and not (1 <= const <= bound):
                        yield self.diag(
                            src, node,
                            f"version guard constant {const} is outside "
                            f"the known schema range 1..{bound} — "
                            "unreachable guard (typo, or bump "
                            "SCHEMA_VERSION first)")
