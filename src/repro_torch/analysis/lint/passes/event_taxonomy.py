"""RA003 — closure of the trace-event taxonomy.

A copy of the JAX package's pass (pure AST, framework-free), so it gives
that pass's diagnostics line for line.  ``repro_torch.obs.trace`` deliberately keeps :data:`EVENT_KINDS` a *closed*
frozenset: every consumer (the Chrome exporter's lane routing, the
calibration reader, the report roll-up) switches on the kind string,
so an emit site inventing a kind silently falls out of every view —
``EventLog.emit`` only warns at runtime, and only if that code path
runs under a tracer in some test.  This pass proves the closure
statically, in both directions:

* every ``*.emit(...)`` call site whose kind is a string literal must
  name a registered kind;
* a kind whose value cannot be resolved statically (a variable) is
  flagged too — an unprovable emit site is a hole in the closure;
* every registered kind must be emitted somewhere in the linted tree,
  or listed in an optional ``RESERVED_EVENT_KINDS`` set next to the
  taxonomy (documented-but-not-yet-emitted kinds).

Cross-file by nature: the taxonomy lives in one module, the emit sites
in others, so the work happens in :meth:`finalize`.  When no
``EVENT_KINDS`` definition is in the linted file set the pass is inert
(linting a subtree that doesn't contain the taxonomy is not an error).
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..core import Diagnostic, LintPass, Project, SourceFile, register
from .common import const_str, dotted

TAXONOMY_NAME = "EVENT_KINDS"
RESERVED_NAME = "RESERVED_EVENT_KINDS"


def _set_literal(node: ast.AST) -> set[str] | None:
    """String elements of ``frozenset({...})`` / ``{...}`` / ``[...]``."""
    if isinstance(node, ast.Call) and node.args:
        return _set_literal(node.args[0])
    if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
        out = set()
        for el in node.elts:
            s = const_str(el)
            if s is None:
                return None
            out.add(s)
        return out
    return None


def _find_taxonomy(src: SourceFile, name: str
                   ) -> tuple[set[str], int] | None:
    for node in src.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                kinds = _set_literal(node.value)
                if kinds is not None:
                    return kinds, node.lineno
    return None


def _emit_kind(call: ast.Call) -> tuple[str | None, bool]:
    """(kind, resolvable) of an ``emit`` call: the first positional arg
    or the ``kind=`` keyword."""
    for kw in call.keywords:
        if kw.arg == "kind":
            s = const_str(kw.value)
            return s, s is not None
    if call.args:
        s = const_str(call.args[0])
        return s, s is not None
    return None, False


@register
class EventTaxonomyPass(LintPass):
    rule = "RA003"
    doc = ("event-taxonomy closure: every emit() kind is registered in "
           "EVENT_KINDS and every registered kind is emitted (or reserved)")

    def finalize(self, project: Project) -> Iterable[Diagnostic]:
        taxonomy: set[str] | None = None
        reserved: set[str] = set()
        tax_src: SourceFile | None = None
        tax_line = 0
        for src in project.files:
            found = _find_taxonomy(src, TAXONOMY_NAME)
            if found is not None:
                taxonomy, tax_line = found
                tax_src = src
                res = _find_taxonomy(src, RESERVED_NAME)
                if res is not None:
                    reserved = res[0]
                break
        if taxonomy is None:
            return

        emitted: set[str] = set()
        for src in project.files:
            for node in ast.walk(src.tree):
                is_emit = (isinstance(node, ast.Call)
                           and isinstance(node.func, ast.Attribute)
                           and node.func.attr == "emit")
                # direct construction of a typed event IS an emission
                # (EventLog.span appends Event(kind="span") itself)
                is_event_ctor = (isinstance(node, ast.Call)
                                 and (dotted(node.func) or "").split(".")[-1]
                                 == "Event"
                                 and any(kw.arg == "kind"
                                         for kw in node.keywords))
                if not (is_emit or is_event_ctor):
                    continue
                kind, resolvable = _emit_kind(node)
                if not resolvable:
                    if is_event_ctor:
                        # the dispatcher (EventLog.emit) forwarding its
                        # own `kind` parameter into the Event record is
                        # plumbing, not an emit site
                        continue
                    yield self.diag(
                        src, node,
                        "emit() kind is not a string literal — the "
                        "taxonomy closure cannot be proven for this site; "
                        "pass the kind inline")
                    continue
                emitted.add(kind)
                if kind not in taxonomy:
                    yield self.diag(
                        src, node,
                        f"emit() kind {kind!r} is not in the closed "
                        f"{TAXONOMY_NAME} taxonomy — register it (and its "
                        "consumer routing) or fix the typo")

        for kind in sorted(taxonomy - emitted - reserved):
            yield self.diag(
                tax_src, tax_line,
                f"taxonomy kind {kind!r} is never emitted in the linted "
                f"tree and not listed in {RESERVED_NAME} — dead taxonomy "
                "entries hide typos at emit sites")
