"""RA005 — exception hygiene: no silent broad catches.

A copy of the JAX package's pass (pure AST, framework-free), so it gives
that pass's diagnostics line for line.

A ``try: ... except Exception: <swallow>`` around a numeric kernel is
how implementation drift goes unnoticed: the fallback path keeps the
benchmark green while the primary path has been broken for weeks (the
"silent implementation drift" threat the runtime-prediction survey
calls out).  The rule:

* a **bare** ``except:`` is always flagged (it swallows
  ``KeyboardInterrupt`` / ``SystemExit`` too);
* ``except BaseException`` is flagged unless the handler re-raises;
* ``except Exception`` (alone or in a tuple) is flagged unless the
  handler either re-raises or *names* the exception (``as e``) and
  actually uses that name — record-and-continue semantics are fine,
  silent discards are not.

The real fix is usually narrowing to the concrete types the guarded
code can raise (see ``checkpoint/store.py`` / ``core/baselines.py`` /
``launch/dryrun.py`` for the reference fixes); naming-and-logging is
the floor, not the goal.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..core import Diagnostic, LintPass, Project, SourceFile, register
from .common import dotted

_BROAD = {"Exception"}
_FATAL = {"BaseException"}


def _caught_names(h: ast.ExceptHandler) -> set[str]:
    t = h.type
    nodes = t.elts if isinstance(t, ast.Tuple) else ([t] if t else [])
    out = set()
    for n in nodes:
        d = dotted(n)
        if d:
            out.add(d.split(".")[-1])
    return out


def _reraises(h: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(h))


def _uses_bound_name(h: ast.ExceptHandler) -> bool:
    if not h.name:
        return False
    return any(isinstance(n, ast.Name) and n.id == h.name
               and isinstance(n.ctx, ast.Load)
               for stmt in h.body for n in ast.walk(stmt))


@register
class ExceptionHygienePass(LintPass):
    rule = "RA005"
    doc = ("exception hygiene: no bare/broad `except Exception` without "
           "re-raise or a named-and-used cause")

    def check(self, src: SourceFile, project: Project) -> Iterable[Diagnostic]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            caught = _caught_names(node)
            if node.type is None:
                yield self.diag(
                    src, node,
                    "bare `except:` swallows KeyboardInterrupt/SystemExit "
                    "— catch the concrete types this block can raise")
            elif caught & _FATAL and not _reraises(node):
                yield self.diag(
                    src, node,
                    "`except BaseException` without re-raise — nothing "
                    "below Exception should be handled here")
            elif caught & _BROAD and not _reraises(node) \
                    and not _uses_bound_name(node):
                yield self.diag(
                    src, node,
                    "broad `except Exception` silently discards the cause "
                    "— narrow to the concrete types, or at minimum bind "
                    "(`as e`) and record it")
