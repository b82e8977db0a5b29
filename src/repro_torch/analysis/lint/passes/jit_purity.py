"""RA001 — host syncs and host-side effects on captured and traced paths.

The port of ``repro.analysis.lint.passes.jit_purity``.  In the JAX
package a traced function's Python body runs once, under ``jax.jit``;
here the places where code runs without its Python re-running, or where
a host sync stalls the device's queue, are torch's:

* every function called inside a ``with torch.cuda.graph(...)`` block
  (``self.<method>`` resolves to the enclosing class's def): it is
  captured once and replayed, so a host read-back there is an error at
  capture and a host-side effect happens once, not per replay;
* defs passed to ``torch.cuda.make_graphed_callables``,
  ``torch.func.vmap`` / ``torch.vmap``, ``torch.func.grad``,
  ``torch.compile`` (or decorated with it) and
  ``torch.utils.checkpoint.checkpoint``;
* the ``forward`` / ``backward`` of every ``torch.autograd.Function``
  subclass;
* the seed list (:data:`_SEED_TRACED`): the fused tick and its fleet
  twins, traced by contract — they are what a CUDA graph replays, and the
  whole point of the tick is that its device work never waits on the
  host;
* transitively, within the same file, any function they call by name
  (or, from a method, as ``self.<method>``).

Inside those we flag:

* ``print(...)`` calls;
* host syncs: ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or an
  event, ``.nonzero()`` / ``torch.nonzero``, and one-argument
  ``torch.where`` (the last two size their output from the data);
* ``float(x)`` / ``int(x)`` / ``bool(x)`` / ``complex(x)`` where ``x`` is
  (rooted at) a parameter of the traced function — a sync when ``x`` is
  a tensor.  Static reads (``.shape`` / ``.ndim`` / ``.size`` /
  ``.dtype`` / ``len``) are exempt, and so is a local intermediate;
* mutation of captured state: mutator-method calls (``.append`` /
  ``.update`` / ...) and attribute stores whose receiver is a free
  variable or ``self``.

Unlike the JAX package's pass, a subscript store is *not* flagged: an
in-place store into a tensor (``ws[:, :slot] = ...``, ``dst.copy_``) is
recorded by a graph like any other kernel, and updating the state's
leaves in place is the port's design (``core/tick.py``'s counterpart of
buffer donation).

:func:`traced_functions` exposes the traced set of a file (qualified name
-> why), and :func:`function_at` the function a line lies in; the card's
sync trace (``chip_smoke.py``, phase 15) holds the syncs it sees to them.
"""
from __future__ import annotations

import ast
from typing import Iterable

from ..core import Diagnostic, LintPass, Project, SourceFile, register
from .common import assigned_names, dotted, func_params

#: callables whose function-valued arguments become traced
#: (argument positions holding functions)
_TRACE_ENTRIES: dict[str, tuple[int, ...]] = {
    "torch.cuda.make_graphed_callables": (0,),
    "torch.func.vmap": (0,), "torch.vmap": (0,), "vmap": (0,),
    "torch.func.grad": (0,),
    "torch.compile": (0,),
    "torch.utils.checkpoint.checkpoint": (0,), "checkpoint": (0,),
}

#: decorator spellings that make the decorated def a trace root
_TRACE_DECOS = {"torch.compile"}

#: context managers whose block is captured into a CUDA graph
_GRAPH_BLOCKS = {"torch.cuda.graph"}

#: base classes whose ``forward`` / ``backward`` run inside autograd
_AUTOGRAD_BASES = {"torch.autograd.Function", "autograd.Function",
                   "Function"}

#: defs that are traced by CONTRACT: the fused tick (``core/tick.py``) and
#: its fleet twins (``online/fleet.py``), the port's names for the JAX
#: package's seed list.  ``TickEngine`` captures ``_tick_core`` into a
#: CUDA graph, and the seed list keeps the family covered wherever the
#: capture happens to live.
_SEED_TRACED = {"tick_step", "_tick_core", "_stacked_tick_core",
                "_fold_predict", "predict_state", "fleet_tick_step",
                "fleet_predict"}

_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault",
             "pop", "popitem", "remove", "discard", "clear", "write",
             "appendleft", "sort", "reverse"}

_SYNC_BUILTINS = {"float", "int", "bool", "complex"}

_SHAPE_ATTRS = {"shape", "ndim", "size", "dtype"}

#: tensor methods that read a value back to the host
_READBACKS = {"item", "cpu", "numpy", "tolist"}

_FnNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _root_name(node: ast.AST) -> str | None:
    """Leftmost Name of an attribute/subscript chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """``partial(f, ...)`` -> ``f`` (one level)."""
    if isinstance(node, ast.Call) and \
            dotted(node.func) in ("partial", "functools.partial") and node.args:
        return node.args[0]
    return node


def _mentions_shape(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_ATTRS:
            return True
        if isinstance(sub, ast.Call) and dotted(sub.func) == "len":
            return True
    return False


class _Fn:
    """One function-ish node with the scope facts the checks need."""

    def __init__(self, node: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda):
        self.node = node
        self.params = func_params(node)
        body = node.body if isinstance(node.body, list) else [node.body]
        self.locals = self.params | assigned_names(body)


class _Scopes:
    """The defs of one file: by name, each one's qualified name, and the
    class each method belongs to."""

    def __init__(self, tree: ast.Module):
        self.by_name: dict[str, list[ast.AST]] = {}
        self.qualname: dict[ast.AST, str] = {}
        self.owner: dict[ast.AST, ast.ClassDef] = {}
        self.methods: dict[ast.ClassDef, dict[str, ast.AST]] = {}
        self._walk(tree, "", None)

    def _walk(self, node: ast.AST, prefix: str, cls: ast.ClassDef | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self.methods[child] = {}
                self._walk(child, f"{prefix}{child.name}.", child)
            elif isinstance(child, _FnNode):
                name = getattr(child, "name", f"<lambda>:{child.lineno}")
                self.qualname[child] = prefix + name
                if not isinstance(child, ast.Lambda):
                    self.by_name.setdefault(child.name, []).append(child)
                    if cls is not None:
                        self.owner[child] = cls
                        self.methods[cls][child.name] = child
                self._walk(child, f"{prefix}{name}.", None)
            else:
                self._walk(child, prefix, cls)

    def callees(self, call: ast.Call, caller: ast.AST | None) -> list[ast.AST]:
        """The same-file defs a call reaches: ``f(...)`` by name, and
        ``self.m(...)`` in a method as its class's ``m``."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return list(self.by_name.get(fn.id, ()))
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and fn.value.id == "self" and caller in self.owner:
            m = self.methods[self.owner[caller]].get(fn.attr)
            return [m] if m is not None else []
        return []

    def enclosing(self, node: ast.AST) -> ast.AST | None:
        """The innermost def (not lambda) whose lines hold ``node``."""
        best = None
        for d in self.qualname:
            if isinstance(d, ast.Lambda):
                continue
            if d.lineno <= node.lineno <= d.end_lineno and (
                    best is None or d.lineno >= best.lineno):
                best = d
        return best


def _traced(src: SourceFile) -> tuple[dict[ast.AST, str], _Scopes]:
    """Every traced function node of a file -> why it is traced."""
    scopes = _Scopes(src.tree)
    traced: dict[ast.AST, str] = {}

    def mark(fn_node: ast.AST, why: str) -> None:
        if isinstance(fn_node, _FnNode) and fn_node not in traced:
            traced[fn_node] = why

    def resolve(arg: ast.AST, why: str) -> None:
        arg = _unwrap_partial(arg)
        if isinstance(arg, ast.Lambda):
            mark(arg, why)
        elif isinstance(arg, ast.Name):
            for d in scopes.by_name.get(arg.id, ()):
                mark(d, why)

    for node in ast.walk(src.tree):
        # 1) decorator roots: @torch.compile, @torch.compile(...)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for deco in node.decorator_list:
                d = dotted(deco.func if isinstance(deco, ast.Call) else deco)
                if d in _TRACE_DECOS:
                    mark(node, f"decorated with {d}")
            # 1b) contract roots: the fused tick family, by name
            if node.name in _SEED_TRACED:
                mark(node, "fused-tick seed list")
        # 1c) autograd: forward/backward of a torch.autograd.Function
        elif isinstance(node, ast.ClassDef) and any(
                dotted(b) in _AUTOGRAD_BASES for b in node.bases):
            for name in ("forward", "backward"):
                m = scopes.methods[node].get(name)
                if m is not None:
                    mark(m, f"{name} of torch.autograd.Function "
                            f"{node.name}")
        # 2) call-site roots: torch.compile(f), checkpoint(f, ...), ...
        elif isinstance(node, ast.Call):
            entry = dotted(node.func)
            for pos in _TRACE_ENTRIES.get(entry or "", ()):
                if pos < len(node.args):
                    resolve(node.args[pos], f"passed to {entry}")
        # 2b) capture roots: what a torch.cuda.graph block calls
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and dotted(it.context_expr.func) in _GRAPH_BLOCKS
                for it in node.items):
            where = scopes.enclosing(node)
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        for d in scopes.callees(sub, where):
                            mark(d, "called in a torch.cuda.graph capture")

    # 3) same-file transitive closure over Name and self.<method> calls
    todo = list(traced)
    while todo:
        fn = todo.pop(0)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                for d in scopes.callees(sub, fn):
                    if d not in traced:
                        traced[d] = f"called from traced {scopes.qualname[fn]}"
                        todo.append(d)
    return traced, scopes


def traced_functions(src: SourceFile) -> dict[str, str]:
    """The functions of ``src`` that RA001 treats as traced: qualified
    name (``TickEngine._pack_out``, ``outer.body``) -> why."""
    traced, scopes = _traced(src)
    return {scopes.qualname[n]: why for n, why in traced.items()}


def function_at(src: SourceFile, line: int) -> str | None:
    """Qualified name of the innermost def of ``src`` that holds ``line``
    (None at module level)."""
    scopes = _Scopes(src.tree)
    probe = ast.Pass(lineno=line, col_offset=0)
    d = scopes.enclosing(probe)
    return scopes.qualname[d] if d is not None else None


@register
class JitPurityPass(LintPass):
    rule = "RA001"
    doc = ("trace-purity: host syncs (.item()/.cpu()/.tolist()/synchronize/"
           "nonzero/float()) and host-side effects (print, captured-state "
           "mutation) in graph-captured, autograd or seeded tick functions")

    def check(self, src: SourceFile, project: Project) -> Iterable[Diagnostic]:
        traced, scopes = _traced(src)
        for fn_node, why in traced.items():
            yield from self._check_traced(src, _Fn(fn_node),
                                          scopes.qualname[fn_node], why)

    # ------------------------------------------------------------------
    def _check_traced(self, src: SourceFile, fn: _Fn, qualname: str,
                      why: str) -> Iterable[Diagnostic]:
        ctx = f"in traced `{qualname}` ({why})"
        body = fn.node.body if isinstance(fn.node.body, list) else [fn.node.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    yield from self._check_call(src, fn, node, ctx)
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        if not isinstance(t, ast.Attribute):
                            continue
                        root = _root_name(t)
                        if root is not None and (
                                root == "self" or root not in fn.locals):
                            yield self.diag(
                                src, t,
                                f"attribute store on captured `{root}` "
                                f"{ctx} — host-side state set under capture "
                                "is set once, not per replay; return the "
                                "value instead")

    def _check_call(self, src: SourceFile, fn: _Fn, node: ast.Call,
                    ctx: str) -> Iterable[Diagnostic]:
        d = dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if d == "print":
            yield self.diag(src, node,
                            f"print() {ctx} runs once at capture, not per "
                            "replay, and reads values back — hoist it out "
                            "of the traced region")
        elif attr in _READBACKS and not (attr == "item" and node.args):
            yield self.diag(src, node,
                            f".{attr}() {ctx} is a host sync: the host waits "
                            "for the device's queue, and a capture fails — "
                            "return the tensor and read it back outside")
        elif attr == "synchronize":
            yield self.diag(src, node,
                            f"{d or '.synchronize'}() {ctx} waits for the "
                            "device — synchronise outside the traced region")
        elif attr == "nonzero" or (d == "torch.where" and len(node.args) == 1
                                   and not node.keywords):
            yield self.diag(src, node,
                            f"{d or '.nonzero'}() {ctx} sizes its output "
                            "from the data, a host sync — use a mask of "
                            "fixed shape (three-argument torch.where)")
        elif d in _SYNC_BUILTINS and len(node.args) == 1 and \
                not isinstance(node.args[0], ast.Constant):
            arg = node.args[0]
            root = _root_name(arg)
            if root in fn.params and not _mentions_shape(arg):
                yield self.diag(
                    src, node,
                    f"{d}() on traced parameter `{root}` {ctx} is a host "
                    "sync when it is a tensor — keep the value as a tensor")
        elif attr in _MUTATORS:
            root = _root_name(node.func.value)
            if root is not None and (root == "self" or root not in fn.locals):
                yield self.diag(
                    src, node,
                    f".{attr}() mutates captured `{root}` {ctx} — it "
                    "happens once at capture, not per replay (the SampleLog "
                    "bug class)")
