"""Small AST helpers shared by the concrete passes."""
from __future__ import annotations

import ast

__all__ = ["dotted", "const_str", "call_name", "func_params",
           "assigned_names", "literal_dtype", "cast_dtypes", "operand_cast"]


def dotted(node: ast.AST) -> str | None:
    """``torch.cuda.graph`` -> "torch.cuda.graph" for Name/Attribute chains,
    None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted(node.func)


def func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
                ) -> set[str]:
    a = fn.args
    names = {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def assigned_names(body: list[ast.stmt]) -> set[str]:
    """Every plain name bound anywhere inside ``body`` (assignments,
    for-targets, with-as, walrus, nested defs, imports)."""
    out: set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, n: ast.Name):
            if isinstance(n.ctx, (ast.Store, ast.Del)):
                out.add(n.id)

        def visit_FunctionDef(self, n):
            out.add(n.name)
            self.generic_visit(n)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, n):
            out.add(n.name)
            self.generic_visit(n)

        def visit_alias(self, n: ast.alias):
            out.add((n.asname or n.name).split(".")[0])

        def visit_NamedExpr(self, n):
            self.generic_visit(n)

    v = V()
    for stmt in body:
        v.visit(stmt)
    return out


#: dotted names that count as a literal dtype mention: the JAX package's
#: numpy entries and torch's float dtypes under each of their names
_DTYPE_LITERALS = {
    "np.float32": "float32", "numpy.float32": "float32",
    "np.float16": "float16", "np.float64": "float64",
    "torch.float32": "float32", "torch.float": "float32",
    "torch.float16": "float16", "torch.half": "float16",
    "torch.bfloat16": "bfloat16",
    "torch.float64": "float64", "torch.double": "float64",
}

#: tensor methods that cast to a fixed dtype (``x.float()``, ...)
_CAST_METHODS = {"float": "float32", "half": "float16",
                 "bfloat16": "bfloat16", "double": "float64"}

#: calls whose dtype-position argument is checked (positional index of
#: the dtype arg, or None where dtype is keyword-only); every one of them
#: is also read for a ``dtype=`` keyword
_CAST_CALLS = {"astype": 0, "asarray": 1, "as_tensor": 1, "array": 1,
               "tensor": None, "zeros": 1, "ones": 1, "full": 2,
               "empty": 1, "arange": None, "zeros_like": 1, "ones_like": 1,
               "full_like": 2, "empty_like": 1}


def literal_dtype(node: ast.AST) -> str | None:
    """"float32" for a literal float-dtype attribute (``torch.float32``,
    ``torch.half``, ``np.float32``, ...), else None."""
    d = dotted(node)
    return _DTYPE_LITERALS.get(d) if d else None


def cast_dtypes(call: ast.Call) -> list[tuple[ast.AST, str]]:
    """(node, dtype) for every literal float dtype a call casts to or
    builds with: the dtype position or ``dtype=`` of a construction
    (``torch.zeros(..., dtype=torch.float32)``, ``np.asarray(x,
    np.float32)``), ``.to(<literal>)`` / ``.to(dtype=<literal>)``,
    ``.float()`` / ``.half()`` / ``.bfloat16()`` / ``.double()``, and
    ``np.float32(x)`` used as a constructor."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None)
    out: list[tuple[ast.AST, str]] = []
    if isinstance(fn, ast.Attribute) and name in _CAST_METHODS \
            and not call.args and not call.keywords:
        out.append((call, _CAST_METHODS[name]))
    elif name in _CAST_CALLS or (isinstance(fn, ast.Attribute)
                                 and name == "to"):
        pos = _CAST_CALLS.get(name)
        cands = (list(call.args) if name == "to" else
                 [call.args[pos]] if pos is not None and pos < len(call.args)
                 else [])
        cands += [kw.value for kw in call.keywords if kw.arg == "dtype"]
        for c in cands:
            dt = literal_dtype(c)
            if dt:
                out.append((c, dt))
    dt = literal_dtype(fn)
    if dt and call.args:
        out.append((fn, dt))
    return out


def operand_cast(arg: ast.AST) -> str | None:
    """Literal dtype when a product's operand is a cast at its top level
    (``x.float()``, ``x.to(torch.bfloat16)``, ``x.astype(np.float32)``),
    else None; a cast through a variable (``x.to(dt)``) is not literal."""
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr in ({"astype", "to"} | set(_CAST_METHODS)):
        found = cast_dtypes(arg)
        return found[-1][1] if found else None
    return None
