"""The host syncs a call makes on the card, held to the port's RA001.

``trace_syncs(fn)`` runs ``fn()`` under
``torch.cuda.set_sync_debug_mode("warn")``, PyTorch's own sync detector,
and records every synchronizing call it makes (a device-to-host copy, a
blocking host-to-device copy, ``.item()``, ``synchronize``, ``nonzero``)
at the innermost frame of the port on the stack: a warning raised inside
one of torch's Python wrappers points into torch, so the whole stack is
walked.  ``missed(sites, index)`` is the gate: a sync in a function that
RA001 treats as traced (``lint.passes.jit_purity.traced_functions``), at
a line where the linter neither reports RA001 nor finds a justified
``# repro_torch: ignore[RA001]``, is a real sync on a traced path that
the static pass missed.

The mode needs a CUDA build of torch; the detector does not look inside a
graph capture, where a sync is an error anyway.
"""
from __future__ import annotations

import time
import traceback
import warnings
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .lint import SourceFile, run_paths
from .lint.passes.jit_purity import function_at, traced_functions

PORT = Path(__file__).resolve().parents[1]
ROOT = PORT.parents[1]
#: the warning torch gives for each synchronizing call in mode "warn"
SYNC_MESSAGE = "called a synchronizing CUDA operation"


@dataclass(frozen=True)
class SyncSite:
    """Where a synchronizing call came from: the innermost frame of the
    port on the stack, else the innermost frame of the checkout (a
    script's own call), else the innermost frame."""
    path: str
    line: int
    function: str
    in_port: bool

    def __str__(self) -> str:
        return f"{self.path}:{self.line} ({self.function})"


def _relative(filename: str) -> Path | None:
    try:
        return Path(filename).resolve().relative_to(ROOT)
    except ValueError:
        return None


def _site(stack: list[traceback.FrameSummary]) -> SyncSite:
    port = PORT.relative_to(ROOT)
    here = Path(__file__).resolve().relative_to(ROOT)
    ours = None
    for fr in reversed(stack):
        rel = _relative(fr.filename)
        if rel is None or rel == here:      # not trace_syncs's own frame
            continue
        if rel.is_relative_to(port):
            return SyncSite(rel.as_posix(), fr.lineno, fr.name, True)
        ours = ours or SyncSite(rel.as_posix(), fr.lineno, fr.name, False)
    fr = stack[-1]
    return ours or SyncSite(fr.filename, fr.lineno, fr.name, False)


def trace_syncs(fn):
    """``(fn(), sites)``: ``fn()`` run with sync debug mode "warn", and one
    :class:`SyncSite` per synchronizing call it made, in call order.  The
    sync warnings are recorded, not shown; other warnings pass through.
    The mode is set back to 0 whatever happens."""
    sites: list[SyncSite] = []
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
        shown = warnings.showwarning

        def hook(message, category, filename, lineno, file=None, line=None):
            if SYNC_MESSAGE in str(message):
                sites.append(_site([fr for fr in traceback.extract_stack()
                                    if fr.filename != warnings.__file__][:-1]))
            else:
                shown(message, category, filename, lineno, file, line)
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sites


@dataclass
class SyncLog:
    """Sync traces by label: :meth:`run` traces one call and keeps its
    sites, the ticks or steps it covered and its seconds."""
    runs: dict[str, dict] = field(default_factory=dict)

    def run(self, label: str, fn, per: int = 1):
        t0 = time.perf_counter()
        out, sites = trace_syncs(fn)
        self.runs[label] = {"sites": sites, "per": per,
                            "seconds": time.perf_counter() - t0}
        return out

    def summary(self) -> dict[str, dict]:
        """Per label: syncs in all, per tick or step, and the distinct
        sites with their counts (most first)."""
        return {label: {
            "syncs": len(r["sites"]), "per": r["per"],
            "syncs_per": len(r["sites"]) / r["per"],
            "seconds": r["seconds"],
            "sites": {str(s): n for s, n in
                      Counter(r["sites"]).most_common()}}
            for label, r in self.runs.items()}


@dataclass
class LintIndex:
    """RA001's view of the port: each file (by path relative to the
    checkout), its traced functions, and the lines RA001 still reports."""
    files: dict[str, SourceFile]
    traced: dict[str, dict[str, str]]
    reported: set[tuple[str, int]]


def lint_index(paths=(PORT,)) -> LintIndex:
    diags, project = run_paths(paths, select=["RA001"])

    def rel(p: str) -> str:
        return (_relative(p) or Path(p)).as_posix()
    files = {rel(f.path): f for f in project.files}
    return LintIndex(files=files,
                     traced={p: traced_functions(f) for p, f in files.items()},
                     reported={(rel(d.path), d.line) for d in diags})


def missed(sites, index: LintIndex) -> list[tuple[SyncSite, str]]:
    """The sites the static pass missed, each with its traced function:
    in a function RA001 treats as traced, at a line where the linter
    neither reports RA001 nor finds a justified ``ignore[RA001]`` (on the
    line or the line above)."""
    out = []
    for s in dict.fromkeys(sites):
        src = index.files.get(s.path)
        fn = function_at(src, s.line) if src is not None else None
        if fn is None or fn not in index.traced[s.path]:
            continue
        if (s.path, s.line) in index.reported or any(
                sup.justified and "RA001" in sup.rules
                and sup.line in (s.line, s.line - 1)
                for sup in src.suppressions):
            continue
        out.append((s, fn))
    return out
