"""The port's static analysis: the JAX package's lint pack (RA000–RA005)
with torch-aware RA001 (host syncs on captured and traced paths) and RA002
(dtype discipline).  Pure stdlib ``ast``; the catalogue is in
``docs/static_analysis_torch.md``.

Entry points:

>>> from repro_torch.analysis.lint import run_paths
>>> diagnostics, project = run_paths(["src/repro_torch"])

or the CLI: ``python scripts/lint_repro_torch.py``.
"""
from .core import (MARKER, Diagnostic, LintPass, Project, RULE_DOCS,
                   SourceFile, Suppression, parse_file, register,
                   registered_passes, run_paths, run_project)

__all__ = ["Diagnostic", "LintPass", "MARKER", "Project", "RULE_DOCS",
           "SourceFile", "Suppression", "parse_file", "register",
           "registered_passes", "run_paths", "run_project"]
