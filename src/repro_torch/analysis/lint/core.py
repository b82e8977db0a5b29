"""AST lint framework for the port's recurring bug classes (RA000–RA005).

Port of ``repro.analysis.lint.core``: the same machinery, rule ids and
meanings, with a registry of its own, so that a finding reads the same in
both packages:

* :class:`SourceFile` — a parsed file plus its suppression comments;
* :class:`LintPass` — the per-pass plugin base; concrete passes live in
  :mod:`repro_torch.analysis.lint.passes` and self-register via
  :func:`register`;
* :func:`run_paths` / :func:`run_project` — the runner: parse, run
  per-file checks, run cross-file finalizers, apply suppressions.

Suppression syntax (one line, on the flagged line or the line above)::

    # repro_torch: ignore[RA001] -- planned read-back, the host needs it
    x = noisy_thing()      # repro_torch: ignore[RA002, RA005] -- <why>

The marker differs from the JAX package's ``# repro:`` on purpose: that
package's linter also lints this one, and reads an unknown rule id in its
own marker as RA000, so the two markers must never be confused.  The
justification text after ``--`` is REQUIRED: a bare
``# repro_torch: ignore[RA001]`` still suppresses the named rule (so the
finding is not double-reported) but is itself flagged as **RA000** — an
unjustified suppression fails the lint gate just like the finding it
hides would have.  Unknown rule ids in the bracket are RA000 too.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

__all__ = [
    "Diagnostic", "Suppression", "SourceFile", "Project", "LintPass",
    "register", "registered_passes", "run_paths", "run_project",
    "parse_file", "RULE_DOCS", "MARKER",
]

#: rule id -> one-line description (filled by pass registration; RA000
#: is emitted by the runner itself, not a pass)
RULE_DOCS: dict[str, str] = {
    "RA000": "suppression hygiene: ignore[...] without justification "
             "text, or naming an unknown rule",
}

#: the comment marker this linter reads (the JAX package's is ``repro:``)
MARKER = "repro_torch:"

_IGNORE_RE = re.compile(
    r"#\s*repro_torch:\s*ignore\[([A-Za-z0-9_,\s]*)\]\s*(?:--|—)?\s*(.*)$")

#: minimum number of non-space characters for a justification to count
MIN_JUSTIFICATION = 8


@dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding: ``path:line:col: RULE message``."""
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclass(frozen=True)
class Suppression:
    """A parsed ``# repro_torch: ignore[...]`` comment."""
    line: int
    rules: frozenset[str]
    justification: str

    @property
    def justified(self) -> bool:
        return len(self.justification.replace(" ", "")) >= MIN_JUSTIFICATION


@dataclass
class SourceFile:
    """A parsed source file: AST, raw lines, and its suppressions."""
    path: str
    text: str
    tree: ast.Module
    suppressions: list[Suppression] = field(default_factory=list)

    @property
    def lines(self) -> list[str]:
        return self.text.splitlines()

    def suppressed_rules_at(self, line: int) -> set[str]:
        """Rules suppressed for ``line`` (comment on the line itself or
        the line directly above)."""
        out: set[str] = set()
        for s in self.suppressions:
            if s.line in (line, line - 1):
                out |= s.rules
        return out


@dataclass
class Project:
    """The full set of files one lint run sees (cross-file passes need
    the whole picture: RA003 reads the taxonomy from one file and the
    emit sites from others)."""
    files: list[SourceFile] = field(default_factory=list)

    def by_suffix(self, *suffixes: str) -> Iterator[SourceFile]:
        for f in self.files:
            if f.path.endswith(suffixes):
                yield f


class LintPass:
    """Base class for one lint rule.

    Subclasses set :attr:`rule` / :attr:`doc` and override either
    :meth:`check` (per-file; most rules) or :meth:`finalize`
    (cross-file; runs once after every file was parsed — RA003's
    taxonomy closure, for example, is a property of the *project*, not
    of any single file).
    """
    rule: str = "RA???"
    doc: str = ""

    def check(self, src: SourceFile, project: Project) -> Iterable[Diagnostic]:
        return ()

    def finalize(self, project: Project) -> Iterable[Diagnostic]:
        return ()

    # -- helpers shared by the concrete passes ---------------------------
    def diag(self, src_or_path, node_or_line, message: str) -> Diagnostic:
        path = src_or_path.path if isinstance(src_or_path, SourceFile) \
            else str(src_or_path)
        if isinstance(node_or_line, ast.AST):
            line = getattr(node_or_line, "lineno", 0)
            col = getattr(node_or_line, "col_offset", 0)
        else:
            line, col = int(node_or_line), 0
        return Diagnostic(path=path, line=line, col=col,
                          rule=self.rule, message=message)


_REGISTRY: dict[str, type[LintPass]] = {}


def register(cls: type[LintPass]) -> type[LintPass]:
    """Class decorator: add a pass to the global registry (keyed by its
    rule id; re-registering a rule id replaces the pass, which is what a
    downstream override wants)."""
    if not cls.rule or cls.rule == "RA???":
        raise ValueError(f"{cls.__name__} must set a rule id")
    _REGISTRY[cls.rule] = cls
    RULE_DOCS[cls.rule] = cls.doc.strip().splitlines()[0] if cls.doc else ""
    return cls


def registered_passes(select: Iterable[str] | None = None) -> list[LintPass]:
    """Instantiate the registered passes (optionally only ``select``)."""
    import repro_torch.analysis.lint.passes  # noqa: F401  (self-registration)
    wanted = set(select) if select is not None else None
    if wanted is not None:
        unknown = wanted - set(_REGISTRY) - {"RA000"}
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)} "
                             f"(known: {sorted(_REGISTRY)})")
    return [cls() for rule, cls in sorted(_REGISTRY.items())
            if wanted is None or rule in wanted]


def _parse_suppressions(text: str) -> list[Suppression]:
    """Extract ``# repro_torch: ignore[...]`` comments via :mod:`tokenize`,
    so the pattern never matches inside string literals or docstrings (a
    lint framework whose own documentation trips its suppressions is no
    framework at all)."""
    import io
    import tokenize
    out = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT or MARKER not in tok.string:
            continue
        m = _IGNORE_RE.search(tok.string)
        if not m:
            continue
        rules = frozenset(r.strip().upper()
                          for r in m.group(1).split(",") if r.strip())
        out.append(Suppression(line=tok.start[0], rules=rules,
                               justification=m.group(2).strip()))
    return out


def parse_file(path: str | Path) -> SourceFile:
    p = Path(path)
    text = p.read_text()
    tree = ast.parse(text, filename=str(p))
    return SourceFile(path=str(p), text=text, tree=tree,
                      suppressions=_parse_suppressions(text))


def _iter_py_files(paths: Iterable[str | Path]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


def run_project(project: Project,
                select: Iterable[str] | None = None) -> list[Diagnostic]:
    """Run the (selected) registered passes over an already-parsed
    project and apply suppression comments.  Returns sorted diagnostics:
    pass findings minus suppressed ones, plus RA000 for every
    unjustified or unknown-rule suppression."""
    passes = registered_passes(select)
    raw: list[Diagnostic] = []
    for pa in passes:
        for src in project.files:
            raw.extend(pa.check(src, project))
        raw.extend(pa.finalize(project))

    by_path = {f.path: f for f in project.files}
    out: list[Diagnostic] = []
    for d in raw:
        src = by_path.get(d.path)
        if src is not None and d.rule in src.suppressed_rules_at(d.line):
            continue
        out.append(d)

    # RA000: suppression hygiene (never itself suppressible)
    want_ra000 = select is None or "RA000" in set(select)
    if want_ra000:
        known = set(_REGISTRY) | {"RA000"}
        for src in project.files:
            for s in src.suppressions:
                unknown = s.rules - known
                if unknown:
                    out.append(Diagnostic(
                        path=src.path, line=s.line, col=0, rule="RA000",
                        message=f"ignore[] names unknown rule(s) "
                                f"{sorted(unknown)} (known: {sorted(known)})"))
                if not s.justified:
                    out.append(Diagnostic(
                        path=src.path, line=s.line, col=0, rule="RA000",
                        message="suppression without justification — write "
                                "'# repro_torch: ignore[RULE] -- <why "
                                "this is safe here>'"))
    return sorted(set(out))


def run_paths(paths: Iterable[str | Path],
              select: Iterable[str] | None = None,
              ) -> tuple[list[Diagnostic], Project]:
    """Parse every ``.py`` under ``paths`` and lint them as one project.
    Unparseable files become a synthetic RA000-style diagnostic rather
    than an exception: the lint gate must report, not crash."""
    project = Project()
    errors: list[Diagnostic] = []
    for p in _iter_py_files(paths):
        try:
            project.files.append(parse_file(p))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(Diagnostic(
                path=str(p), line=getattr(e, "lineno", 0) or 0, col=0,
                rule="RA000", message=f"unparseable file: {e}"))
    return sorted(set(errors) | set(run_project(project, select))), project
