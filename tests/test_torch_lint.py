"""The port's linter (repro_torch.analysis.lint) held to the JAX package's
(repro.analysis.lint): the same diagnostics on the JAX package's own
fixtures for the framework-free rules (RA000, RA003-RA005), the torch
rules (RA001, RA002) on torch mirrors of its fixtures with the planted
violations on the same lines, and the framework's plumbing case by case.

Pure stdlib under test on the port's side (no torch is needed to lint).
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis.lint as ref
import repro_torch.analysis.lint as port
from repro_torch.analysis.lint import (RULE_DOCS, LintPass, parse_file,
                                       register, registered_passes,
                                       run_paths)

ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = Path(__file__).parent / "fixtures" / "analysis"
FIXTURES = Path(__file__).parent / "fixtures" / "analysis_torch"
FRAMEWORK_FREE = ["RA000", "RA003", "RA004", "RA005"]


def lint(*names, select=None):
    paths = [FIXTURES / n for n in names] if names else [FIXTURES]
    diags, _ = run_paths(paths, select=select)
    return diags


def rule_lines(diags, rule):
    return [d.line for d in diags if d.rule == rule]


def _keys(diags, base):
    return [(Path(d.path).relative_to(base).as_posix(), d.line, d.col, d.rule)
            for d in diags]


# ---------------------------------------------------------------------------
# the JAX package's fixtures: RA000 and RA003-RA005 give its diagnostics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["clean.py", "suppressions.py",
                                  "ra003_violations.py", "ra004_violations.py",
                                  "ra005_violations.py", "."])
def test_reference_fixtures_same_diagnostics(name, tmp_path):
    # the port reads its own marker: lint a copy with the marker rewritten
    # (line numbers unchanged) against the original under the reference
    copy = tmp_path / "analysis"
    shutil.copytree(REF_FIXTURES, copy)
    for f in copy.rglob("*.py"):
        f.write_text(re.sub(r"#(\s*)repro:", r"#\1repro_torch:",
                            f.read_text()))
    want, _ = ref.run_paths([REF_FIXTURES / name], select=FRAMEWORK_FREE)
    got, _ = port.run_paths([copy / name], select=FRAMEWORK_FREE)
    assert _keys(got, copy) == _keys(want, REF_FIXTURES)
    assert want or name == "clean.py"


def test_reference_marker_binds_nothing_in_the_port():
    # the JAX package's fixture as it stands: its `# repro:` comments are
    # not the port's, so the port parses no suppression from them
    src = parse_file(REF_FIXTURES / "suppressions.py")
    assert src.suppressions == [] and "# repro: ignore[" in src.text


# ---------------------------------------------------------------------------
# per-rule torch fixtures: exact ids and line numbers
# ---------------------------------------------------------------------------
def test_ra001_exact_lines():
    diags = lint("ra001_violations.py")
    # the JAX package's lines (15-50) where the construct has a torch
    # counterpart, then the torch syncs and capture/autograd roots
    assert rule_lines(diags, "RA001") == [15, 27, 32, 37, 44, 50, 73, 77,
                                          78, 85, 90, 91, 92, 108]
    assert {d.rule for d in diags} == {"RA001"}


def test_ra001_seed_list_exact_lines():
    # the fused tick is traced by CONTRACT (`_SEED_TRACED`): no visible
    # capture in the fixture, yet every planted violation fires — incl.
    # transitively through a same-file call
    diags = lint("ra001_tick_seed.py")
    assert rule_lines(diags, "RA001") == [16, 21, 27, 31, 49]
    assert {d.rule for d in diags} == {"RA001"}


@pytest.mark.parametrize("name,line", [
    ("ra001_tick_seed.py", 38),    # not seeded, not called from a seed
    ("ra001_violations.py", 22),   # float(y) of a local intermediate
    ("ra001_violations.py", 62),   # int() of a shape read
    ("ra001_violations.py", 72),   # store into a tensor inside a graph
    ("ra001_violations.py", 84),   # attribute store on autograd's ctx
    ("ra001_violations.py", 100),  # three-argument torch.where
    ("ra001_tick_seed.py", 44),    # store into a tensor in a seeded def
], ids=["seed-control", "local-float", "shape-read", "graph-store",
        "ctx-store", "where-3", "seed-store"])
def test_ra001_negative_controls(name, line):
    assert line not in rule_lines(lint(name), "RA001")


def test_ra001_traced_set_of_the_fixture():
    from repro_torch.analysis.lint.passes.jit_purity import traced_functions
    traced = traced_functions(parse_file(FIXTURES / "ra001_violations.py"))
    assert traced["Engine._pack"] == "called in a torch.cuda.graph capture"
    assert traced["_core"] == "called in a torch.cuda.graph capture"
    assert traced["Scale.forward"].startswith("forward of torch.autograd")
    assert traced["outer.body"] == "passed to checkpoint"
    assert traced["_row"] == "passed to torch.vmap"
    assert "Engine.capture" not in traced and "outer" not in traced


def test_function_at():
    from repro_torch.analysis.lint.passes.jit_purity import function_at
    src = parse_file(FIXTURES / "ra001_violations.py")
    assert function_at(src, 73) == "Engine._pack"
    assert function_at(src, 50) == "outer.body"
    assert function_at(src, 52) == "outer"
    assert function_at(src, 10) is None


def test_ra002_policy_modules_exact_lines():
    diags = lint("core/ra002_violations.py")
    assert rule_lines(diags, "RA002") == [10, 14, 18, 22, 34, 38, 42, 50]
    assert {d.rule for d in diags} == {"RA002"}


def test_ra002_product_exact_lines():
    diags = lint("models/ra002_product.py")
    assert rule_lines(diags, "RA002") == [6, 11, 25, 29]


def test_ra002_scope_is_path_based(tmp_path):
    # the same literal casts outside a policy path are not RA002's business
    moved = tmp_path / "elsewhere.py"
    shutil.copy(FIXTURES / "core" / "ra002_violations.py", moved)
    diags, _ = run_paths([moved, FIXTURES / "ra001_violations.py"],
                         select=["RA002"])
    assert diags == []


def test_ra002_blind_spot_closed(tmp_path):
    # a torch.float32 cast in a core/ file: the port flags it, the JAX
    # package's linter (numpy and JAX dtypes only) does not
    planted = tmp_path / "core" / "planted.py"
    planted.parent.mkdir()
    planted.write_text("import torch\n\n\ndef f(x):\n"
                       "    return x.to(torch.float32)\n")
    got, _ = port.run_paths([planted], select=["RA002"])
    want, _ = ref.run_paths([planted], select=["RA002"])
    assert [(d.line, d.rule) for d in got] == [(5, "RA002")]
    assert "_default_dtype" in got[0].message
    assert want == []


def test_clean_file_is_clean():
    assert lint("clean.py") == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------
def _suppression_case(case):
    diags = lint("suppressions.py")
    ra000 = [d for d in diags if d.rule == "RA000"]
    ra001 = rule_lines(diags, "RA001")
    if case == "justified":
        # the justified ignore on line 7 leaves no RA001 and no RA000 there
        return all(d.line != 7 for d in diags)
    if case == "bare":
        # flagged as RA000, but it still suppresses the named rule
        return (any(d.line == 13 and "without justification" in d.message
                    for d in ra000) and 13 not in ra001)
    if case == "unknown":
        # an unknown-rule ignore does not suppress the real finding
        return (any("RA999" in d.message for d in ra000) and 19 in ra001)
    if case == "line-above":
        return 26 not in ra001
    if case == "other-marker":
        # the JAX package's `# repro:` marker binds nothing in the port
        return 32 in ra001
    if case == "in-string":
        # core.py's own docstring holds example ignore comments; tokenize-
        # based parsing must not treat them as live suppressions
        src = parse_file(ROOT / "src" / "repro_torch" / "analysis" / "lint"
                         / "core.py")
        return src.suppressions == [] and "# repro_torch: ignore[" in src.text
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["justified", "bare", "unknown",
                                  "line-above", "other-marker", "in-string"])
def test_suppressions(case):
    assert _suppression_case(case)


# ---------------------------------------------------------------------------
# framework plumbing
# ---------------------------------------------------------------------------
def _plugin_roundtrip():
    class Probe(LintPass):
        rule = "RA900"
        doc = "test-only probe pass"

        def check(self, src, project):
            yield self.diag(src, 1, "probe")

    try:
        register(Probe)
        diags, _ = run_paths([FIXTURES / "clean.py"], select=["RA900"])
        assert [d.rule for d in diags] == ["RA900"]
        # the registries are separate: the JAX package's does not see it
        with pytest.raises(ValueError, match="unknown rule"):
            ref.run_paths([FIXTURES / "clean.py"], select=["RA900"])
    finally:
        from repro_torch.analysis.lint.core import _REGISTRY
        _REGISTRY.pop("RA900", None)
        RULE_DOCS.pop("RA900", None)


def _unparseable(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:\n")
    diags, _ = run_paths([bad])
    assert len(diags) == 1 and diags[0].rule == "RA000"
    assert "unparseable" in diags[0].message


def _cli(tmp_path):
    script = ROOT / "scripts" / "lint_repro_torch.py"
    r = subprocess.run([sys.executable, str(script),
                        str(FIXTURES / "clean.py")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = tmp_path / "summary.md"
    r = subprocess.run([sys.executable, str(script), "--select", "RA001",
                        str(FIXTURES / "ra001_tick_seed.py")],
                       capture_output=True, text=True,
                       env={"GITHUB_STEP_SUMMARY": str(summary),
                            "PATH": ""})
    assert r.returncode == 1
    assert "RA001" in r.stdout and "RA002" not in r.stdout
    assert "| RA001 |" in summary.read_text()
    r = subprocess.run([sys.executable, str(script), "--list-rules"],
                       capture_output=True, text=True)
    assert r.returncode == 0 and "RA005" in r.stdout


def _framework_case(case, tmp_path):
    if case == "select":
        diags = lint(select=["RA002"])
        assert diags and all(d.rule == "RA002" for d in diags)
    elif case == "select-unknown":
        with pytest.raises(ValueError, match="unknown rule"):
            run_paths([FIXTURES], select=["RA777"])
    elif case == "catalogue":
        registered_passes()
        assert set(RULE_DOCS) >= {"RA000", "RA001", "RA002", "RA003",
                                  "RA004", "RA005"}
        assert all(RULE_DOCS[r] for r in RULE_DOCS)
        # the same rule ids as the JAX package, with a doc each
        ref.registered_passes()
        assert set(RULE_DOCS) == set(ref.RULE_DOCS)
    elif case == "plugin":
        _plugin_roundtrip()
    elif case == "unparseable":
        _unparseable(tmp_path)
    elif case == "ordering":
        diags = lint()
        assert diags == sorted(set(diags))
    elif case == "cli":
        _cli(tmp_path)
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", ["select", "select-unknown", "catalogue",
                                  "plugin", "unparseable", "ordering", "cli"])
def test_framework(case, tmp_path):
    _framework_case(case, tmp_path)
