"""The port's lint suite against the LIVE port tree — not fixtures.

The counterpart of tests/test_analysis_live.py:

* the port's files are clean under the port's linter (the merge gate);
* RA003 sees every real ``emit(``/``Event(kind=``) call site of the port
  and the kinds it collects are exactly the runtime ``EVENT_KINDS`` of
  ``repro_torch.obs.trace``;
* RA004 sees the port's schema writers/readers (estimator v1-v6, bias,
  reliability, execution trace, events, observation buffer, synthetic
  DAG) and finds every written key consumed;
* RA001's traced set holds the fused tick, the graph-captured
  ``TickEngine._pack_out`` and the kernels' autograd functions, and not
  the engine's planned read-back.
"""
import ast
import importlib.util
from pathlib import Path

import pytest

from repro_torch.analysis.lint import parse_file, run_paths
from repro_torch.analysis.lint.passes.jit_purity import traced_functions
from repro_torch.analysis.lint.passes.schema_roundtrip import (_consumed_keys,
                                                               _written_keys)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _default_paths():
    spec = importlib.util.spec_from_file_location(
        "lint_repro_torch", ROOT / "scripts" / "lint_repro_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.default_paths()


def _class_fns(path: Path, cls_name: str) -> dict:
    tree = parse_file(path).tree
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return {n.name: n for n in node.body
                    if isinstance(n, ast.FunctionDef)}
    raise AssertionError(f"{cls_name} not found in {path}")


# ---------------------------------------------------------------------------
# the merge gate
# ---------------------------------------------------------------------------
def test_port_tree_is_lint_clean():
    paths = _default_paths()
    assert ROOT / "chip_smoke.py" in paths
    assert ROOT / "scripts" / "lint_repro_torch.py" in paths
    diags, project = run_paths(paths)
    in_port = [f for f in project.files
               if Path(f.path).is_relative_to(PORT)]
    assert len(in_port) >= 76, "lint saw suspiciously few port files"
    assert diags == [], "\n".join(str(d) for d in diags)


# ---------------------------------------------------------------------------
# RA003 closure over the port's live taxonomy
# ---------------------------------------------------------------------------
def _live_emit_kinds() -> tuple[set, int]:
    """(kinds, site count) from every emit()/Event(kind=) call under the
    port, collected independently of the pass implementation."""
    kinds, sites = set(), 0
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(parse_file(path).tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "emit":
                sites += 1
                if node.args and isinstance(node.args[0], ast.Constant):
                    kinds.add(node.args[0].value)
                for kw in node.keywords:
                    if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                        kinds.add(kw.value.value)
            elif isinstance(node.func, ast.Name) and node.func.id == "Event":
                for kw in node.keywords:
                    if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                        kinds.add(kw.value.value)
    return kinds, sites


def test_ra003_covers_all_live_emit_sites():
    from repro_torch.obs.trace import EVENT_KINDS
    kinds, sites = _live_emit_kinds()
    assert sites >= 19, f"only {sites} emit sites seen"
    assert kinds == set(EVENT_KINDS), (
        f"taxonomy drift: emitted-not-registered {kinds - set(EVENT_KINDS)}, "
        f"registered-never-emitted {set(EVENT_KINDS) - kinds}")


def test_ra003_clean_on_live_tree_but_catches_injected_typo(tmp_path):
    diags, _ = run_paths([PORT], select=["RA003"])
    assert diags == [], "\n".join(str(d) for d in diags)
    trace_src = (PORT / "obs" / "trace.py").read_text()
    bad = tmp_path / "obs_copy.py"
    bad.write_text(trace_src + "\n\ndef _bad(tr):\n"
                   "    tr.emit('fnish', t_sim=0.0)\n")
    diags, _ = run_paths([bad], select=["RA003"])
    assert any("fnish" in d.message for d in diags)


# ---------------------------------------------------------------------------
# RA004 over the port's live schemas (v1-v6)
# ---------------------------------------------------------------------------
ESTIMATOR = PORT / "core" / "estimator.py"
BLR = PORT / "core" / "blr.py"
EXECUTOR = PORT / "online" / "executor.py"
TRACE = PORT / "obs" / "trace.py"
BUFFER = PORT / "online" / "buffer.py"
SYNTHETIC = PORT / "data" / "synthetic.py"

#: the keys each schema version introduced (the JAX package's v1-v5, and
#: v6's batched state block)
ESTIMATOR_SCHEMA_KEYS = {
    1: {"version", "freq_reduction", "local_bench", "target_benches",
        "tasks", "w", "sizes", "runtimes"},
    2: {"model", "correlated", "median", "spread", "post",
        "mu", "V", "a", "b", "x_scale", "y_scale"},
    3: {"bias", "nodes", "state", "bias_correction"},
    4: {"bias_opts"},
    5: {"reliability"},
    6: {"moments"},
}


@pytest.mark.parametrize("cls,path,writer,reader", [
    ("LotaruEstimator", ESTIMATOR, "save", "load"),
    ("BiasModel", BLR, "to_dict", "from_dict"),
    ("ReliabilityModel", BLR, "to_dict", "from_dict"),
    ("ExecutionTrace", EXECUTOR, "to_dict", "from_dict"),
    ("Event", TRACE, "to_json", "from_json"),
    ("ObservationBuffer", BUFFER, "to_dict", "from_dict"),
    ("SyntheticDAG", SYNTHETIC, "to_dict", "from_dict"),
])
def test_ra004_live_writer_keys_all_consumed(cls, path, writer, reader):
    fns = _class_fns(path, cls)
    assert writer in fns and reader in fns, f"{cls} lost its schema pair"
    written = set(_written_keys(fns[writer]))
    consumed = _consumed_keys(fns[reader])
    assert written, f"{cls}.{writer} writes no keys — collector broke?"
    missing = written - consumed
    assert not missing, (f"{cls}: keys written by {writer} but never "
                         f"consumed by {reader}: {sorted(missing)}")


def test_ra004_estimator_covers_every_schema_version_key():
    fns = _class_fns(ESTIMATOR, "LotaruEstimator")
    written = set(_written_keys(fns["save"]))
    consumed = _consumed_keys(fns["load"])
    for version, keys in ESTIMATOR_SCHEMA_KEYS.items():
        assert keys <= written, (f"schema v{version} keys no longer "
                                 f"written: {sorted(keys - written)}")
        assert keys <= consumed, (f"schema v{version} keys no longer "
                                  f"consumed: {sorted(keys - consumed)}")


def test_ra004_live_version_guards_are_monotone():
    diags, _ = run_paths([ESTIMATOR, BLR, EXECUTOR, TRACE, BUFFER, SYNTHETIC],
                         select=["RA004"])
    assert diags == [], "\n".join(str(d) for d in diags)


def test_ra004_catches_injected_schema_leak(tmp_path):
    text = ESTIMATOR.read_text()
    needle = '"tasks": {}}'
    assert needle in text
    bad = tmp_path / "estimator_leaky.py"
    bad.write_text(text.replace(needle, '"tasks": {}, "leaked_key": 1}'))
    diags, _ = run_paths([bad], select=["RA004"])
    assert any("leaked_key" in d.message for d in diags), \
        "RA004 missed a planted leak in the live writer"


# ---------------------------------------------------------------------------
# RA001's traced set on the live tree
# ---------------------------------------------------------------------------
def _traced(rel: str) -> dict:
    return traced_functions(parse_file(PORT / rel))


@pytest.mark.parametrize("rel,name,why", [
    ("core/tick.py", "tick_step", "fused-tick seed list"),
    ("core/tick.py", "_tick_core", "fused-tick seed list"),
    ("core/tick.py", "_stacked_tick_core", "fused-tick seed list"),
    ("core/tick.py", "_fold_predict", "fused-tick seed list"),
    ("core/tick.py", "_host_obs", "called from traced tick_step"),
    ("core/tick.py", "TickEngine._pack_out",
     "called in a torch.cuda.graph capture"),
    ("online/fleet.py", "fleet_tick_step", "fused-tick seed list"),
    ("kernels/flash_attention/ops.py", "_FlashAttention.forward", None),
    ("kernels/flash_attention/ops.py", "_FlashAttention.backward", None),
    ("kernels/ssd/ops.py", "_SSDScan.forward", None),
    ("kernels/ssd/ops.py", "_SSDScan.backward", None),
])
def test_ra001_live_traced_set_holds(rel, name, why):
    traced = _traced(rel)
    assert name in traced, sorted(traced)
    if why is None:
        method = name.split(".")[-1]
        why = f"{method} of torch.autograd.Function {name.split('.')[0]}"
    assert traced[name] == why


@pytest.mark.parametrize("name", ["TickEngine._fetch",
                                  "TickEngine.observe_batch",
                                  "TickEngine._capture",
                                  "TickEngine._eager_tick"])
def test_ra001_live_traced_set_excludes(name):
    assert name not in _traced("core/tick.py")


def test_ra001_live_host_read_back_is_justified():
    # the one planned read-back on a traced path carries a justified
    # suppression, and the linter still finds the sync under it
    src = parse_file(PORT / "core" / "tick.py")
    line = next(i for i, t in enumerate(src.lines, 1)
                if "obs.detach().cpu().numpy()" in t)
    sup = [s for s in src.suppressions if s.line == line - 1]
    assert sup and sup[0].justified and sup[0].rules == {"RA001"}
    from repro_torch.analysis.lint.passes.jit_purity import JitPurityPass
    raw = list(JitPurityPass().check(src, None))
    assert {d.line for d in raw} == {line}


# ---------------------------------------------------------------------------
# the card's sync trace held to RA001 (repro_torch.analysis.syncs): the gate
# and the site mapping, on the CPU; the card's own trace is a gpu test and
# chip_smoke.py's phase 15
# ---------------------------------------------------------------------------
def _tick_line(text: str) -> int:
    lines = (PORT / "core" / "tick.py").read_text().splitlines()
    return next(i for i, t in enumerate(lines, 1) if text in t)


def test_sync_gate_on_the_live_tree():
    from repro_torch.analysis.syncs import SyncSite, lint_index, missed
    index = lint_index()
    tick = "src/repro_torch/core/tick.py"
    assert "TickEngine._pack_out" in index.traced[tick]

    def site(text, fn, path=tick, in_port=True):
        return SyncSite(path, _tick_line(text), fn, in_port)
    planned = site("obs = obs.detach().cpu().numpy()", "_host_obs")
    fetch = site("return np.asarray(out.cpu().numpy()", "_fetch")
    packed = site("return torch.cat([t.reshape(-1)", "_pack_out")
    script = SyncSite("chip_smoke.py", 1, "main", False)
    # a justified ignore, an untraced function, a file outside the port
    assert missed([planned, fetch, script, fetch], index) == []
    # a sync in a traced function that RA001 neither flags nor excuses
    assert missed([packed, fetch], index) == [(packed,
                                               "TickEngine._pack_out")]


def test_sync_trace_records_each_call(monkeypatch):
    import warnings

    import torch

    from repro_torch.analysis import syncs
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    message = syncs.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions)"

    def fn():
        for _ in range(3):          # one site, three calls: three records
            warnings.warn(message)
        warnings.warn("an unrelated warning")
        return 7
    with pytest.warns(UserWarning, match="unrelated"):
        out, sites = syncs.trace_syncs(fn)
    assert out == 7 and modes == ["warn", 0]
    assert len(sites) == 3 and len(set(sites)) == 1
    assert sites[0].path == "tests/test_torch_lint_live.py"
    assert sites[0].function == "fn" and not sites[0].in_port

    def boom():
        raise RuntimeError("boom")
    with pytest.raises(RuntimeError):
        syncs.trace_syncs(boom)
    assert modes[-2:] == ["warn", 0]       # the mode is back at 0


def test_sync_site_is_the_innermost_port_frame():
    import traceback

    from repro_torch.analysis.syncs import _site
    torch_file = "/usr/lib/python3/site-packages/torch/_tensor.py"
    stack = [traceback.FrameSummary(str(ROOT / "chip_smoke.py"), 9, "main"),
             traceback.FrameSummary(str(PORT / "core" / "tick.py"), 20,
                                    "observe_batch"),
             traceback.FrameSummary(str(PORT / "core" / "tick.py"), 30,
                                    "_fetch"),
             traceback.FrameSummary(torch_file, 40, "__array__")]
    site = _site(stack)
    assert (site.path, site.line, site.function, site.in_port) == \
        ("src/repro_torch/core/tick.py", 30, "_fetch", True)
    site = _site(stack[:1] + stack[3:])
    assert (site.path, site.in_port) == ("chip_smoke.py", False)
