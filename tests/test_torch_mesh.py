"""The port's meshes, sharding rules and specs against the JAX package's,
with no process group.

The JAX side runs on ``jax.sharding.AbstractMesh``es (no devices): the
reference's ``make_rules`` and ``rules_for_mesh`` read only a mesh's
``axis_names`` and ``shape``, ``NamedSharding(mesh, spec).shard_shape``
gives its local shapes.  The port's side runs on the same axis-size maps
through a stand-in with those two attributes.  Specs compare as tuples:
the port's spec equals ``tuple(PartitionSpec)``.

The (1, 1)-mesh step must be the step without rules bit for bit (no
tolerance): the step without a mesh is the sharded step on
``ONE_PROCESS`` (a ("pod", "data", "model") mesh of one process, under
its own ``make_rules``), and on a mesh of one process no collective runs.
"""
import ast
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.mesh import make_rules as jax_make_rules
from repro.launch.shapes import SHAPES as JSHAPES
from repro.launch.shapes import input_specs as jax_input_specs
from repro.models import build_model as jax_build_model
from repro.models.common import DEFAULT_RULES as JAX_DEFAULT_RULES
from repro.models.common import AxisRules as JaxAxisRules
from repro.models.common import rules_for_mesh as jax_rules_for_mesh
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.checkpoint.store import write_slice
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (ONE_PROCESS, Mesh, make_mesh,
                                     make_production_mesh, make_rules,
                                     rank_device)
from repro_torch.launch.shapes import SHAPES, input_specs
from repro_torch.launch.sharding import Sharding, batch_rows
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build_model
from repro_torch.models.common import (DEFAULT_RULES, AxisRules,
                                       rules_for_mesh, tree_defs_init)
from repro_torch.optim import AdamWConfig, state_defs
from repro_torch.optim.adamw import leaves

SIZES = {"2x2": {"data": 2, "model": 2},
         "16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}
OVERRIDES = {"embed": None, "mlp": ("data", "model"), "vocab": "data"}


def _meshes(sizes):
    """(the JAX package's abstract mesh, the port's stand-in)."""
    jmesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    return jmesh, SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _pairs(sizes):
    """(name, JAX rules, port rules) for every way of making rules."""
    jmesh, mesh = _meshes(sizes)
    out = [("rules_for_mesh", jax_rules_for_mesh(jmesh),
            rules_for_mesh(mesh))]
    for pod in (False, True):
        for ov in (None, OVERRIDES):
            out.append((f"make_rules(fsdp_over_pod={pod}, overrides={ov})",
                        jax_make_rules(jmesh, fsdp_over_pod=pod,
                                       overrides=ov),
                        make_rules(mesh, fsdp_over_pod=pod, overrides=ov)))
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _jflat(tree):
    out = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out.append((tuple(k.key for k in path), tuple(spec)))
    return out


def test_default_rules_are_the_reference_table():
    assert DEFAULT_RULES == JAX_DEFAULT_RULES


@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_resolve_rules_for_mesh_and_make_rules_match_jax(sizes):
    """Every logical name of DEFAULT_RULES (and None) alone and all at
    once, on dims that divide every axis product and on odd dims, under
    each way of making rules, and the rules' fields themselves."""
    names = sorted(DEFAULT_RULES) + [None]
    for label, jr, r in _pairs(SIZES[sizes]):
        assert (r.fsdp_axes, r.dp_axes, dict(r.axis_sizes)) == \
            (jr.fsdp_axes, jr.dp_axes, dict(jr.axis_sizes)), label
        for dim in (512, 6, 17):
            for name in names:
                assert r.resolve(name, dims=(dim,)) == \
                    tuple(jr.resolve(name, dims=(dim,))), (label, name, dim)
            assert r.resolve(*names) == tuple(jr.resolve(*names)), label
            assert r.resolve(*names, dims=[dim] * len(names)) == \
                tuple(jr.resolve(*names, dims=[dim] * len(names))), label


def test_resolve_without_axis_sizes_matches_jax():
    """Rules with no axis sizes never drop a sharding (dims unread)."""
    for fsdp, dp in (((), ()), (("data",), ("data",)),
                     (("pod", "data"), ("pod", "data"))):
        jr, r = JaxAxisRules(fsdp, dp), AxisRules(fsdp, dp)
        for name in DEFAULT_RULES:
            assert r.resolve(name, dims=(3,)) == \
                tuple(jr.resolve(name, dims=(3,)))


def _cfgs(arch, size):
    if size == "smoke":
        return jax_smoke_config(arch), smoke_config(arch)
    return jax_get_config(arch), get_config(arch)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_cache_specs_match_jax(arch, size):
    """``Model.param_specs`` and ``cache_specs`` (a batch the dp axes
    divide and one they do not) equal the JAX package's, path by path,
    under the three axis-size maps; ParamDef trees only, no weights."""
    jcfg, cfg = _cfgs(arch, size)
    jmodel, model = jax_build_model(jcfg), build_model(cfg)
    for sizes in SIZES.values():
        for label, jr, r in _pairs(sizes)[:2]:
            assert _flat(model.param_specs(r)) == \
                _jflat(jmodel.param_specs(jr)), (sizes, label)
            for batch in (64, 6):
                assert _flat(model.cache_specs(r, batch, 128, 32)) == \
                    _jflat(jmodel.cache_specs(jr, batch, 128, 32)), \
                    (sizes, label, batch)


@pytest.mark.parametrize("arch", list_archs())
def test_local_shapes_match_named_sharding(arch):
    """``abstract_params`` / ``abstract_caches``: a meta tensor of the
    global shape, the spec, and a local shape equal to JAX's
    ``NamedSharding.shard_shape`` and to dim // shard count; an uneven
    dim resolves to None and stays whole."""
    jcfg, cfg = _cfgs(arch, "smoke")
    model = build_model(cfg)
    for sizes in SIZES.values():
        jmesh, mesh = _meshes(sizes)
        r = rules_for_mesh(mesh)
        trees = (model.abstract_params(mesh, r),
                 model.abstract_caches(mesh, r, 64, 128, 32))
        for tree in trees:
            for path, a in _flat(tree):
                assert a.tensor.device.type == "meta"
                shape = tuple(a.tensor.shape)
                assert a.local_shape == NamedSharding(
                    jmesh, P(*a.spec)).shard_shape(shape), path
                for dim, loc, entry in zip(shape, a.local_shape, a.spec):
                    axes = () if entry is None else (
                        entry if isinstance(entry, tuple) else (entry,))
                    n = math.prod(sizes[x] for x in axes)
                    assert dim % n == 0 and loc == dim // n, path
        # a dim that does not divide resolves to None and stays whole
        odd = r.resolve("vocab", "embed", dims=(17, 6))
        assert odd[0] is None
        if sizes["data"] > 6 or "pod" in sizes:
            assert odd[1] is None


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_input_specs_with_a_mesh_match_jax(shape):
    """``input_specs(cfg, shape, mesh, rules)``: the keys, shapes, dtypes'
    sizes and specs of the JAX package's ``input_specs`` (its
    ``_dp_batch_spec``), local shapes as ``shard_shape``."""
    for arch in ("qwen2-7b", "qwen2-vl-7b", "seamless-m4t-large-v2"):
        for sizes in SIZES.values():
            jmesh, mesh = _meshes(sizes)
            jr, r = jax_make_rules(jmesh), make_rules(mesh)
            ref = jax_input_specs(jax_get_config(arch), JSHAPES[shape],
                                  jmesh, jr)
            port = input_specs(get_config(arch), SHAPES[shape], mesh, r)
            assert sorted(port) == sorted(ref)
            for k, a in port.items():
                sds = ref[k]
                assert tuple(a.tensor.shape) == sds.shape, (arch, k)
                assert a.tensor.element_size() == sds.dtype.itemsize
                assert a.spec == tuple(sds.sharding.spec), (arch, k, sizes)
                assert a.local_shape == sds.sharding.shard_shape(sds.shape)


def test_sharding_slices_tile_the_leaf():
    """Each rank's slice (``Sharding.slices``) of a leaf over a (2, 2,
    2) mesh, with a dim over a tuple of axes (major first), tiles the
    leaf exactly once per set of ranks holding distinct slices."""
    dims = (2, 2, 2)
    axes = ("pod", "data", "model")
    shape = (8, 6, 4)
    spec = (("pod", "data"), None, "model")
    hits = np.zeros(shape, int)
    for coords in np.ndindex(*dims):
        mesh = Mesh(axes, dims, tuple(coords), torch.device("cpu"))
        sh = Sharding(mesh, spec)
        sl = sh.slices(shape)
        assert tuple(s.stop - s.start for s in sl) == sh.shard_shape(shape)
        assert sl[0].start == 2 * (2 * coords[0] + coords[1])
        hits[sl] += 1
    assert (hits == 1).all()      # no axis of the mesh left unnamed


def test_batch_rows_follow_the_microbatch_layout():
    """Microbatch i is rows [i B/mb, (i+1) B/mb), split over dp ranks in
    order; the ranks' rows tile the batch."""
    assert batch_rows(8, 2, 2, 0) == [0, 1, 4, 5]
    assert batch_rows(8, 2, 2, 1) == [2, 3, 6, 7]
    assert batch_rows(8, 1, 4, 3) == [6, 7]
    rows = sorted(r for i in range(4) for r in batch_rows(16, 2, 4, i))
    assert rows == list(range(16))
    with pytest.raises(ValueError, match="does not split"):
        batch_rows(6, 2, 2, 0)


def test_meshes_need_their_world():
    """Without a process group the world is one process: a (1, 1) mesh
    needs no group; a larger mesh and the production meshes raise."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.axis_names == ("data", "model") and mesh.device_mesh is None
    r = make_rules(mesh)
    assert (r.fsdp_axes, r.dp_axes) == (("data",), ("data",))
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="needs 256 processes"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 processes"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_backends_take_no_silent_switch():
    """gloo on the CPU; NCCL refuses the CPU and two ranks on one card;
    an unknown backend raises."""
    assert rank_device("gloo", 3, 4, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="NCCL runs on CUDA cards"):
        rank_device("nccl", 0, 2, "cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="two ranks on one device"):
            rank_device("nccl", 0, 2)
    with pytest.raises(ValueError, match="not one of"):
        rank_device("mpi", 0, 2, "cpu")


def _mesh_of(dims):
    return Mesh(("data", "model"), dims, (0, 0), torch.device("cpu"))


def test_serving_on_a_mesh_and_moe_over_dp_raise():
    """Serving with the KV cache's sequence over "model" builds
    (context-parallel decode); training a MoE config whose groups
    (``moe_groups`` 0: one) do not split over the dp ranks raises;
    serving on (2, 1), (1, 2) and (1, 1) meshes, MoE at ``moe_groups`` =
    dp and MoE on a (1, k) mesh build."""
    cfg = smoke_config("qwen3-moe-30b-a3b")
    model = build_model(cfg)
    opt = AdamWConfig()
    for make in (make_prefill_step, make_decode_step):
        mesh = _mesh_of((1, 2))
        make(model, make_rules(mesh, overrides={"kv_seq": "model"}), mesh)
        for dims in ((2, 1), (1, 2), (1, 1)):
            make(model, mesh=_mesh_of(dims))
    with pytest.raises(ValueError, match="a multiple of 2"):
        make_train_step(model, opt, mesh=_mesh_of((2, 1)))
    make_train_step(build_model(cfg.with_(moe_groups=2)), opt,
                    mesh=_mesh_of((2, 1)))
    make_train_step(model, opt, mesh=_mesh_of((1, 2)))
    dense = build_model(smoke_config("qwen2-7b"))
    with pytest.raises(NotImplementedError, match="int8"):
        make_train_step(dense, AdamWConfig(state_dtype="int8"),
                        mesh=_mesh_of((1, 2)))


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-1.3b",
                                  "seamless-m4t-large-v2"])
def test_one_process_mesh_step_is_the_step_without_rules(arch):
    """A step through the (1, 1) mesh and ``make_rules`` equals the step
    without rules bit for bit: loss, metrics, gradients, parameters and
    AdamW state after it (2 microbatches, a partial mask)."""
    cfg = smoke_config(arch).with_(dtype=torch.float32)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = SyntheticLMData(cfg, seq=16, global_batch=4, seed=2,
                            device="cpu").batch(0)
    batch["mask"] = (torch.arange(16) < 11).float().expand(4, 16).clone()
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert make_rules(ONE_PROCESS) != make_rules(mesh)
    out = []
    for kw in ({}, {"rules": make_rules(mesh), "mesh": mesh}):
        params = model.init(0, device="cpu")
        state = tree_defs_init(state_defs(model.param_defs, opt),
                               torch.Generator().manual_seed(1), "cpu")
        step = make_train_step(model, opt, 2, keep_grads=True, **kw)
        sharding.reset_counts()
        params, state, m = step(params, state, batch)
        assert not sharding.CALLS, dict(sharding.CALLS)
        assert not any(p.requires_grad for p in leaves(params))
        out.append((leaves(params), leaves(state), m))
    (p0, s0, m0), (p1, s1, m1) = out
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(leaves(m0["grads"]) + p0 + s0,
                    leaves(m1["grads"]) + p1 + s1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,cuts", [
    ((), ()), ((12,), (4,)), ((6, 4, 8), (1, 2, 4)), ((6, 4, 8), (3, 1, 1)),
    ((5, 6), (1, 3)), ((4, 6, 2), (2, 2, 2))])
def test_slices_written_as_byte_runs_make_the_whole_array(tmp_path, shape,
                                                          cuts):
    """``write_slice`` of every block of a cut (minor dims too, where the
    blocks of different ranks share pages) into one ``.npy`` gives the
    whole array bit for bit, for 4-, 2- and 1-byte items."""
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.uint16, np.int8):
        whole = (rng.standard_normal(shape) * 100).astype(dtype)
        path = tmp_path / f"{np.dtype(dtype).name}.npy"
        np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)
        blocks = [tuple(slice(i * (n // c), (i + 1) * (n // c))
                        for i, n, c in zip(idx, shape, cuts))
                  for idx in np.ndindex(*cuts)]
        for block in reversed(blocks):
            write_slice(path, shape, block, whole[block])
        got = np.load(path)
        assert got.dtype == whole.dtype and np.array_equal(got, whole)


@pytest.mark.parametrize("name", ["examples/elastic_recovery_torch.py",
                                  "scripts/elastic_drift_torch.py"])
def test_elastic_entry_points_import_no_jax(name):
    """The elastic twin and the drift script stand alone, as the port's
    other entry points: no ``jax``, ``jaxlib`` or ``repro`` import."""
    path = Path(__file__).resolve().parents[1] / name
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), name)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [f"{name}:{node.lineno}: {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
