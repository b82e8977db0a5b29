"""The port's roofline (``repro_torch.analysis.roofline``) and the dry
run's batch stand-ins (``repro_torch.launch.shapes.input_specs``) held to
the JAX package's on the CPU.

* ``model_flops`` equal to the reference's for the ten full configs x
  the four ``SHAPES``, exactly (the same integer arithmetic);
* ``Roofline.to_dict``: the same fields, each time term the reference's
  times the ratio of the two packages' rates (TPU v5e there, H100 SXM
  here), at 1e-12 relative;
* ``input_specs``: the reference's keys, shapes and dtypes, its specs
  built on a one-device mesh.
"""
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.launch.mesh import make_mesh, make_rules
from repro.launch.shapes import SHAPES as JSHAPES
from repro.launch.shapes import input_specs as jinput_specs
from repro_torch.analysis import roofline as roof
from repro_torch.configs import get_config
from repro_torch.launch.shapes import SHAPES, input_specs

TOL = 1e-12
CELLS = [(a, s) for a in list_archs() for s in SHAPES]


def test_shapes_are_the_references():
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape):
    s = SHAPES[shape]
    assert (roof.model_flops(get_config(arch), s.kind, s.seq, s.global_batch)
            == jroof.model_flops(jget_config(arch), s.kind, s.seq,
                                 s.global_batch))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("seed", range(6))
def test_roofline_terms_are_the_references_at_the_cards_rates(seed):
    rng = np.random.default_rng(seed)
    arch, shape = CELLS[seed * 5]
    s = SHAPES[shape]
    mflops, tokens = roof.model_flops(get_config(arch), s.kind, s.seq,
                                      s.global_batch)
    kw = dict(arch=arch, shape=shape, mesh="m", chips=int(rng.integers(1, 9)),
              flops_per_device=float(rng.uniform(1e12, 1e16)),
              bytes_per_device=float(rng.uniform(1e9, 1e13)),
              coll_bytes_per_device=float(rng.uniform(0, 1e11)),
              model_flops_total=mflops, step_tokens=tokens)
    port = roof.Roofline(**kw).to_dict()
    ref = jroof.Roofline(**kw).to_dict()
    assert port.keys() == ref.keys()
    for k in kw:
        assert port[k] == ref[k]
    ratio = {"compute_s": jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
             "memory_s": jroof.HBM_BW / roof.HBM_BW,
             "collective_s": jroof.LINK_BW / roof.LINK_BW}
    for k, r in ratio.items():
        assert _rel(port[k], ref[k] * r) <= TOL, k
    terms = {k: port[k] for k in ratio}
    assert port["bound"] == max(terms, key=terms.get).removesuffix("_s")
    assert port["step_time_s"] == max(terms.values())
    assert _rel(port["useful_flop_fraction"], ref["useful_flop_fraction"]) \
        <= TOL
    ideal = mflops / (kw["chips"] * roof.PEAK_FLOPS)
    assert _rel(port["roofline_fraction"], ideal / port["step_time_s"]) <= TOL


def test_card_constants():
    """The H100 SXM data sheet's figures (not readings)."""
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.LINK_BW, roof.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)


@pytest.fixture(scope="module")
def one_device():
    mesh = make_mesh((1, 1), ("data", "model"))
    return mesh, make_rules(mesh)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_references(arch, shape, one_device):
    mesh, rules = one_device
    ref = jinput_specs(jget_config(arch), JSHAPES[shape], mesh, rules)
    port = input_specs(get_config(arch), SHAPES[shape])
    assert port.keys() == ref.keys()
    for k, v in port.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == \
            str(np.dtype(ref[k].dtype)), k


def test_input_specs_on_another_device():
    batch = input_specs(get_config("qwen2-vl-7b"), SHAPES["train_4k"],
                        device="cpu")
    assert {v.device.type for v in batch.values()} == {"cpu"}
    assert batch["vision_embeds"].dtype == torch.bfloat16
