"""The port's checkpoint store and trainer restarts, on the CPU.

Mirrors tests/test_checkpoint.py (roundtrip, stale pointer, incomplete
checkpoint, async GC, restart determinism at its 1e-4 on the last loss),
and holds the on-disk layout to the JAX package's: a checkpoint of fp32
leaves written by ``repro.checkpoint.save`` restores in the port value
for value, and one the port writes restores in the JAX package.  bf16
leaves round-trip bit for bit (numpy has no bfloat16: the port stores the
uint16 bit pattern and names the dtype in the manifest).
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.normal(0, 1, (4, 8)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.normal(0, 1, (8,))).to(torch.bfloat16)},
            "opt": {"m": torch.zeros(4, 8), "q": torch.tensor(
                        rng.integers(-127, 128, (3, 4)), dtype=torch.int8),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    st = _state()
    save(tmp_path, 3, st, metadata={"loss": 1.5})
    out, manifest = restore(tmp_path, device="cpu")
    assert manifest["step"] == 3
    assert manifest["metadata"]["loss"] == 1.5
    for group in st:
        for k, t in st[group].items():
            assert out[group][k].dtype == t.dtype, k
            assert torch.equal(out[group][k], t), k
    layout = sorted(p.name for p in (tmp_path / "step_00000003").iterdir())
    assert layout == ["leaf_00000.npy", "leaf_00001.npy", "leaf_00002.npy",
                      "leaf_00003.npy", "leaf_00004.npy", "manifest.json"]
    assert (tmp_path / "LATEST").read_text() == "3"
    rec = json.loads((tmp_path / "step_00000003" / "manifest.json")
                     .read_text())["leaves"]
    assert [r["dtype"] for r in rec] == ["float32", "int8", "int32",
                                         "bfloat16", "float32"]
    assert [r["path"] for r in rec][3] == ["params", "b"]


def test_latest_falls_back_on_stale_pointer(tmp_path):
    save(tmp_path, 1, _state())
    save(tmp_path, 2, _state(1))
    (tmp_path / "LATEST").write_text("99")        # stale/corrupt pointer
    assert latest_step(tmp_path) == 2


def test_incomplete_checkpoint_invisible(tmp_path):
    save(tmp_path, 1, _state())
    (tmp_path / "step_00000002.tmp").mkdir()      # a crash mid-write
    assert latest_step(tmp_path) == 1


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in range(5):
        ck.save(s, _state(s))
    ck.wait()
    steps = sorted(d.name for d in tmp_path.glob("step_*"))
    assert len(steps) == 2
    assert latest_step(tmp_path) == 4


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """The trainer updates tensors in place right after ``save``: what is
    written is the state at the call."""
    st = _state()
    ref = st["params"]["w"].clone()
    ck = AsyncCheckpointer(tmp_path)
    ck.save(0, st)
    st["params"]["w"].add_(1.0)
    ck.wait()
    out, _ = restore(tmp_path, device="cpu")
    assert torch.equal(out["params"]["w"], ref)


def test_restores_a_checkpoint_the_jax_package_wrote(tmp_path):
    rng = np.random.default_rng(4)
    st = {"params": {"embed": jnp.asarray(rng.normal(0, 1, (16, 4)),
                                          jnp.float32),
                     "blocks": {"w": jnp.asarray(rng.normal(0, 1, (2, 4, 4)),
                                                 jnp.float32)}},
          "opt": {"step": jnp.asarray(5, jnp.int32)}}
    jax_save(tmp_path, 5, st, metadata={"loss": 2.0})
    out, manifest = restore(tmp_path, device="cpu")
    assert manifest["step"] == 5 and manifest["metadata"] == {"loss": 2.0}
    np.testing.assert_array_equal(out["params"]["embed"].numpy(),
                                  np.asarray(st["params"]["embed"]))
    np.testing.assert_array_equal(out["params"]["blocks"]["w"].numpy(),
                                  np.asarray(st["params"]["blocks"]["w"]))
    assert out["opt"]["step"].dtype == torch.int32
    assert int(out["opt"]["step"]) == 5


def test_the_jax_package_restores_what_the_port_wrote(tmp_path):
    st = {"params": {"w": torch.randn(3, 5, generator=torch.Generator()
                                      .manual_seed(0))},
          "opt": {"step": torch.tensor(2, dtype=torch.int32)}}
    save(tmp_path, 2, st)
    out, manifest = jax_restore(tmp_path)
    assert manifest["step"] == 2
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]),
                                  st["params"]["w"].numpy())
    assert int(out["opt"]["step"]) == 2


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, device="cpu")


def test_restart_determinism(tmp_path):
    """tests/test_checkpoint.py's check on the port: 6 steps straight
    against a run that fails at step 4 and restarts from the step-3
    checkpoint; the last loss within 1e-4, as there."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import train, train_with_restarts
    cfg = smoke_config("stablelm-1.6b")
    rep_a = train(cfg, steps=6, seq=16, global_batch=2, ckpt_dir=tmp_path / "a",
                  ckpt_every=2, seed=5, device="cpu")
    rep_b = train_with_restarts(cfg, steps=6, seq=16, global_batch=2,
                                ckpt_dir=tmp_path / "b", ckpt_every=2,
                                failures=[4], seed=5, device="cpu")
    assert rep_b.restarts == 1
    assert rep_b.steps_run == 2 and rep_b.final_step == 5
    np.testing.assert_allclose(rep_a.losses[-1], rep_b.losses[-1], atol=1e-4)
