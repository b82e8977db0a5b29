"""Meshes: the training meshes and the fleet mesh.

Port of ``repro.launch.mesh``.  A training mesh lays the processes of a
``torch.distributed`` group out on named axes (``make_mesh``,
``make_production_mesh``), one process a rank; ``make_rules`` gives its
sharding rules.  Where the mesh holds more than one process it wraps a
``torch.distributed.device_mesh.DeviceMesh``, so each axis has its own
sub-group; a mesh of one process (every axis 1) needs no process group,
and the one-device train step is the step on such a mesh
(``ONE_PROCESS``).  ``init_process_group`` and
``spawn`` start the group: the backend is an argument, "nccl" for one
card a rank and "gloo" for the CPU or for ranks that share a card.

The fleet mesh (``make_fleet_mesh``) is the ("wf", "task") mesh of the
multi-workflow estimator fleet (``repro_torch.online.fleet``): a ``Mesh``
of the group's processes where the group holds more than one, else a
``FleetMesh`` of this process's devices; one card is the (1, 1) mesh.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.models.common import AxisRules, mesh_axis_sizes

BACKENDS = ("gloo", "nccl")


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------
def rank_device(backend: str, rank: int, world_size: int, device=None
                ) -> torch.device:
    """The device rank ``rank`` computes on: ``device`` (default: the CUDA
    cards, rank r on card r mod count).  NCCL takes one card a rank and
    raises where two ranks would share one; gloo takes the CPU or cards
    shared by several ranks.  Pure: it starts nothing."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if backend == "nccl" and world_size > count:
            raise ValueError(
                f"NCCL takes one card a rank: {world_size} ranks on "
                f"{count} card(s) would put two ranks on one device, which "
                "NCCL refuses; use backend='gloo' for ranks that share a "
                "card")
        dev = torch.device("cuda", rank % max(count, 1))
    elif backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA cards, not on {dev}; use "
                         "backend='gloo' on the CPU")
    return resolve_device(dev)


def init_process_group(rank: int, world_size: int, init_method: str, *,
                       backend: str, device=None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size``
    (``init_method``: "file://<path>" or "tcp://host:port") over
    ``backend``; returns the rank's device (``rank_device``)."""
    dev = rank_device(backend, rank, world_size, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def _spawned(rank, fn, world_size, init_method, backend, device, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    # every rank is on this host: gloo connects over loopback rather than
    # through whatever address the host's name resolves to
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = init_process_group(rank, world_size, init_method, backend=backend,
                             device=device)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), *, rendezvous: str | os.PathLike,
          backend: str = "gloo", device=None, timeout_s: float = 180.0
          ) -> None:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` fresh processes on
    this host that form the default process group over ``backend``
    (``rank_device`` gives each its device; gloo on the loopback
    interface unless ``GLOO_SOCKET_IFNAME`` is set), meeting through the
    file ``rendezvous`` (which must not exist yet; no port is bound).  Returns when every
    process has returned; raises if one raises, and after ``timeout_s``
    seconds ends them all and raises ``TimeoutError``.  ``fn`` must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    rendezvous = os.fspath(rendezvous)
    if os.path.exists(rendezvous):
        raise FileExistsError(f"rendezvous file {rendezvous} exists")
    rank_device(backend, 0, nprocs, device)   # raise before spawning
    ctx = mp.start_processes(
        _spawned, args=(fn, nprocs, f"file://{rendezvous}", backend, device,
                        tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks did not finish in "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


# ---------------------------------------------------------------------------
# Training meshes
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class Mesh:
    """The processes of the default group on named axes.  ``coords`` is
    this process's index along each axis; ``device_mesh`` is ``None`` for
    a mesh of one process."""
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]
    coords: tuple[int, ...]
    device: torch.device | None = None
    device_mesh: object = None

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self.device_mesh.get_group(axis)


#: the mesh of one process over every axis ``make_rules`` names: the
#: one-device train step's (``launch.steps.make_train_step`` without a mesh)
ONE_PROCESS = Mesh(("pod", "data", "model"), (1, 1, 1), (0, 0, 0))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``, rank-major as ``jax.make_mesh``
    (the last axis varies fastest).  Raises unless the world size (1
    without a process group) equals the product of ``shape``.  The rank
    computes on ``device`` (default: the CUDA card, the process's current
    one; ``init_process_group`` returns the device it chose)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                         f"processes, the world has {world}")
    dev = resolve_device(device)
    if world == 1:
        return Mesh(axes, shape, (0,) * len(shape), dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                          shape, mesh_dim_names=axes)
    return Mesh(axes, shape, tuple(int(c) for c in dm.get_coordinate()),
                dev, dm)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production meshes: 16 x 16 ("data", "model"), or
    2 x 16 x 16 ("pod", "data", "model") with ``multi_pod``.  Raises on a
    world of another size, as ``make_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_rules(mesh, *, fsdp_over_pod: bool = False,
               overrides: dict | None = None) -> AxisRules:
    """Sharding rules for a mesh (reads ``axis_names`` and ``shape``).

    Multi-pod: FSDP within a pod and pure data parallelism across pods;
    ``fsdp_over_pod=True`` shards parameters and optimizer state over the
    pod axis too."""
    names = mesh.axis_names
    sizes = mesh_axis_sizes(mesh)
    if "pod" in names:
        fsdp = ("pod", "data") if fsdp_over_pod else ("data",)
        return AxisRules(fsdp_axes=fsdp, dp_axes=("pod", "data"),
                         overrides=overrides or {}, axis_sizes=sizes)
    if "data" in names:
        return AxisRules(fsdp_axes=("data",), dp_axes=("data",),
                         overrides=overrides or {}, axis_sizes=sizes)
    return AxisRules(fsdp_axes=(), dp_axes=(), overrides=overrides or {},
                     axis_sizes=sizes)


# ---------------------------------------------------------------------------
# The fleet mesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class FleetMesh:
    """Devices laid out on named axes: ``devices`` is an object array of
    ``torch.device`` of shape ``(wf, task)``."""
    devices: np.ndarray
    axis_names: tuple[str, ...] = ("wf", "task")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_fleet_mesh(*, wf: int | None = None, task: int = 1,
                    device=None) -> FleetMesh | Mesh:
    """("wf", "task") mesh for the multi-workflow estimator fleet:
    workflows go over "wf", task rows over "task".

    With a default process group of more than one process, a ``Mesh`` of
    the group's processes (``make_mesh``, rank-major, one process a
    place): ``wf`` defaults to the world size over ``task``, and it
    raises unless ``wf * task`` is the world size; the rank computes on
    ``device`` (``make_mesh``'s default: its current card).  Otherwise a
    ``FleetMesh`` of this process's devices: ``device`` (``None``: every
    CUDA card, raising without one; ``"cuda:k"`` that card alone;
    ``"cpu"`` the host), ``wf`` defaulting to all of them after the
    "task" axis takes ``task``.  On one card this is the (1, 1) mesh, on
    which ``shard_fleet`` places the fleet whole."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        if world % task != 0:
            raise ValueError(f"{world} processes not divisible by "
                             f"task={task}")
        return make_mesh((world // task if wf is None else wf, task),
                         ("wf", "task"), device=device)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    if n % task != 0:
        raise ValueError(f"{n} devices not divisible by task={task}")
    if wf is None:
        wf = n // task
    if wf * task > n:
        raise ValueError(f"a ({wf}, {task}) mesh needs {wf * task} "
                         f"devices, {n} available")
    grid = np.empty(wf * task, dtype=object)
    grid[:] = devices[:wf * task]
    return FleetMesh(devices=grid.reshape(wf, task))
