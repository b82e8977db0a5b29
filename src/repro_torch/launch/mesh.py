"""The fleet mesh.

Port of ``repro.launch.mesh``'s ``make_fleet_mesh``: the ``("wf",
"task")`` mesh of the multi-workflow estimator fleet
(``repro_torch.online.fleet``).  One card is the (1, 1) mesh.  The
production and training meshes come with the training slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device


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
                    device=None) -> FleetMesh:
    """("wf", "task") mesh for the multi-workflow estimator fleet:
    workflows go over "wf", task rows over "task".  ``device`` (``None``:
    every CUDA card, raising without one; ``"cuda:k"`` that card alone;
    ``"cpu"`` the host) gives the devices; ``wf`` defaults to all of them
    after the "task" axis takes ``task``.  On one card this is the (1, 1)
    mesh, on which ``shard_fleet`` places the fleet whole."""
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
