"""The device mesh of the row split.

Counterpart of ctts_tpu/parallel/mesh.py:20-32. Synthesis is
independent per sentence, so a 1-D mesh splits a batch's rows over its
devices in order, each device holding a replica of the voice bank; the
forward path needs no collective. Here a mesh is the ordered tuple of
`torch.device`s: a device may appear more than once (`[cpu] * 4` in the
tests, `[cuda:0, cuda:0]` for a split proven on one card), as JAX runs
a mesh of virtual CPU devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ctts_tpu_torch.env import device as cuda_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: shard d of a batch runs on devices[d]."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given devices (default: every CUDA device).

    Without a card the default raises, as env.device() does: a mesh
    never falls to the CPU on its own. An explicit list may repeat a
    device; it must be of one device type, CPU or CUDA."""
    if devices is None:
        cuda_device()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"make_mesh: mixed device types {sorted(kinds)}")
    kind = kinds.pop()
    if kind == "cuda":
        cuda_device()
        current = torch.cuda.current_device()
        devs = tuple(torch.device("cuda", current if d.index is None
                                  else d.index) for d in devs)
    elif kind != "cpu":
        raise ValueError(f"make_mesh: unsupported device type {kind!r}")
    return Mesh(devs)


def first_device(mesh: Optional[Mesh], device):
    """The device of a caller given a mesh or a device (or neither): the
    mesh's first device, else `device`. Raises on a mesh that is not a
    Mesh, and on both."""
    if mesh is None:
        return device
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh: want a ctts_tpu_torch.parallel.mesh.Mesh, "
                        f"got {type(mesh).__name__}")
    if device is not None:
        raise ValueError("a mesh or a device, not both")
    return mesh.devices[0]
