"""A single-controller device mesh: the port's stand-in for
``jax.sharding.Mesh`` and ``jax.make_mesh``.

The JAX package runs its distributed plans from one process over a mesh of
devices (``shard_map``): A and B are replicated, only the row tables are
sharded, and the outputs come back stacked per shard.  The port keeps that
API with one process driving a list of ``torch.device`` s: shard ``s`` of a
plan runs on ``mesh.devices[s]``, and :func:`repro_torch.core.plan.execute`
returns the whole stacked result, as JAX's does.

Devices may repeat.  ``make_mesh((4,), ("data",), devices=["cuda:0"] * 4)``
runs the whole distributed path — four shards, their tables, their
recovery — on one card, and ``["cpu"] * 4`` does so on the host, where the
plain versions stand in for the kernels.

    mesh = make_mesh((4,), ("data",))                   # cuda:0 … cuda:3
    mesh = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
    plan = plan_spgemm(a, b, mesh=mesh)
"""
from __future__ import annotations

import torch

from .errors import PlanMismatchError


def _canonical(device) -> torch.device:
    """A device with its index spelled out (``cuda`` → ``cuda:<current>``),
    so that two spellings of one card compare and key alike."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
    return d


def same_device(a, b) -> bool:
    """Whether two device spellings name the same device."""
    return _canonical(a) == _canonical(b)


class Mesh:
    """Devices laid out along named axes (one axis is all the planner
    uses).  ``shape[axis]`` is the axis size, as JAX's ``mesh.shape[axis]``
    reads; ``devices`` is the flat list of ``torch.device`` s in mesh
    order, repeats allowed."""

    def __init__(self, devices, axis_names=("data",)):
        self.devices = [_canonical(d) for d in devices]
        self.axis_names = tuple(axis_names)
        if not self.devices:
            raise PlanMismatchError("a mesh needs at least one device",
                                    field="mesh")
        if len(self.axis_names) != 1:
            raise PlanMismatchError(
                f"the port's mesh has one axis, got {self.axis_names}",
                field="mesh", observed=list(self.axis_names))
        self.shape = {self.axis_names[0]: len(self.devices)}

    def key(self) -> tuple:
        """The executor-key fingerprint (JAX ``_mesh_key``): the axis names
        and each position's ``(type, index)``, so a 4-shard mesh on one
        card never shares an executor key with a 4-card mesh."""
        return (self.axis_names,
                tuple((d.type, d.index) for d in self.devices))

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in first-use order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def make_mesh(shape, axis_names=("data",), devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` (one axis).  ``devices=None`` takes
    ``cuda:0 … cuda:n−1`` and raises when the host has fewer cards;
    explicit ``devices`` may repeat."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != 1 or shape[0] < 1:
        raise PlanMismatchError(
            f"the port's mesh has one axis of at least one device, got shape "
            f"{shape}", field="mesh", observed=list(shape))
    n = shape[0]
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise PlanMismatchError(
                f"make_mesh({shape}) needs {n} CUDA cards, the host has "
                f"{have}; pass devices= (they may repeat)", field="mesh",
                observed=int(have), planned=int(n))
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise PlanMismatchError(
            f"make_mesh({shape}) got {len(devices)} devices", field="mesh",
            observed=len(devices), planned=n)
    return Mesh(devices, axis_names)
