"""Production meshes.  A FUNCTION, not a module constant — importing this
module builds no mesh and needs no process group (the tests run
unsharded, the dry run on a fake process group of 256 or 512 ranks).

Each needs a default process group with one rank a device of the mesh,
and takes the device type: the card's (``"cuda"``) by default.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_test_mesh(devices: int = 4, *, device: str = "cuda"):
    """Tiny mesh for CI-class integration tests (data×model square-ish)."""
    from torch.distributed.device_mesh import init_device_mesh
    d = max(1, devices // 2)
    m = max(1, devices // d)
    return init_device_mesh(device, (d, m), mesh_dim_names=("data", "model"))


def mesh_chip_count(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n
