"""Meshes of the port: an abstract description, axis names and sizes.

The JAX package's meshes (``jax.make_mesh``) hold devices; the port's
spec builders (``distributed/sharding.py``) read only the axis sizes, so
a :class:`Mesh` here is the counterpart of JAX's ``AbstractMesh``: the
16x16 and 2x16x16 production meshes exist without 256 devices.  The one
H100 is the 1x1 ``("data", "model")`` mesh.  :func:`device_mesh` turns a
mesh into a ``torch.distributed`` ``DeviceMesh`` where a process group of
the mesh's size exists.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, in mesh order (major first)."""
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def tag(self) -> str:
        """``"16x16"``, ``"2x16x16"``, ``"1x1"``: the dry-run's mesh key."""
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(n_devices: int | None = None, *, model: int = 1,
                   device=None) -> Mesh:
    """A ``(data, model)`` mesh over the local devices: ``n_devices``, or
    every CUDA device where ``device`` is None or a CUDA device (None
    raises without one), or a 1x1 mesh where the caller asks for the
    CPU."""
    n = n_devices
    if n is None:
        dev = resolve_device(device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    return Mesh(("data", "model"), (n // model, model))


def card_mesh() -> Mesh:
    """The 1x1 ``("data", "model")`` mesh of one card."""
    return Mesh(("data", "model"), (1, 1))


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """``mesh`` as a ``torch.distributed.device_mesh.DeviceMesh`` with the
    same ``mesh_dim_names`` over the default process group, whose world
    size must equal the mesh size (raises ``ValueError`` naming both
    otherwise, or where no process group exists)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"mesh {mesh.tag} of {mesh.size} devices needs a "
                         f"process group of world size {mesh.size}; none "
                         f"is initialised")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.tag} has {mesh.size} devices but the "
                         f"process group's world size is {world}")
    return init_device_mesh(device_type, tuple(mesh.axis_sizes),
                            mesh_dim_names=tuple(mesh.axis_names))
