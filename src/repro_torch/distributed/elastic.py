"""Elastic re-meshing: move a checkpointed state onto a different mesh.

Checkpoints store global tensors (``checkpoint/checkpointer.py``), so
elastic scaling is a restore followed by :func:`reshard`, which places
every leaf on the new mesh as a ``DTensor`` by its partition spec
(``torch.distributed.tensor.distribute_tensor`` over
:func:`repro_torch.launch.mesh.device_mesh`).  The default process group
must span the mesh: one process per device.
"""

from __future__ import annotations

from typing import Any

from repro_torch.distributed.sharding import placements, spec_leaves
from repro_torch.optim.adamw import tree_leaves, tree_unflatten


def reshard(tree: Any, mesh, spec_tree: Any) -> Any:
    """Every tensor of ``tree`` distributed over ``mesh`` by its spec in
    ``spec_tree`` (a :class:`~repro_torch.distributed.sharding.P`; None
    means replicated), as DTensors on the mesh's device type (the
    tensors' own).  Raises ``ValueError`` where the two trees' leaf
    counts differ."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import device_mesh

    flat_t = tree_leaves(tree)
    flat_s = spec_leaves(spec_tree)
    if len(flat_t) != len(flat_s):
        raise ValueError(f"tree/spec mismatch: {len(flat_t)} leaves vs "
                         f"{len(flat_s)} specs")
    meshes: dict = {}
    out = []
    for x, spec in zip(flat_t, flat_s):
        kind = x.device.type
        if kind not in meshes:
            meshes[kind] = device_mesh(mesh, kind)
        out.append(distribute_tensor(x, meshes[kind],
                                     list(placements(mesh, spec))))
    return tree_unflatten(tree, out)
