"""Model lookup by arch id, where the JAX package keeps its own.

Still owed here (ROADMAP Queue 1 item 7): the JAX package's cell
assembly, ``build_cell`` and its cells (jit steps, shardings), with
``configs/shapes.py``'s ``*_input_specs``, the spec functions of
``distributed/sharding.py`` and the mesh / dry-run / HLO-analysis /
variants launchers around them.  The serving and training paths need
only the GNN module table and the configs of the GNN shape catalog.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs import get_arch
from repro_torch.models.gnn import dimenet as m_dimenet
from repro_torch.models.gnn import gcn as m_gcn
from repro_torch.models.gnn import meshgraphnet as m_mgn
from repro_torch.models.gnn import pna as m_pna

_GNN_MODULES = {
    "gcn-cora": m_gcn, "pna": m_pna, "dimenet": m_dimenet,
    "meshgraphnet": m_mgn,
}


def _gnn_config(arch_id: str, shape) -> Any:
    """The full config of ``arch_id`` sized by a ``GNNShape``'s feature
    width (and class count, where the model classifies)."""
    spec = get_arch(arch_id)
    if arch_id in ("gcn-cora", "pna"):
        return spec.make_config(d_in=shape.d_feat, n_classes=shape.n_classes)
    if arch_id == "dimenet":
        return spec.make_config(d_in=shape.d_feat)
    if arch_id == "meshgraphnet":
        return spec.make_config(d_node_in=shape.d_feat)
    raise KeyError(arch_id)
