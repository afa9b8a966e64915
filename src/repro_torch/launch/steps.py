"""Model lookup by arch id, where the JAX package keeps its own.

The JAX package's cell assembly (jit steps, shardings, input specs) waits
for the port of the distribution layer; the serving path needs only
the module table.
"""

from __future__ import annotations

from repro_torch.models.gnn import gcn

_GNN_MODULES = {"gcn-cora": gcn}
