"""Models of the port: GCN (``models/gnn/gcn.py``) and the dense
decoder-only transformer (``models/transformer.py``, serving half); PNA,
MeshGraphNet, DimeNet, the MoE FFN and DIN are not ported yet."""
