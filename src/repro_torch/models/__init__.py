"""Models of the port: GCN so far (``models/gnn/gcn.py``); PNA,
MeshGraphNet, DimeNet, the transformer and DIN are not ported yet."""
