"""Models of the port: the GNNs (``models/gnn/``: GCN, PNA, MeshGraphNet,
DimeNet) and the decoder-only transformer, dense and MoE
(``models/transformer.py``); DIN is not ported yet."""
