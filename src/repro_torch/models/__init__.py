"""Models of the port: the GNNs (``models/gnn/``: GCN, PNA, MeshGraphNet,
DimeNet), the decoder-only transformer, dense and MoE
(``models/transformer.py``), and DIN (``models/recsys/din.py``)."""
