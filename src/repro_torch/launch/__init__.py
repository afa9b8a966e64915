"""Launchers of the port: serving (LM, DIN, GNN inference, traversals:
``python -m repro_torch.launch.serve``), training (``python -m
repro_torch.launch.train``), the graph compiler
(``launch/compile_graph.py``) and the model FLOP formulas
(``launch/model_flops.py``)."""
