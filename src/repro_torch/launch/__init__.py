"""Launchers of the port: serving (LM, DIN, GNN inference, traversals:
``python -m repro_torch.launch.serve``), training (``python -m
repro_torch.launch.train``), the graph compiler
(``launch/compile_graph.py``), the model FLOP formulas
(``launch/model_flops.py``), the cell builder (``launch/steps.py``:
``build_cell`` over ``launch/mesh.py``'s meshes and
``launch/variants.py``'s variants) and the dry run (``python -m
repro_torch.launch.dryrun``, its cost readout in
``launch/hlo_analysis.py``)."""
