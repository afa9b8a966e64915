"""Launchers of the port: LM serving and GCN inference serving
(``python -m repro_torch.launch.serve``) and the LM FLOP formula
(``launch/model_flops.py``)."""
