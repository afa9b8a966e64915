"""Launchers of the port: GCN inference serving
(``python -m repro_torch.launch.serve``)."""
