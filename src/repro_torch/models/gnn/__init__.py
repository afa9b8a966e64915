from repro_torch.models.gnn import gcn  # noqa: F401
