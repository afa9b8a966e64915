from repro_torch.models.gnn import dimenet, gcn, meshgraphnet, pna  # noqa: F401
