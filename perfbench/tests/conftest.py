"""Shared fixtures of the benchmark's own tests (CPU, small sizes).

Run from the root of the repository:
``PYTHONPATH=src python -m pytest -q perfbench/tests``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

_GRAPH = {"config": {"scale": 10}, "traffic": {"warmup_requests": 4}}
#: each cell at a size a CPU test can hold: the Graph500 graph at scale
#: 10, gcn-cora at Cora's own size with Kronecker edges at scale 12
TINY = {
    "load.g500-24": _GRAPH,
    "query.g500-24.uniform": _GRAPH,
    "query.g500-24.hubs": _GRAPH,
    "train.gcn-products.full": {"config": {
        "shape": "full_graph_sm", "n_nodes": 2708, "n_edges": 10556,
        "d_in": 1433, "n_classes": 7, "train_nodes": 140,
        "edges": {"scale": 12, "seed": 0}}},
}


@pytest.fixture(scope="session")
def bench():
    from perfbench import run
    return run.load_benchmark()


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
