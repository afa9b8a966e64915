"""The port stands alone: importing it pulls in neither ``jax`` nor the
JAX package, and without a GPU its entry points raise instead of carrying
on on the CPU."""

import os
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import gcn_params_from_numpy
from repro_torch.core.paragrapher import open_graph, save_graph
from repro_torch.data import stream_partitions
from repro_torch.distributed import host_submesh, stream_shard_placement
from repro_torch.graph import rmat
from repro_torch.kernels.compbin_decode import decode_packed_stream
from repro_torch.launch.data_gnn import device_batch
from repro_torch.kernels.utils import resolve_device
from repro_torch.query import NeighborQueryEngine

SRC = pathlib.Path(repro_torch.__file__).resolve().parents[1]


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_slice_module_is_present():
    mods = set(_submodules())
    for want in ("core.csr", "core.compbin", "core.webgraph", "core.codec",
                 "core.pgfuse", "core.policy", "core.paragrapher",
                 "obs.trace", "obs.metrics", "obs.report", "kernels.utils",
                 "kernels.build", "kernels.compbin_decode.ref",
                 "kernels.compbin_decode.kernel", "kernels.compbin_decode.ops",
                 "graph.generators", "graph.partition", "data.prefetch",
                 "data.graph_stream", "distributed.sharding", "query.window",
                 "query.engine", "convert", "core.featstore",
                 "graph.features", "graph.sampler",
                 "kernels.segment_sum.ref", "kernels.segment_sum.kernel",
                 "kernels.segment_sum.ops", "models.common",
                 "models.gnn.layers", "models.gnn.gcn", "configs.shapes",
                 "configs.base", "configs.gcn_cora", "launch.data_gnn",
                 "launch.steps", "launch.serve",
                 "kernels.flash_attention.ref",
                 "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops", "models.transformer",
                 "configs.smollm_360m", "configs.qwen2_1_5b",
                 "configs.stablelm_1_6b", "launch.model_flops",
                 "query.hotset", "query.traversal", "query.loadgen",
                 "query.sharded", "optim.adamw", "checkpoint.checkpointer",
                 "distributed.fault_tolerance", "data.multihost",
                 "launch.train", "graph.reorder", "launch.compile_graph",
                 "data.tokens", "configs.qwen2_moe_a2_7b",
                 "configs.dbrx_132b", "models.recsys", "models.recsys.din",
                 "configs.din", "optim.compression", "launch.mesh",
                 "launch.dryrun", "launch.hlo_analysis", "launch.variants",
                 "distributed.elastic"):
        assert f"repro_torch.{want}" in mods, want
    for kernel in ("compbin_decode", "segment_sum", "flash_attention"):
        assert (SRC / "repro_torch" / "csrc" / f"{kernel}.cu").is_file()


def test_importing_the_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {_submodules()!r}\n"
        "import repro_torch\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.') or m == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('imported', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_no_source_file_of_the_port_names_jax_imports():
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for needle in ("import jax", "from jax", "import repro\n",
                       "from repro ", "from repro.", "ml_dtypes"):
            assert needle not in text, (path, needle)


def test_device_none_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host_submesh(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_shard_placement(None, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_packed_stream(np.zeros(6, np.uint8), 3)
    path = str(tmp_path / "g.cbin")
    save_graph(path, rmat(6, 4, seed=0))
    with open_graph(path) as g:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_partitions(g)
        for decode in ("device", "auto"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                NeighborQueryEngine(g, decode=decode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_batch({"x": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn_params_from_numpy({"w0": np.zeros((2, 2), np.float32)})
    from repro_torch.convert import adamw_state_from_numpy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adamw_state_from_numpy({"step": np.int32(0), "m": {}, "v": {}})
    from repro_torch.data.multihost import simulate_hosts
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_hosts(path, 2)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("gcn-cora", reduced=True, steps=1,
                    workdir=str(tmp_path / "train"))
    for arch in ("smollm-360m", "qwen2-moe-a2.7b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.train(arch, reduced=True, steps=1,
                        workdir=str(tmp_path / "lm_train"))
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_gnn_server
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_gnn_server("gcn-cora", get_arch("gcn-cora").make_reduced(),
                        str(tmp_path / "gnn"))
    from repro_torch.convert import transformer_params_from_numpy
    from repro_torch.launch.serve import serve_lm
    lm = get_arch("smollm-360m").make_reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm(lm, batch=1, prompt_len=2, n_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm(get_arch("dbrx-132b").make_reduced(), batch=1,
                 prompt_len=2, n_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer_params_from_numpy(
            {"embed": np.zeros((4, 2)), "layers": {}}, lm)
    from repro_torch.convert import din_params_from_numpy
    from repro_torch.launch.serve import serve_din
    din = get_arch("din").make_reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_din(din, batch=1, n_requests=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        din_params_from_numpy({"item_table": np.zeros((4, 2))})
    for extra in ({}, {"compress_grads": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.train("din", reduced=True, steps=1,
                        workdir=str(tmp_path / "din_train"), **extra)
    from repro_torch.launch import serve as serve_mod
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--arch", "din", "--reduced", "--requests", "2"])


def test_cpu_must_be_asked_for_by_name():
    assert resolve_device("cpu") == torch.device("cpu")
    assert host_submesh("cpu") == torch.device("cpu")
    assert stream_shard_placement("cpu", 10) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        host_submesh("cpu", process_index=3, process_count=2)
    ids, h2d = decode_packed_stream(np.array([1, 0, 0, 2, 1, 0], np.uint8), 3,
                                    device="cpu")
    np.testing.assert_array_equal(ids, [1, 258])
    assert h2d == 1024 * 3


def test_kernel_build_raises_without_a_compiler(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed: the build would succeed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("compbin_decode")       # no fallback, it raises
    with pytest.raises(FileNotFoundError):
        build.load_library("no_such_kernel")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("segment_sum")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("flash_attention")
    assert sorted(p.stem for p in build.CSRC_DIR.glob("*.cu")) == \
        ["compbin_decode", "flash_attention", "segment_sum"]
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


def test_metrics_namespace_matches_the_ported_stats_surfaces():
    from repro_torch.obs.metrics import STATS_SOURCES, metrics_drift
    # every source loads: query, traversal, router, hotset, stream, pgfuse
    assert sorted(STATS_SOURCES) == ["hotset", "pgfuse", "query", "router",
                                     "stream", "traversal"]
    assert metrics_drift() == []
