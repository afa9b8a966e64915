"""The port's dry-run layer on the CPU: ``CostMode`` on hand-reckoned
programs, the roofline terms, ``collectives_from_profile`` on a
two-process gloo all-reduce against the JAX package's ring model,
``reshard`` (the elastic-restart path of ``tests/test_checkpoint.py``)
on a world of one, ``device_mesh``'s refusal of a size that differs from
the world, the meshes, and the dry-run CLI (``--mesh both``, ``--mesh
card``, an ``--all`` subset) with its record keys."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.elastic import reshard
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun, hlo_analysis as hla
from repro_torch.launch.mesh import (Mesh, card_mesh, device_mesh,
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.steps import _abstract

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _cost(fn, *args):
    cm = hla.CostMode()
    out = _abstract(fn, *args, mode=cm)
    return cm, out


# ---------------------------------------------------------------------------
# CostMode
# ---------------------------------------------------------------------------

def test_costmode_counts_a_matmul_chain():
    """a[64, 32] @ b[32, 16], then + 1, then a sum: 2*64*32*16 product
    FLOPs, 64*16 adds and 64*16 summed; bytes every op's inputs and
    outputs; the peak the two [64, 16] f32 results and the scalar alive
    together."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")

    def f(a, b):
        c = a @ b
        d = c + 1.0
        return d.sum()

    cm, out = _cost(f, a, b)
    assert tuple(out.shape) == () and out.device.type == "cpu"
    assert cm.matmul_flops == 2 * 64 * 32 * 16
    assert cm.elementwise_flops == 64 * 16 + 64 * 16
    mm = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    add = 4 * (64 * 16 + 64 * 16)
    total = 4 * (64 * 16 + 1)
    assert cm.bytes_accessed == mm + add + total
    assert cm.peak_live == 4 * 64 * 16 * 2 + 4
    assert cm.cost()["flops"] == cm.flops


def test_costmode_frees_what_dies_and_keeps_views():
    """A [1024] f32 temporary freed before the next is made: the peak is
    one temporary and the output; a view keeps its storage alive."""
    x = torch.empty(1024, device="meta")

    def f(x):
        t = x * 2.0
        del t
        u = x * 3.0
        v = u.view(32, 32)
        del u
        return v + 1.0, v

    cm, _ = _cost(f, x)
    assert cm.peak_live == 4 * 1024 * 2
    assert cm.live == 4 * 1024 * 2       # both outputs still referenced


def test_costmode_sees_matmul_in_inference_mode():
    a = torch.empty(8, 4, 16, device="meta")
    w = torch.empty(16, 32, device="meta")

    def f(a, w):
        with torch.inference_mode():
            return a @ w

    cm, _ = _cost(f, a, w)
    assert cm.matmul_flops == 2 * 8 * 4 * 16 * 32


def test_costmode_counts_a_scatter_add_and_no_gather():
    msgs = torch.empty(100, 8, device="meta")
    ids = torch.empty(100, dtype=torch.int64, device="meta")

    def f(m, i):
        return torch.zeros(10, 8).index_add_(0, i, m[i % 10])

    cm, _ = _cost(f, msgs, ids)
    assert cm.matmul_flops == 0
    # remainder: 100; index_add_: 100 * 8 source elements
    assert cm.elementwise_flops == 100 + 100 * 8


def test_roofline_terms():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12}
    coll = hla.CollectiveStats({"all-reduce": 1}, {"all-reduce": 9e11}, 4.5e11)
    rl = hla.roofline(cost, coll, 2, model_flops=989e12)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(1.0)
    assert rl.t_collective == pytest.approx(1.0)
    assert rl.useful_ratio == pytest.approx(0.5)
    f32 = hla.roofline([cost], coll, 1, compute_dtype=torch.float32)
    assert f32.t_compute == pytest.approx(989 / 67)
    assert f32.dominant == "compute" and f32.compute_dtype == "float32"
    assert rl.as_dict()["card"] == hla.CARD


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_GLOO = r"""
import json, sys
import torch, torch.distributed as dist
from torch.profiler import ProfilerActivity, profile
from repro_torch.launch.hlo_analysis import collectives_from_profile
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
x = torch.ones(1000, dtype=torch.float32)
with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
    dist.all_reduce(x)
st = collectives_from_profile(prof, 2)
dist.destroy_process_group()
print(json.dumps({"ops": st.ops, "logical": st.logical_bytes,
                  "wire": st.wire_bytes, "sum": float(x[0])}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_collectives_from_a_gloo_all_reduce_match_the_ring_model():
    from repro.launch.hlo_analysis import parse_collectives
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:]
                                                   for o in outs]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got["sum"] == 2.0
    hlo = ("%ar = f32[1000]{0} all-reduce(f32[1000]{0} %x), "
           "replica_groups=[1,2]<=[2], to_apply=%add")
    want = parse_collectives(hlo)
    assert got["ops"] == want.ops == {"all-reduce": 1}
    assert got["logical"] == want.logical_bytes
    assert got["wire"] == pytest.approx(want.wire_bytes)


@pytest.mark.parametrize("kind,n", [("all-reduce", 2), ("all-gather", 4),
                                    ("reduce-scatter", 8),
                                    ("all-to-all", 4),
                                    ("collective-permute", 2)])
def test_ring_model_is_the_jax_packages(kind, n):
    from repro.launch.hlo_analysis import parse_collectives
    op = kind
    hlo = (f"%r = f32[256]{{0}} {op}(f32[256]{{0}} %x), "
           f"replica_groups=[1,{n}]<=[{n}]")
    want = parse_collectives(hlo)
    assert hla.ring_wire_bytes(kind, 1024, n) == pytest.approx(
        want.wire_bytes)


# ---------------------------------------------------------------------------
# meshes and resharding
# ---------------------------------------------------------------------------

def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert multi.tag == "2x16x16" and card_mesh().tag == "1x1"
    assert make_host_mesh(8, model=2).axis_sizes == (4, 2)
    assert make_host_mesh(device="cpu").axis_sizes == (1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(6, model=4)


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_device_mesh_refuses_a_size_other_than_the_world(world_of_one):
    with pytest.raises(ValueError, match="512 devices.*world size is 1"):
        device_mesh(make_production_mesh(multi_pod=True), "cpu")
    dm = device_mesh(Mesh(("data",), (1,)), "cpu")
    assert dm.mesh_dim_names == ("data",)


def test_device_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="none is initialised"):
        device_mesh(card_mesh(), "cpu")


def test_elastic_reshard_roundtrip(tmp_path, world_of_one):
    """Save on one layout, restore, re-shard onto a one-device mesh with
    explicit specs (``tests/test_checkpoint.py``'s elastic path)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import Replicate, Shard

    from repro_torch import checkpoint as ck
    tree = {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": [torch.zeros(2), torch.ones(3)]}}
    ck.save(str(tmp_path), 2, tree)
    step, got = ck.restore_latest(str(tmp_path), tree)
    assert step == 2
    mesh = Mesh(("data",), (1,))
    specs = {"params": {"w": P("data", None), "b": P(None)},
             "opt": {"step": P(), "m": [P(None), None]}}
    moved = reshard(got, mesh, specs)
    w = moved["params"]["w"]
    assert isinstance(w, DTensor) and w.placements == (Shard(0),)
    assert moved["opt"]["m"][1].placements == (Replicate(),)
    np.testing.assert_array_equal(w.full_tensor().numpy(),
                                  tree["params"]["w"].numpy())
    assert moved["params"]["b"].dtype == torch.bfloat16
    again = reshard(moved["params"], mesh, specs["params"])
    assert torch.equal(again["w"].full_tensor(), tree["params"]["w"])


def test_reshard_tree_spec_mismatch_raises(world_of_one):
    with pytest.raises(ValueError, match="tree/spec mismatch: 2 leaves vs "
                                         "1 specs"):
        reshard({"a": torch.zeros(2), "b": torch.zeros(2)}, card_mesh(),
                {"a": P(None)})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(args, tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *args, "--out", str(out)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out) as f:
        return json.load(f), res.stdout


def test_cli_pod_meshes_check_divisibility(tmp_path):
    data, stdout = _cli(["--arch", "gcn-cora", "--shape", "full_graph_sm",
                         "--mesh", "both"], tmp_path)
    assert set(data) == {"gcn-cora|full_graph_sm|16x16|baseline",
                         "gcn-cora|full_graph_sm|2x16x16|baseline"}
    for key, rec in data.items():
        assert rec["status"] == "OK" and rec["cost"] is None
        assert "SPMD" in rec["cost_reason"]
        chk = rec["sharding"]
        assert chk["indivisible"] == [] and chk["sharded_dims"] > 0
        n = rec["n_devices"]
        assert n == (512 if key.endswith("2x16x16|baseline") else 256)
        assert chk["per_device_argument_bytes"] < chk["argument_bytes"]
    assert stdout.count('"status": "OK"') == 2


def test_cli_card_record_keys(tmp_path):
    data, _ = _cli(["--arch", "gcn-cora", "--shape", "molecule"], tmp_path)
    rec = data["gcn-cora|molecule|1x1|baseline"]
    assert rec["status"] == "OK" and rec["kind"] == "train"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_est_bytes", "card_peak_est_bytes"}
    assert set(rec["cost"]) >= {"flops", "bytes_accessed", "transcendentals"}
    assert rec["collectives"] == {"ops": {}, "logical_bytes": {},
                                  "wire_bytes": 0.0}
    assert rec["roofline"]["n_devices"] == 1
    assert rec["roofline"]["compute_dtype"] == "float32"
    assert rec["kernels_counted_as"] == "plain" and rec["trace_s"] > 0
    assert rec["memory"]["peak_est_bytes"] >= rec["memory"]["argument_bytes"]


def test_all_subset_writes_ok_and_skip(tmp_path):
    out = str(tmp_path / "all.json")
    cells = [("gcn-cora", "molecule"), ("din", "serve_p99"),
             ("qwen2-1.5b", "long_500k")]
    fails = dryrun._run_all(["card"], out, "baseline", False, 300, jobs=3,
                            cells=cells)
    assert fails == 0
    with open(out) as f:
        data = json.load(f)
    assert {k: v["status"] for k, v in data.items()} == {
        "gcn-cora|molecule|1x1|baseline": "OK",
        "din|serve_p99|1x1|baseline": "OK",
        "qwen2-1.5b|long_500k|1x1|baseline": "SKIP"}
    assert "sub-quadratic" in data["qwen2-1.5b|long_500k|1x1|baseline"][
        "skip_reason"]


def test_run_cells_in_a_pool_equals_in_process():
    cells = [("gcn-cora", "molecule", "baseline"),
             ("pna", "molecule", "baseline")]
    one = dryrun.run_cells(cells, "card", jobs=1)
    two = dryrun.run_cells(cells, "card", jobs=2)
    for a, b in zip(one, two):
        assert a["cost"] == b["cost"] and a["memory"] == b["memory"]
        assert a["outputs"] == b["outputs"]


def test_a_cell_past_its_timeout_is_a_timeout_record(tmp_path, monkeypatch):
    import time
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: time.sleep(30))
    seen = []
    t0 = time.perf_counter()
    recs = dryrun.run_cells([("gcn-cora", "molecule", "baseline")], "card",
                            timeout=1, on_record=seen.append)
    assert time.perf_counter() - t0 < 10
    assert recs == seen and recs[0]["status"] == "TIMEOUT"
    assert dryrun.record_key(recs[0]) == "gcn-cora|molecule|1x1|baseline"
