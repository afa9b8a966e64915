"""PG-Fuse and the placement policy: the port's copies behave exactly as
the JAX package's.  Bytes and integer counters: tolerance ZERO."""

import _torch_env  # noqa: F401  (first: one torch thread)
import dataclasses
import itertools

import numpy as np
import pytest

from _torch_pair import port, ref


@pytest.fixture(scope="module")
def blob_path(tmp_path_factory):
    rng = np.random.default_rng(3)
    p = tmp_path_factory.mktemp("pg") / "blob.bin"
    p.write_bytes(rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes())
    return str(p)


def _read_sequence(n_bytes: int, seed: int):
    rng = np.random.default_rng(seed)
    seq = [(0, 10), (4090, 20), (n_bytes - 5, 50), (0, n_bytes)]
    for _ in range(60):
        off = int(rng.integers(0, n_bytes))
        seq.append((off, int(rng.integers(1, 20_000))))
    return seq


@pytest.mark.parametrize("eviction", ["lru", "clock"])
@pytest.mark.parametrize("readahead", [0, 2])
@pytest.mark.parametrize("budget", [None, 5 * 4096])
def test_same_reads_same_bytes_same_counters(blob_path, eviction, readahead,
                                             budget):
    raw = open(blob_path, "rb").read()
    stats = {}
    for side in (ref, port):
        with side.pgfuse.PGFuseFS(block_size=4096, readahead=readahead,
                                  eviction=eviction,
                                  max_resident_bytes=budget) as fs:
            cf = fs.mount(blob_path)
            for i, (off, size) in enumerate(_read_sequence(len(raw), 9)):
                if i % 7 == 3:
                    cf.prefetch_range(off, size)
                assert cf.pread(off, size) == raw[off:off + size]
            h = fs.open(blob_path)
            h.seek(1234)
            assert h.read(5000) == raw[1234:6234]
            stats[side.name] = fs.stats().as_dict()
            if budget is not None:
                assert fs.resident_bytes <= budget
    assert stats["port"] == stats["ref"]
    assert stats["port"]["underlying_reads"] > 0


def test_pgfuse_constants_and_stats_fields_equal():
    assert port.pgfuse.DEFAULT_BLOCK_SIZE == ref.pgfuse.DEFAULT_BLOCK_SIZE
    assert port.pgfuse.EVICTION_POLICIES == ref.pgfuse.EVICTION_POLICIES
    assert [f.name for f in dataclasses.fields(port.pgfuse.PGFuseStats)] == \
        [f.name for f in dataclasses.fields(ref.pgfuse.PGFuseStats)]


def test_pgfuse_bad_arguments_raise_in_both(blob_path):
    for side in (ref, port):
        with pytest.raises(ValueError):
            side.pgfuse.PGFuseFS(eviction="fifo")
        with pytest.raises(ValueError):
            side.pgfuse.CachedFile(blob_path, block_size=0)


# -- policy -----------------------------------------------------------------

def _plan(p):
    """A plan as a dict, with the free-text ``reason`` set aside: the port
    rewords reasons that name the device, every decision field must be
    equal."""
    d = dataclasses.asdict(p) if dataclasses.is_dataclass(p) else p
    if isinstance(d, dict):
        d = dict(d)
        d.pop("reason", None)
    return d


def _both(fn_name, *args, **kwargs):
    out = []
    for side in (ref, port):
        fn = getattr(side.policy, fn_name)
        try:
            out.append(_plan(fn(*args, **kwargs)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1], (fn_name, args, kwargs)
    return out[1]


def test_policy_constants_keep_their_values():
    assert port.policy.QUERY_DEVICE_MIN_EDGES == \
        ref.policy.QUERY_DEVICE_MIN_EDGES == 4096
    assert dataclasses.asdict(port.policy.SystemModel()) == \
        dataclasses.asdict(ref.policy.SystemModel())


@pytest.mark.parametrize("fmt", ["compbin", "logcsr", "webgraph"])
@pytest.mark.parametrize("b", range(0, 10))
def test_choose_stream_decode_equal(fmt, b):
    _both("choose_stream_decode", fmt, b)


@pytest.mark.parametrize("workload", ["stream", "scan", "sequential", "full",
                                      "sample", "serve", "query", "random",
                                      "bogus"])
@pytest.mark.parametrize("touch", [None, 0.0, 0.49, 0.5, 1.0, 1.5])
def test_choose_access_mode_equal(workload, touch):
    _both("choose_access_mode", workload, touch_fraction=touch)
    if workload != "bogus" and (touch is None or 0 <= touch <= 1):
        # these reasons do not name the device: they stay word for word
        assert port.policy.choose_access_mode(
            workload, touch_fraction=touch).reason == \
            ref.policy.choose_access_mode(
                workload, touch_fraction=touch).reason


@pytest.mark.parametrize("b", [1, 4, 5, 9])
@pytest.mark.parametrize("n_edges", [-1, 0, 4095, 4096, 1 << 20])
@pytest.mark.parametrize("nv", [None, (1 << 31), (1 << 31) + 1])
def test_choose_query_decode_equal(b, n_edges, nv):
    _both("choose_query_decode", n_edges, b, n_vertices=nv)
    _both("choose_query_decode", n_edges, b, n_vertices=nv, min_edges=16)


@pytest.mark.parametrize("n_vertices,n_edges,wg_size",
                         [(1 << 10, 1 << 14, 1 << 12),
                          (1 << 20, 1 << 26, 1 << 24),
                          (1 << 28, 1 << 34, 1 << 30),
                          (1 << 28, 1 << 34, 1 << 36)])
def test_choose_format_and_crossover_equal(n_vertices, n_edges, wg_size):
    assert port.policy.choose_format(n_vertices, n_edges, wg_size) == \
        ref.policy.choose_format(n_vertices, n_edges, wg_size)
    assert port.policy.crossover_size_difference(
        port.policy.SystemModel(), n_edges, n_vertices) == \
        ref.policy.crossover_size_difference(
            ref.policy.SystemModel(), n_edges, n_vertices)


@pytest.mark.parametrize("slo,budget,rate,servers",
                         itertools.product([0.01, 0.5], [1000, 1 << 20],
                                           [1e5, 1e8], [1, 4]))
def test_choose_admission_equal(slo, budget, rate, servers):
    _both("choose_admission", slo, edge_budget=budget,
          service_edges_per_s=rate, servers=servers)


@pytest.mark.parametrize("file_bytes,cache,hot,offered,per_shard",
                         [(1 << 30, 1 << 28, 0.0, None, None),
                          (1 << 30, 1 << 31, 0.6, None, None),
                          (1 << 34, 1 << 28, 0.2, 1e9, 1e8),
                          (1 << 20, 1 << 20, 0.5, 1e6, 1e7)])
def test_choose_shard_plan_equal(file_bytes, cache, hot, offered, per_shard):
    _both("choose_shard_plan", file_bytes, cache_budget_bytes=cache,
          hot_fraction=hot, offered_edges_per_s=offered,
          shard_edges_per_s=per_shard)


@pytest.mark.parametrize("nv,ne,budget",
                         [(1 << 10, 1 << 14, 1 << 16), (1 << 20, 1 << 24, 1 << 26),
                          (1 << 32, 1 << 36, 1 << 30), (0, 0, 1024),
                          (100, 0, 0)])
def test_choose_hotset_admission_equal(nv, ne, budget):
    _both("choose_hotset_admission", nv, ne, budget)


@pytest.mark.parametrize("nv,ne", [(0, 0), (10, 0), (1000, 500), (1000, 16000)])
@pytest.mark.parametrize("strategy", [None, "bfs", "degree", "identity", "x"])
def test_choose_reorder_equal(nv, ne, strategy):
    _both("choose_reorder", nv, ne, strategy=strategy)


@pytest.mark.parametrize("devices", [1, 4, 8, 64])
@pytest.mark.parametrize("procs", [0, 1, 2, 8])
def test_choose_stream_parts_equal(devices, procs):
    _both("choose_stream_parts", devices, procs)


@pytest.mark.parametrize("block,row,nv,procs",
                         [(1 << 16, 64, None, 1), (1 << 16, 64, 1024, 2),
                          (1 << 16, 0, 1 << 20, 4), (4096, 4, 1 << 20, 8),
                          (0, 4, 10, 1)])
def test_choose_feature_align_equal(block, row, nv, procs):
    _both("choose_feature_align", block, row, n_vertices=nv,
          process_count=procs)


def test_reworded_reasons_name_the_gpu_not_the_tpu():
    for fn, args, kw in (("choose_stream_decode", ("compbin", 3), {}),
                         ("choose_query_decode", (1 << 20, 3), {})):
        reason = getattr(port.policy, fn)(*args, **kw).reason
        for word in ("VPU", "Pallas", "VMEM", "TPU"):
            assert word not in reason
