"""Storage-fault injection over the port's PG-Fuse, loader and query
engine (``tests/conftest.py`` FaultyStorage): transient EIO, short reads
and latency must surface deterministically — never hang a reader, never
hand truncated bytes downstream — and the readahead path must keep
running through injected latency.

Every case of ``tests/test_fault_injection.py`` runs here on BOTH
packages (``side`` = the JAX package or the port on ``device="cpu"``)
with the same assertions, so the exact counts each pins (underlying
calls, retried reads, readahead blocks) hold the port to the reference's
behaviour.  Unlike the reference's copy, the stream case installs its
fault BEFORE the stream is built, so the reader thread cannot win the
race.  The engine arm: a query engine over a faulty mount raises
``OSError`` from ``neighbors_batch`` and from ``submit(...).result``,
and answers again once the fault has passed.
"""

import errno
import types

import numpy as np
import pytest

import repro.data.graph_stream
import repro_torch.data.graph_stream
from _torch_pair import assert_csr_equal, port, ref, write_pair
from repro.query import NeighborQueryEngine as RefEngine
from repro_torch.query import NeighborQueryEngine as PortEngine
from tests.conftest import FaultyStorage

BLOCK = 1024

SIDES = {
    "ref": types.SimpleNamespace(
        pkg=ref, device=None, engine=RefEngine, engine_kw={},
        stream_partitions=repro.data.graph_stream.stream_partitions,
        assemble_csr=repro.data.graph_stream.assemble_csr),
    "port": types.SimpleNamespace(
        pkg=port, device="cpu", engine=PortEngine,
        engine_kw={"device": "cpu"},
        stream_partitions=repro_torch.data.graph_stream.stream_partitions,
        assemble_csr=repro_torch.data.graph_stream.assemble_csr),
}


@pytest.fixture(params=sorted(SIDES))
def side(request):
    return SIDES[request.param]


def _stream(side, g, **kw):
    return side.stream_partitions(g, side.device, **kw)


def _open(side, path, **kw):
    return side.pkg.paragrapher.open_graph(path, use_pgfuse=True,
                                           pgfuse_block_size=BLOCK, **kw)


@pytest.fixture
def data_file(tmp_path):
    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 4 * BLOCK, dtype=np.uint8).tobytes()
    p = str(tmp_path / "blob.bin")
    with open(p, "wb") as f:
        f.write(payload)
    return p, payload


@pytest.fixture
def graph_file(tmp_path):
    csr = ref.graph.erdos_renyi(1 << 9, 1 << 13, seed=11)
    return write_pair(tmp_path, csr.offsets, csr.neighbors, "compbin"), csr


def test_transient_eio_surfaces_then_recovers(side, data_file,
                                              faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK)
    try:
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install(cf)
        with pytest.raises(OSError) as exc:
            cf.pread(0, len(payload))
        assert exc.value.errno == errno.EIO
        assert cf.pread(0, len(payload)) == payload
    finally:
        cf.close()


def test_short_read_of_requested_block_raises_not_hangs(side, data_file,
                                                        faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK)
    try:
        faulty_storage.truncate_at[1] = 100  # < one block
        faulty_storage.install(cf)
        with pytest.raises(IOError, match="short read"):
            cf.pread(0, len(payload))
        assert cf.pread(0, len(payload)) == payload  # fault was transient
    finally:
        cf.close()


def test_short_read_drops_readahead_blocks_only(side, data_file,
                                                faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK, readahead=3)
    try:
        faulty_storage.truncate_at[1] = BLOCK
        faulty_storage.install(cf)
        assert cf.pread(0, len(payload)) == payload
        assert faulty_storage.n_calls == 2  # blocks 1..3 refetched as a run
        assert cf.stats.readahead_blocks == 2  # call 2: b=1 + ahead {2,3}
    finally:
        cf.close()


def test_async_read_surfaces_storage_error(side, graph_file,
                                           faulty_storage):
    path, _ = graph_file
    with _open(side, path) as g:
        plan = g.partition_plan(4)
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install_graph(g)
        got = []
        ar = g.read_async(plan, lambda buf: got.append(buf.error),
                          n_workers=1)
        with pytest.raises(OSError):
            ar.wait(timeout=30)  # surfaces the EIO, does NOT time out
        assert ar.done
        assert any(isinstance(e, OSError) for e in got)


def test_stream_surfaces_storage_error_not_hang(side, graph_file,
                                                faulty_storage):
    path, _ = graph_file
    with _open(side, path) as g:
        # the offsets are warm in the block cache, so building the stream
        # reads no storage; the fault goes in BEFORE the stream exists,
        # so its reader thread cannot fetch a block ahead of the injector
        g.partition_plan(4)
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install_graph(g)
        stream = _stream(side, g, n_parts=4, n_workers=1)
        with pytest.raises(OSError):
            with stream:
                list(stream)


def test_stream_recovers_after_transient_error(side, graph_file,
                                               faulty_storage):
    path, csr = graph_file
    with _open(side, path) as g:
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install_graph(g)
        with pytest.raises(OSError):
            with _stream(side, g, n_parts=4, n_workers=1) as s:
                list(s)
        with _stream(side, g, n_parts=4) as stream:
            assert_csr_equal(side.assemble_csr(list(stream)), csr)


def test_retry_policy_absorbs_transient_eio(side, data_file,
                                            faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK, retries=2,
                                    retry_backoff_s=1e-4)
    try:
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install(cf)
        assert cf.pread(0, len(payload)) == payload  # no exception escapes
        assert cf.stats.retried_reads == 1
        assert faulty_storage.n_calls >= 2  # the retry really hit storage
    finally:
        cf.close()


def test_retry_policy_is_bounded(side, data_file, faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK, retries=1,
                                    retry_backoff_s=1e-4)
    try:
        for i in (1, 2):  # first attempt AND its one retry both fail
            faulty_storage.fail_at[i] = OSError(errno.EIO, "dead OST")
        faulty_storage.install(cf)
        with pytest.raises(OSError) as exc:
            cf.pread(0, len(payload))
        assert exc.value.errno == errno.EIO
        assert cf.stats.retried_reads == 1  # exactly one retry was spent
        assert cf.pread(0, len(payload)) == payload
    finally:
        cf.close()


def test_retry_policy_through_graph_stream(side, graph_file,
                                           faulty_storage):
    path, csr = graph_file
    with _open(side, path, pgfuse_retries=2,
               pgfuse_retry_backoff_s=1e-4) as g:
        faulty_storage.fail_at[1] = OSError(errno.EIO, "flaky OST")
        faulty_storage.install_graph(g)
        with _stream(side, g, n_parts=4) as stream:
            assert_csr_equal(side.assemble_csr(list(stream)), csr)
        assert g.pgfuse_stats().retried_reads == 1


def test_retry_does_not_mask_short_reads(side, data_file, faulty_storage):
    path, payload = data_file
    cf = side.pkg.pgfuse.CachedFile(path, block_size=BLOCK, retries=3,
                                    retry_backoff_s=1e-4)
    try:
        faulty_storage.truncate_at[1] = 100
        faulty_storage.install(cf)
        with pytest.raises(IOError, match="short read"):
            cf.pread(0, len(payload))
        assert cf.stats.retried_reads == 0
    finally:
        cf.close()


def test_readahead_runs_through_injected_latency(side, graph_file):
    path, csr = graph_file
    calls = {}
    for ra in (0, 4):
        with _open(side, path, pgfuse_readahead=ra) as g:
            fs = FaultyStorage(latency_s=5e-4)
            fs.install_graph(g)
            with _stream(side, g, n_parts=4) as stream:
                assert_csr_equal(side.assemble_csr(list(stream)), csr)
            calls[ra] = fs.n_calls
            if ra:
                assert stream.stats.readahead_blocks > 0
    assert calls[4] < calls[0], calls


def test_underlying_calls_match_the_reference(graph_file):
    """The same fault-free streamed load sends storage the same requests
    from both packages: (block, run length, bytes) for every call."""
    path, _ = graph_file
    seen = {}
    for name, side in SIDES.items():
        with _open(side, path, pgfuse_readahead=4) as g:
            fs = FaultyStorage().install_graph(g)
            with _stream(side, g, n_parts=4, n_workers=1) as stream:
                list(stream)
            seen[name] = sorted(c[1:] for c in fs.calls)
    assert seen["port"] == seen["ref"]


@pytest.mark.parametrize("decode", ["host", "device"])
def test_engine_over_faulty_mount_raises_not_hangs(side, graph_file, decode):
    """A query engine over a mount whose storage fails raises ``OSError``
    from the direct path and from the async path's future (within its
    timeout, no hang), leaks no pending request, and answers correctly
    once the fault has passed."""
    path, csr = graph_file
    vs = np.arange(0, csr.n_vertices, 5, dtype=np.int64)
    with _open(side, path, pgfuse_readahead=0) as g, \
            side.engine(g, decode=decode, window_s=0.01,
                        **side.engine_kw) as eng:
        fs = FaultyStorage().install_graph(g)
        fs.fail_at[1] = OSError(errno.EIO, "dead OST")
        with pytest.raises(OSError):
            eng.neighbors_batch(vs)
        fs.fail_at[fs.n_calls + 1] = OSError(errno.EIO, "dead OST")
        fut = eng.submit(vs[::-1])
        with pytest.raises(OSError):
            fut.result(timeout=30)
        for v, got in zip(vs, eng.neighbors_batch(vs)):
            np.testing.assert_array_equal(got, csr.neighbors_of(int(v)))
        got = eng.submit(vs[:7]).result(timeout=30)
        for v, nbrs in zip(vs[:7], got):
            np.testing.assert_array_equal(nbrs, csr.neighbors_of(int(v)))
        assert eng.stats.batches == 2
