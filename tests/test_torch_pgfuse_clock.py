"""PG-Fuse's clock eviction in the port: the hand walks a standing
residency mask, and revokes the same blocks in the same order as the JAX
package's snapshot walk.  Blocks, hand, reference bits and counters:
tolerance ZERO."""

import _torch_env  # noqa: F401  (first: one torch thread)
import sys
import threading
import time

import numpy as np
import pytest

from _torch_pair import port, ref

BS = 256


def _blob(tmp_path, name: str, n_blocks: int, seed: int):
    """A file of ``n_blocks`` blocks whose last block is short."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, n_blocks * BS - BS // 3,
                       dtype=np.uint8).tobytes()
    p = tmp_path / name
    p.write_bytes(raw)
    return str(p), raw


def _calls(n_bytes: int, n_calls: int, seed: int):
    """(prefetch first?, offset, size): uniform cold reads, a quarter of
    them on a small re-touched region so reference bits matter."""
    rng = np.random.default_rng(seed)
    hot = 20 * BS
    for _ in range(n_calls):
        span = hot if rng.random() < 0.25 else n_bytes
        off = int(rng.integers(0, span))
        yield bool(rng.random() < 0.5), off, int(rng.integers(1, 3 * BS))


def _mount(side, path, scope: str, budget: int, readahead: int):
    if scope == "mount":
        fs = side.pgfuse.PGFuseFS(block_size=BS, eviction="clock",
                                  readahead=readahead,
                                  max_resident_bytes=budget)
        return fs, fs.mount(path)
    fs = side.pgfuse.PGFuseFS(block_size=BS, eviction="clock",
                              readahead=readahead)
    return fs, fs.mount(path, max_resident_bytes=budget)


@pytest.mark.parametrize("scope, n_blocks, budget_blocks, readahead, seed", [
    ("mount", 300, 12, 0, 1),
    ("mount", 400, 8, 2, 2),
    ("file", 200, 16, 0, 3),
    ("file", 350, 10, 2, 4),
])
def test_victims_hand_and_bytes_equal_the_reference_every_call(
        tmp_path, scope, n_blocks, budget_blocks, readahead, seed):
    path, raw = _blob(tmp_path, "g.bin", n_blocks, seed)
    budget = budget_blocks * BS
    (fs_r, cf_r), (fs_p, cf_p) = (
        _mount(side, path, scope, budget, readahead) for side in (ref, port))
    try:
        for i, (pre, off, size) in enumerate(
                _calls(len(raw), 3000, seed + 100)):
            for cf in (cf_r, cf_p):
                if pre:
                    cf.prefetch_range(off, size)
                assert cf.pread(off, size) == raw[off:off + size], i
            res_r, res_p = cf_r.resident_blocks(), cf_p.resident_blocks()
            assert res_p.dtype == np.int64
            assert np.array_equal(res_p, res_r), i
            assert cf_p._clock_hand == cf_r._clock_hand, i
            assert np.array_equal(cf_p._ref, cf_r._ref), i
            assert cf_p.stats.as_dict() == cf_r.stats.as_dict(), i
            assert fs_p.resident_bytes == fs_r.resident_bytes <= budget, i
        assert cf_p.stats.evictions > 1000
    finally:
        fs_r.unmount()
        fs_p.unmount()


def _side_by_side(tmp_path, n_blocks: int, seed: int):
    path, _ = _blob(tmp_path, f"s{seed}.bin", n_blocks, seed)
    return [side.pgfuse.CachedFile(path, block_size=BS, eviction="clock")
            for side in (ref, port)]


def _assert_same_state(cf_r, cf_p, freed_r, freed_p):
    assert freed_p == freed_r
    assert np.array_equal(cf_p.resident_blocks(), cf_r.resident_blocks())
    assert cf_p._clock_hand == cf_r._clock_hand
    assert np.array_equal(cf_p._ref, cf_r._ref)
    assert np.array_equal(cf_p._statuses.snapshot(),
                          cf_r._statuses.snapshot())
    assert cf_p.stats.as_dict() == cf_r.stats.as_dict()


@pytest.mark.parametrize("seed", range(6))
def test_sweep_from_any_state_equals_the_reference(tmp_path, seed):
    """Random residency, reference bits, pins, hand (``n_blocks``
    included) and need: one sweep leaves both sides in the same state."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 300))
    cfs = _side_by_side(tmp_path, n, seed)
    try:
        for _trial in range(20):
            installed = np.flatnonzero(rng.random(n) < rng.random())
            pinned = installed[rng.random(installed.size) < 0.2]
            bits = rng.random(n) < rng.random()
            hand = int(rng.integers(0, n + 1))
            need = int(rng.integers(0, (installed.size + 2) * BS))
            freed = []
            for cf in cfs:
                for b in installed:
                    cf.acquire_block(int(b))
                    cf.release_block(int(b))
                for b in pinned:
                    cf.acquire_block(int(b))
                cf._ref[:] = False  # bits only on resident blocks
                res = cf.resident_blocks()
                cf._ref[res] = bits[res]
                cf._clock_hand = hand
                freed.append(cf.sweep(need))
            _assert_same_state(*cfs, *freed)
            for cf in cfs:
                for b in pinned:
                    cf.release_block(int(b))
    finally:
        for cf in cfs:
            cf.close()


@pytest.mark.parametrize("seed", range(3))
def test_sweep_keeps_the_bits_of_blocks_not_resident(tmp_path, seed):
    """A bit set on a block that is not resident (one another thread is
    installing) is not passed by the hand: the sweep leaves it set, as
    the reference's snapshot walk does."""
    rng = np.random.default_rng(50 + seed)
    n = int(rng.integers(40, 300))
    cfs = _side_by_side(tmp_path, n, 50 + seed)
    try:
        for _trial in range(20):
            installed = np.flatnonzero(rng.random(n) < rng.random())
            bits = rng.random(n) < rng.random()
            hand = int(rng.integers(0, n + 1))
            need = int(rng.integers(0, (installed.size + 2) * BS))
            freed = []
            for cf in cfs:
                for b in installed:
                    cf.acquire_block(int(b))
                    cf.release_block(int(b))
                cf._ref[:] = bits
                cf._clock_hand = hand
                resident = cf.resident_blocks()
                freed.append(cf.sweep(need))
            _assert_same_state(*cfs, *freed)
            outside = np.setdiff1d(np.arange(n), resident)
            assert np.array_equal(cfs[1]._ref[outside], bits[outside])
    finally:
        for cf in cfs:
            cf.close()


def test_sweep_with_every_block_pinned_frees_nothing_and_ends(tmp_path):
    cfs = _side_by_side(tmp_path, 6, 7)
    try:
        freed = []
        for cf in cfs:
            for b in range(6):  # readers that never release
                cf.acquire_block(b)
            cf._clock_hand = 4
            freed.append(cf.sweep(10 * BS))
        assert freed == [0, 0]
        _assert_same_state(*cfs, *freed)
        assert not cfs[1]._ref.any()  # both laps passed every block
        for cf in cfs:
            for b in range(6):
                cf.release_block(b)
    finally:
        for cf in cfs:
            cf.close()


def test_first_lap_clears_bits_and_second_lap_revokes(tmp_path):
    cfs = _side_by_side(tmp_path, 10, 8)
    try:
        freed = []
        for cf in cfs:
            for b in (1, 2, 4, 7, 9):
                cf.acquire_block(b)
                cf.release_block(b)
            cf._ref[:] = False
            cf._ref[[1, 2, 4, 7, 9]] = True  # every resident bit set
            cf._clock_hand = 5
            freed.append(cf.sweep(2 * BS))
        _assert_same_state(*cfs, *freed)
        # lap 1 cleared 7, 9, 1, 2, 4; lap 2 revoked 7, the short last
        # block 9 and, wrapping, 1
        assert freed[1] == 2 * BS + (BS - BS // 3)
        assert cfs[1].resident_blocks().tolist() == [2, 4]
        assert cfs[1]._clock_hand == 2
        freed = [cf.sweep(1) for cf in cfs]  # the hand goes on from 2
        _assert_same_state(*cfs, *freed)
        assert cfs[1].resident_blocks().tolist() == [4]
    finally:
        for cf in cfs:
            cf.close()


@pytest.mark.parametrize("scope", ["mount", "file"])
def test_clock_eviction_takes_no_snapshot(tmp_path, monkeypatch, scope):
    """The clock path never lists the resident blocks: with
    ``resident_blocks`` raising, a full cache still evicts, stays inside
    its budget and serves the file's bytes."""
    def no_snapshot(self):
        raise AssertionError("clock eviction listed the resident blocks")

    path, raw = _blob(tmp_path, "g.bin", 300, 11)
    budget = 12 * BS
    fs, cf = _mount(port, path, scope, budget, 0)
    monkeypatch.setattr(port.pgfuse.CachedFile, "resident_blocks",
                        no_snapshot)
    try:
        rng = np.random.default_rng(12)
        for _ in range(400):
            off = int(rng.integers(0, len(raw)))
            size = int(rng.integers(1, 3 * BS))
            cf.prefetch_range(off, size)
            assert cf.pread(off, size) == raw[off:off + size]
            assert fs.resident_bytes <= budget
        assert cf.stats.evictions > 200
    finally:
        monkeypatch.undo()
        fs.unmount()


def test_threaded_clock_eviction_keeps_bytes_budget_and_mask(tmp_path):
    """8 threads of random span fetches and reads on one mount under a
    tight clock budget; every call is watched against its own deadline,
    so a hang fails instead of stalling the suite."""
    n_threads, n_calls, call_timeout = 8, 300, 10.0
    path, raw = _blob(tmp_path, "g.bin", 200, 21)
    budget = 12 * BS
    fs = port.pgfuse.PGFuseFS(block_size=BS, eviction="clock",
                              max_resident_bytes=budget)
    cf = fs.mount(path)
    started = [None] * n_threads   # start time of each thread's call
    errors = []

    def work(t: int) -> None:
        try:
            rng = np.random.default_rng(100 + t)
            for _ in range(n_calls):
                off = int(rng.integers(0, len(raw)))
                size = int(rng.integers(1, 3 * BS))
                started[t] = time.monotonic()
                if rng.random() < 0.5:
                    cf.prefetch_range(off, size)
                data = cf.pread(off, size)
                started[t] = None
                if data != raw[off:off + size]:
                    errors.append((t, off, size))
        except Exception as e:  # reported by the main thread
            errors.append((t, repr(e)))

    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            now = time.monotonic()
            late = [t for t, s in enumerate(started)
                    if s is not None and now - s > call_timeout]
            assert not late, f"calls of threads {late} hung"
            time.sleep(0.02)
        for th in threads:
            th.join(timeout=call_timeout)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not errors, errors[:5]
        assert cf.stats.evictions > 0
        assert fs.resident_bytes == cf.resident_bytes <= budget
        installed = np.array([blk is not None for blk in cf._blocks])
        assert np.array_equal(cf._resident_mask, installed)
        assert cf.resident_bytes == sum(
            len(blk) for blk in cf._blocks if blk is not None)
        states = set(cf._statuses.snapshot().tolist())
        assert states <= {port.pgfuse.LOADED, port.pgfuse.NOT_LOADED}
    finally:
        fs.unmount()
