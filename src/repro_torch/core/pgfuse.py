"""PG-Fuse — large-block caching file layer (paper §III).

The paper observes that the Java WebGraph reader issues frequent small
(<=128 kB) reads, under-utilizing high-bandwidth storage (SSD pools, Lustre)
and defeating read-ahead prefetchers.  PG-Fuse interposes a *filesystem in
user space* that (i) enlarges requested blocks (default **32 MiB**),
(ii) reduces the number of calls into the underlying filesystem, and
(iii) caches received blocks in memory for future calls.

Hardware adaptation (DESIGN.md §2): on a managed GPU host we cannot (and
need not) mount a kernel VFS layer, so the interposition point moves from
FUSE/VFS to the loader's file abstraction: :class:`CachedFile` implements
the same ``pread``/file interface every consumer in this framework uses
(CompBin reader, WebGraph reader, token-shard reader), which preserves the
paper's independence argument — the consumer is unmodified.

Block state machine (paper Fig. 1), one integer status per block, all
transitions via compare-and-swap:

      0   loaded and accessible (idle)
      >0  number of concurrent reader threads (counter)
     -1   not loaded
     -2   a thread is loading the block; others must wait
     -3   the block is being revoked (eviction by last-access time)

Transitions::

     -1 --cas--> -2 --load--> 1 --release--> 0 --acquire--> 1,2,3,...
      0 --cas--> -3 --free--> -1

Replacement policy (access-pattern split): sequential scans want pure
recency (LRU) — every block is touched once and never again, so evicting
the oldest is exact.  Random adjacency queries ("Making Caches Work for
Graph Analytics", arXiv:1608.01362) break that assumption: the hot set
(offset-array blocks, high-degree hubs) is re-touched at irregular
intervals and a strict recency order evicts it whenever one large batch
touches many cold packed-byte blocks in between.  ``eviction="clock"``
keeps a second-chance reference bit per block instead: a clock hand
walks a standing residency mask in block order and clears bits before
revoking, so any block re-touched since the last sweep survives the
batch churn, and a victim costs the same however many blocks are
resident.  ``CachedFile(max_resident_bytes=...)`` adds a
per-file cap on top of the mount-wide budget, bounding how much of the
shared budget one file's churn may claim (e.g. cap the packed-neighbor /
feature-store traffic so the hot offset blocks are never the victims).

Multi-tenant shares: several serving models on ONE mount group their
files into :class:`EngineShare` slices
(``fs.register_engine("model-a", budget)``; files join via
``share.mount`` / ``fs.mount(path, engine=...)``).  A share is both a
cap and a reservation layered over the per-file budgets: a share over
its budget reclaims from its OWN files first (biggest resident first,
each file's clock hand supplying second chances), and the mount-wide
sweep protects every share still inside its budget — so one tenant's
churn can never evict another tenant's warm set, only its own.

In the serving stack this layer is the MIDDLE tier of the three-tier
cache hierarchy (docs/architecture.md): storage blocks below it, and
above it the HBM-resident hot set of *decoded* neighbor runs
(:class:`repro_torch.query.HotSetCache`) — a hot-set hit skips PG-Fuse
entirely; a miss lands here as packed-byte block reads.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import BinaryIO, Dict, Optional, Union

import numpy as np

from repro_torch.obs.trace import NULL_TRACER as _NULL_TRACER

# Block states (paper Fig. 1)
LOADED = 0        # >= 0: reader count
NOT_LOADED = -1
LOADING = -2
REVOKING = -3

DEFAULT_BLOCK_SIZE = 32 * 2**20  # 32 MiB (paper §III)

# blocks in the clock hand's first search window over the residency mask
_CLOCK_WINDOW = 64

# Replacement policies (choose via core.policy.choose_access_mode)
EVICT_LRU = "lru"          # exact recency order — sequential scans
EVICT_CLOCK = "clock"      # second-chance ref bits — random access
EVICTION_POLICIES = (EVICT_LRU, EVICT_CLOCK)


@dataclasses.dataclass
class PGFuseStats:
    underlying_reads: int = 0      # calls into the underlying filesystem
    underlying_bytes: int = 0      # bytes fetched from it
    cache_hits: int = 0            # block acquisitions served from memory
    cache_misses: int = 0          # block acquisitions that triggered a load
    waits: int = 0                 # acquisitions that had to wait (-2/-3)
    evictions: int = 0             # blocks revoked
    bytes_served: int = 0          # bytes returned to consumers
    readahead_blocks: int = 0      # blocks loaded ahead of any request
    span_fetch_blocks: int = 0     # blocks installed by prefetch_range
                                   # (consumer-announced spans, one
                                   # enlarged request per NOT_LOADED run)
    retried_reads: int = 0         # transient-fault retries that went back
                                   # to storage (see CachedFile retries=)

    def merge(self, other: "PGFuseStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def as_dict(self) -> dict:
        """Fields + the derived block-cache ``hit_rate`` — the surface
        registered under the ``pgfuse.*`` metric namespace
        (``repro_torch.obs.metrics.NAMESPACE``; drift-checked in CI)."""
        d = dataclasses.asdict(self)
        n = d["cache_hits"] + d["cache_misses"]
        d["hit_rate"] = d["cache_hits"] / n if n else 0.0
        return d


class _StatusArray:
    """CAS-protected per-block status words.

    The paper uses C atomics; under the GIL we realize the identical
    transition diagram with striped mutexes guarding a numpy int64 array —
    every state change goes through :meth:`cas`, so the diagram of Fig. 1 is
    enforced verbatim (stress-tested in tests/test_pgfuse.py).
    """

    N_STRIPES = 64

    def __init__(self, n_blocks: int):
        self._status = np.full(n_blocks, NOT_LOADED, dtype=np.int64)
        self._locks = [threading.Lock() for _ in range(self.N_STRIPES)]

    def load(self, i: int) -> int:
        return int(self._status[i])

    def cas(self, i: int, expected: int, new: int) -> bool:
        with self._locks[i % self.N_STRIPES]:
            if self._status[i] == expected:
                self._status[i] = new
                return True
            return False

    def add_reader(self, i: int) -> bool:
        """Atomically increment a non-negative status (0->1, n->n+1)."""
        with self._locks[i % self.N_STRIPES]:
            s = int(self._status[i])
            if s >= 0:
                self._status[i] = s + 1
                return True
            return False

    def release_reader(self, i: int) -> int:
        with self._locks[i % self.N_STRIPES]:
            s = int(self._status[i])
            assert s >= 1, f"release on block {i} in state {s}"
            self._status[i] = s - 1
            return s - 1

    def snapshot(self) -> np.ndarray:
        return self._status.copy()


class CachedFile:
    """One file's block cache; shared by any number of reader handles."""

    def __init__(self, path: Union[str, os.PathLike], *,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 fs: Optional["PGFuseFS"] = None,
                 pread_fn=None,
                 readahead: int = 0,
                 eviction: str = EVICT_LRU,
                 max_resident_bytes: Optional[int] = None,
                 retries: int = 0,
                 retry_backoff_s: float = 0.005,
                 clock=None):
        self.path = os.fspath(path)
        self.block_size = int(block_size)
        self.readahead = int(readahead)
        if self.block_size <= 0:
            raise ValueError("block_size must be positive")
        if self.readahead < 0:
            raise ValueError("readahead must be >= 0")
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}, "
                             f"got {eviction!r}")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.eviction = eviction
        # per-FILE resident cap (on top of any mount-wide budget): bounds
        # how much cache this file's traffic may claim, so one file's
        # churn cannot evict another file's hot blocks
        self.max_resident_bytes = max_resident_bytes
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        # last-access timestamps come from an injectable clock so eviction
        # order (and the multi-tenant soak tests that pin it) can be a
        # deterministic property of the access sequence, not of wall time
        self._clock = clock or time.monotonic
        # multi-tenant slice this file belongs to (PGFuseFS.register_engine)
        self.share: Optional["EngineShare"] = None
        self._fd = os.open(self.path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size
        # injectable storage backend (benchmarks emulate Lustre/HDD
        # latency+bandwidth through here); default: the real filesystem
        self._pread_fn = pread_fn or (lambda fd, n, off: os.pread(fd, n, off))
        self.n_blocks = max(1, -(-self.size // self.block_size))
        self._statuses = _StatusArray(self.n_blocks)
        self._blocks: list[Optional[bytes]] = [None] * self.n_blocks
        # residency mask: True where a block's data is installed.  The
        # clock hand searches it in place (see sweep), so a victim costs
        # the same whatever the number of resident blocks
        self._resident_mask = np.zeros(self.n_blocks, dtype=bool)
        self._resident_lock = threading.Lock()
        self._resident_bytes = 0
        self._last_access = np.zeros(self.n_blocks, dtype=np.float64)
        # second-chance reference bits (eviction="clock"): set on every
        # acquisition, cleared by an eviction sweep — a block re-touched
        # between sweeps survives one round of pressure
        self._ref = np.zeros(self.n_blocks, dtype=bool)
        self._clock_hand = 0
        self._cond = threading.Condition()
        self.stats = PGFuseStats()
        self._stats_lock = threading.Lock()
        self._fs = fs
        # span tracer for storage reads: set directly, or inherited from
        # the owning mount (engines hand their tracer to PGFuseFS)
        self.tracer = None
        self._closed = False

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    # -- block acquisition (Fig. 1) ---------------------------------------
    def _read_underlying_range(self, b0: int, n_blocks: int) -> bytes:
        off = b0 * self.block_size
        n = min(n_blocks * self.block_size, self.size - off)
        data = self._pread_fn(self._fd, n, off)  # ONE large-granularity request
        with self._stats_lock:
            self.stats.underlying_reads += 1
            self.stats.underlying_bytes += len(data)
        return data

    def _read_with_retry(self, b0: int, n_blocks: int) -> bytes:
        """Bounded-retry wrapper over :meth:`_read_underlying_range`.

        The paper's Lustre deployments see *transient* OST errors (EIO
        that succeeds on the next attempt); with ``retries=r`` such an
        error is retried up to ``r`` times with a deterministic linear
        backoff (``retry_backoff_s * attempt``) before surfacing.  The
        retry sits ABOVE the underlying-read funnel so injected faults
        (tests/conftest.py::FaultyStorage wraps ``_read_underlying_range``)
        exercise the same policy a real storage error would.
        """
        tracer = self.tracer
        if tracer is None:
            tracer = (self._fs.tracer if self._fs is not None
                      else None) or _NULL_TRACER
        # tier=storage: under a request this nests inside the engine's
        # gather span; with no request context (producer threads) the
        # tracer suppresses it rather than recording an orphan root
        with tracer.span("pgfuse.read", tier="storage",
                         block=int(b0), blocks=int(n_blocks)) as sp:
            attempt = 0
            while True:
                try:
                    return self._read_underlying_range(b0, n_blocks)
                except OSError as e:
                    if attempt >= self.retries:
                        raise
                    attempt += 1
                    with self._stats_lock:
                        self.stats.retried_reads += 1
                    # one event per retry that goes back to storage:
                    # trace counts reconcile with stats.retried_reads
                    sp.event("retry", attempt=attempt,
                             errno=e.errno if e.errno is not None else -1)
                    time.sleep(self.retry_backoff_s * attempt)

    def _claim_readahead(self, b: int) -> list[int]:
        """Claim (-1 -> -2) a contiguous run [b, b+1, ...] for one load.

        Sequential readahead (paper §III read-ahead prefetchers): a miss on
        block ``b`` also claims up to ``readahead`` following NOT_LOADED
        blocks so the whole run is fetched with a single enlarged request —
        partition scans then issue ~1/(1+readahead) underlying calls.
        """
        claimed = [b]
        nxt = b + 1
        while (len(claimed) <= self.readahead and nxt < self.n_blocks
               and self._statuses.cas(nxt, NOT_LOADED, LOADING)):
            claimed.append(nxt)
            nxt += 1
        return claimed

    def acquire_block(self, b: int) -> bytes:
        """Pin block ``b`` for reading, loading it if necessary."""
        waited = False
        while True:
            if self._closed:
                raise ValueError("acquire on closed CachedFile")
            if self._statuses.add_reader(b):          # s >= 0 -> s+1
                data = self._blocks[b]
                assert data is not None
                self._ref[b] = True  # second chance: re-touched since sweep
                with self._stats_lock:
                    self.stats.cache_hits += 1
                    if waited:
                        self.stats.waits += 1
                return data
            if self._statuses.cas(b, NOT_LOADED, LOADING):  # -1 -> -2
                claimed = self._claim_readahead(b)
                if self._closed:
                    # close() raced our claim: it is now waiting for these
                    # LOADING blocks before os.close(fd), so revert the
                    # claims rather than pread a to-be-closed descriptor
                    for c in claimed:
                        ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                        assert ok
                    with self._cond:
                        self._cond.notify_all()
                    raise ValueError("acquire on closed CachedFile")
                try:
                    run = self._read_with_retry(b, len(claimed))
                except BaseException:
                    for c in claimed:
                        ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                        assert ok
                    with self._cond:
                        self._cond.notify_all()
                    raise
                expected_b = min(self.block_size, self.size - b * self.block_size)
                if len(run) < expected_b:
                    # A short underlying read that truncates the REQUESTED
                    # block must surface as an error: installing the stub
                    # would hand truncated bytes to every future reader,
                    # and pread() could spin forever on a zero-byte take.
                    # Claims revert (-2 -> -1) so a retry reloads cleanly.
                    for c in claimed:
                        ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                        assert ok
                    with self._cond:
                        self._cond.notify_all()
                    raise IOError(
                        f"{self.path}: short read of block {b}: got "
                        f"{len(run)} of {expected_b} bytes")
                now = self._clock()
                installed_ahead = 0
                for j, c in enumerate(claimed):
                    expected = min(self.block_size, self.size - c * self.block_size)
                    chunk = run[j * self.block_size : j * self.block_size + expected]
                    if c != b and len(chunk) < expected:
                        # short underlying read: drop the readahead block
                        ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                        assert ok
                        continue
                    self._blocks[c] = chunk
                    with self._resident_lock:
                        self._resident_mask[c] = True
                        self._resident_bytes += len(chunk)
                    self._last_access[c] = now
                    # the requested block was demanded (ref set); readahead
                    # installs start cold — unconsumed prefetch is the
                    # first thing a clock sweep should reclaim
                    self._ref[c] = c == b
                    if self._fs is not None:
                        self._fs._resident_delta(len(chunk))
                    # loader becomes reader #1 of b; readahead blocks go idle
                    ok = self._statuses.cas(c, LOADING, 1 if c == b else LOADED)
                    assert ok, "nobody else may touch a LOADING block"
                    installed_ahead += c != b
                with self._stats_lock:
                    self.stats.cache_misses += 1
                    self.stats.readahead_blocks += installed_ahead
                    if waited:
                        self.stats.waits += 1
                with self._cond:
                    self._cond.notify_all()
                self._enforce_file_budget()
                self._enforce_share_budget()
                return self._blocks[b]
            # s is LOADING or REVOKING: wait for the owning thread
            waited = True
            with self._cond:
                s = self._statuses.load(b)
                if s in (LOADING, REVOKING):
                    self._cond.wait(timeout=0.05)

    def release_block(self, b: int) -> None:
        self._last_access[b] = self._clock()
        if self._statuses.release_reader(b) == 0:
            with self._cond:
                self._cond.notify_all()  # close() may be draining readers
        if self._fs is not None:
            self._fs._maybe_evict()

    def prefetch_range(self, offset: int, size: int) -> int:
        """Load every block overlapping [offset, offset+size), fetching
        each contiguous NOT_LOADED run with ONE enlarged request.

        The random-access primitive: a consumer that knows its request
        span up front (the query engine's merged packed-byte gathers)
        announces it here, so a cold multi-block span costs one storage
        request instead of one per block — the paper's enlarged-requests
        argument applied to request-shaped fetches rather than
        speculative readahead.  Returns the number of blocks loaded.
        Resident/loading blocks are skipped; short underlying reads drop
        the affected blocks silently (the eventual :meth:`pread` of a
        dropped block surfaces the error through the strict path).
        """
        if self._closed or size <= 0:
            return 0
        offset = max(0, offset)
        size = min(size, self.size - offset)
        if size <= 0:
            return 0
        # a span that cannot fit the budget would be installed and then
        # partially evicted before the consuming read arrives — strictly
        # worse (same bytes fetched twice) than letting pread() walk the
        # blocks itself, so decline and let the strict path handle it
        budget = self.max_resident_bytes
        if self._fs is not None and self._fs.max_resident_bytes is not None:
            budget = (self._fs.max_resident_bytes if budget is None
                      else min(budget, self._fs.max_resident_bytes))
        if budget is not None and size > budget:
            return 0
        b0 = offset // self.block_size
        b1 = (offset + size - 1) // self.block_size
        loaded = 0
        b = b0
        while b <= b1:
            if not self._statuses.cas(b, NOT_LOADED, LOADING):
                b += 1
                continue
            claimed = [b]
            nxt = b + 1
            while nxt <= b1 and self._statuses.cas(nxt, NOT_LOADED, LOADING):
                claimed.append(nxt)
                nxt += 1
            try:
                run = self._read_with_retry(b, len(claimed))
            except BaseException:
                for c in claimed:
                    ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                    assert ok
                with self._cond:
                    self._cond.notify_all()
                raise
            now = self._clock()
            installed = 0
            for j, c in enumerate(claimed):
                expected = min(self.block_size, self.size - c * self.block_size)
                chunk = run[j * self.block_size : j * self.block_size + expected]
                if len(chunk) < expected:
                    ok = self._statuses.cas(c, LOADING, NOT_LOADED)
                    assert ok
                    continue
                self._blocks[c] = chunk
                with self._resident_lock:
                    self._resident_mask[c] = True
                    self._resident_bytes += len(chunk)
                self._last_access[c] = now
                self._ref[c] = True  # the consumer announced it wants these
                if self._fs is not None:
                    self._fs._resident_delta(len(chunk))
                ok = self._statuses.cas(c, LOADING, LOADED)
                assert ok
                installed += 1
            with self._stats_lock:
                self.stats.span_fetch_blocks += installed
            with self._cond:
                self._cond.notify_all()
            loaded += installed
            b = nxt
        self._enforce_file_budget()
        self._enforce_share_budget()
        if self._fs is not None:
            self._fs._maybe_evict()
        return loaded

    # -- eviction (revocation by last-access time) -------------------------
    def try_revoke(self, b: int) -> int:
        """Attempt 0 -> -3 -> free -> -1.  Returns bytes freed (0 if busy)."""
        if not self._statuses.cas(b, LOADED, REVOKING):
            return 0
        data = self._blocks[b]
        self._blocks[b] = None
        freed = len(data) if data is not None else 0
        with self._resident_lock:
            self._resident_mask[b] = False
            self._resident_bytes -= freed
        self._ref[b] = False
        ok = self._statuses.cas(b, REVOKING, NOT_LOADED)
        assert ok
        with self._stats_lock:
            self.stats.evictions += 1
        with self._cond:
            self._cond.notify_all()
        return freed

    def sweep(self, need_bytes: int) -> int:
        """Revoke idle blocks until ``need_bytes`` are freed (or no more
        victims exist).  Victim order follows ``self.eviction``:

        * ``"lru"`` — strict last-access order (exact recency);
        * ``"clock"`` — second chance: the hand walks the standing
          residency mask in index order from where it last stopped,
          wrapping at ``n_blocks``; a set reference bit buys a resident
          block one lap (the bit is cleared, the hand moves on), a clear
          bit makes it the victim, and a busy victim is passed over.  Two
          laps of block indices bound the walk — after the first every
          survivor's bit is clear.  The hand searches the mask a window
          at a time, so a victim costs no more with more blocks resident.

        Returns bytes actually freed.
        """
        freed = 0
        if self.eviction == EVICT_CLOCK:
            n = self.n_blocks
            pos = self._clock_hand % n   # a hand at n_blocks wraps to 0
            left = 2 * n
            width = _CLOCK_WINDOW
            while freed < need_bytes and left > 0:
                w = min(width, left, n - pos)
                # a copy: a block another thread installs meanwhile was
                # not passed by the hand and keeps its bit
                resident = self._resident_mask[pos:pos + w].copy()
                victims = resident & ~self._ref[pos:pos + w]
                v = int(victims.argmax())
                if victims[v]:
                    # every resident block before the victim held a set
                    # bit: the hand passes it and the second chance is spent
                    self._ref[pos:pos + v] &= ~resident[:v]
                    self._clock_hand = pos + v + 1
                    freed += self.try_revoke(pos + v)
                    step = v + 1
                    width = _CLOCK_WINDOW
                else:
                    passed = np.flatnonzero(resident)
                    if passed.size:
                        self._ref[pos:pos + w] &= ~resident
                        self._clock_hand = pos + int(passed[-1]) + 1
                    step = w
                    # a window without a victim doubles the next, so a
                    # long stretch of cold blocks costs O(log) searches
                    width *= 2
                left -= step
                pos = (pos + step) % n
        else:
            order = sorted(self.resident_blocks(),
                           key=lambda b: self._last_access[b])
            for b in order:
                if freed >= need_bytes:
                    break
                freed += self.try_revoke(b)
        return freed

    def _enforce_file_budget(self) -> None:
        """Keep this FILE inside its own resident cap (when it has one).

        The per-file budget is what keeps a churning byte stream (packed
        neighbors under random queries, a feature store scan) from
        claiming the whole mount-wide budget and evicting another file's
        hot blocks: the churner reclaims from ITSELF first.
        """
        if self.max_resident_bytes is None:
            return
        over = self._resident_bytes - self.max_resident_bytes
        if over <= 0:
            return
        freed = self.sweep(over)
        if freed and self._fs is not None:
            self._fs._resident_delta(-freed)

    def _enforce_share_budget(self) -> None:
        """Keep this file's ENGINE share inside its cap (when in one)."""
        if self.share is not None:
            self.share.enforce()

    def resident_blocks(self) -> np.ndarray:
        """Indices of the blocks with data installed, ascending (int64)."""
        with self._resident_lock:
            return np.flatnonzero(self._resident_mask).astype(np.int64,
                                                              copy=False)

    # -- the consumer-facing read interface --------------------------------
    def pread(self, offset: int, size: int) -> bytes:
        """Positional read assembled from cached blocks."""
        if self._closed:
            raise ValueError("read on closed CachedFile")
        offset = max(0, offset)
        size = max(0, min(size, self.size - offset))
        if size == 0:
            return b""
        out = bytearray(size)
        pos = 0
        off = offset
        end = offset + size
        while off < end:
            b = off // self.block_size
            data = self.acquire_block(b)
            try:
                lo = off - b * self.block_size
                take = min(end - off, len(data) - lo)
                out[pos : pos + take] = data[lo : lo + take]
            finally:
                self.release_block(b)
            pos += take
            off += take
        with self._stats_lock:
            self.stats.bytes_served += size
        return bytes(out)

    def open(self) -> "CachedFileHandle":
        """A seekable file-like handle (one per consumer thread)."""
        return CachedFileHandle(self)

    def close(self, *, drain_timeout: float = 5.0) -> None:
        """Free every block through the Fig. 1 transitions (0 -> -3 -> -1).

        Pinned (s > 0) or in-flight (-2) blocks are *waited for*, not freed
        from under their readers — freeing a pinned block hands stale bytes
        to a thread that legally holds it.  Readers that never release
        within ``drain_timeout`` are treated as leaked and their blocks
        reclaimed as a last resort (with resident accounting kept exact).
        """
        if self._closed:
            return
        self._closed = True  # new acquisitions now fail fast
        deadline = time.monotonic() + drain_timeout
        pending = set(range(self.n_blocks))
        while pending:
            for b in list(pending):
                freed = self.try_revoke(b)  # 0 -> -3 -> free -> -1
                if freed and self._fs is not None:
                    self._fs._resident_delta(-freed)
                if self._statuses.load(b) == NOT_LOADED:
                    pending.discard(b)
            if not pending:
                break
            if time.monotonic() >= deadline:  # leaked readers: force-free
                freed = 0
                for b in pending:
                    data = self._blocks[b]
                    if data is not None:
                        freed += len(data)
                        self._blocks[b] = None
                        with self._resident_lock:
                            self._resident_mask[b] = False
                            self._resident_bytes -= len(data)
                if self._fs is not None and freed:
                    self._fs._resident_delta(-freed)
                break
            with self._cond:
                self._cond.wait(timeout=0.05)
        os.close(self._fd)


class CachedFileHandle:
    """Seek/read file-object adapter over a shared :class:`CachedFile`."""

    def __init__(self, cf: CachedFile):
        self._cf = cf
        self._pos = 0

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = offset
        elif whence == os.SEEK_CUR:
            self._pos += offset
        elif whence == os.SEEK_END:
            self._pos = self._cf.size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            size = self._cf.size - self._pos
        data = self._cf.pread(self._pos, size)
        self._pos += len(data)
        return data

    def pread(self, offset: int, size: int) -> bytes:
        """Positional read — does NOT touch the seek cursor, so codec
        readers sharing one handle across threads need no lock."""
        return self._cf.pread(offset, size)

    def close(self) -> None:  # the underlying cache outlives handles
        pass

    def __enter__(self) -> "CachedFileHandle":
        return self

    def __exit__(self, *exc) -> None:
        pass


class EngineShare:
    """One serving engine's slice of a shared mount (multi-tenant budgets).

    A share groups the files one tenant (one serving model: its CompBin
    topology + feature/label column families) reads, and layers a budget
    over them ABOVE the per-file caps: the share's resident total is the
    sum of its member files', and when it exceeds ``max_resident_bytes``
    the share reclaims from its own members — biggest resident first,
    each member's own clock hand supplying the second chances — before
    the mount-wide sweep would ever look at another tenant.  Conversely
    :meth:`PGFuseFS._maybe_evict` protects every share still inside its
    budget, so the share is a reservation too: tenant A's churn cannot
    evict tenant B's warm set while B stays inside its slice.

    A file belongs to at most ONE share; genuinely shared files (two
    engines over one topology) stay unassigned and compete in the common
    pool.
    """

    def __init__(self, fs: "PGFuseFS", name: str,
                 max_resident_bytes: Optional[int]):
        self._fs = fs
        self.name = name
        self.max_resident_bytes = (None if max_resident_bytes is None
                                   else int(max_resident_bytes))
        self._files: Dict[str, CachedFile] = {}
        self._lock = threading.Lock()

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(cf.resident_bytes for cf in self._files.values())

    def files(self) -> list:
        with self._lock:
            return list(self._files.values())

    def add_file(self, cf: CachedFile) -> None:
        if cf.share is not None and cf.share is not self:
            raise ValueError(
                f"{cf.path} already belongs to engine share "
                f"{cf.share.name!r}; a file joins at most one share "
                f"(shared files stay unassigned)")
        with self._lock:
            self._files[cf.path] = cf
        cf.share = self

    def mount(self, path: Union[str, os.PathLike], **mount_kwargs
              ) -> CachedFile:
        """Mount ``path`` on the underlying fs and claim it for this
        share (kwargs as :meth:`PGFuseFS.mount`)."""
        cf = self._fs.mount(path, **mount_kwargs)
        self.add_file(cf)
        return cf

    def within_budget(self) -> bool:
        return (self.max_resident_bytes is not None
                and self.resident_bytes <= self.max_resident_bytes)

    def enforce(self) -> int:
        """Reclaim from the share's OWN files until inside the budget.

        Victim order: biggest-resident member first (the churner pays
        first), each file's :meth:`CachedFile.sweep` supplying clock
        second chances.  Bounded: one pass over the members, each sweep
        capped at two laps, and a no-progress member is skipped — the
        call terminates even with every block pinned.  Returns bytes
        freed (mount-wide accounting kept exact).
        """
        if self.max_resident_bytes is None:
            return 0
        freed = 0
        for cf in sorted(self.files(), key=lambda f: -f.resident_bytes):
            over = self.resident_bytes - self.max_resident_bytes
            if over <= 0:
                break
            got = cf.sweep(over)
            if got and cf._fs is not None:
                cf._fs._resident_delta(-got)
            freed += got
        return freed


class PGFuseFS:
    """The "mount": a set of cached files under one shared memory budget.

    ``ParaGrapher`` mounts graph files here when the user passes
    ``use_pgfuse=True`` to :func:`repro_torch.core.paragrapher.open_graph`, and
    unmounts (releasing all blocks) when the graph is closed — mirroring the
    paper's mount/unmount lifecycle.
    """

    def __init__(self, *, block_size: int = DEFAULT_BLOCK_SIZE,
                 max_resident_bytes: Optional[int] = None,
                 pread_fn=None,
                 readahead: int = 0,
                 eviction: str = EVICT_LRU,
                 file_budgets: Optional[Dict[str, int]] = None,
                 retries: int = 0,
                 retry_backoff_s: float = 0.005,
                 clock=None):
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"eviction must be one of {EVICTION_POLICIES}, "
                             f"got {eviction!r}")
        self.block_size = block_size
        self.max_resident_bytes = max_resident_bytes
        self.pread_fn = pread_fn
        self.readahead = int(readahead)
        self.eviction = eviction
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.clock = clock
        # mount-wide span tracer (repro_torch.obs): cached files inherit it
        # unless they carry their own; engines set it when constructed
        # with tracer= so storage reads nest under their gather spans
        self.tracer = None
        # per-file resident caps keyed by fspath; applied at mount() and
        # retroactively by set_file_budget()
        self._file_budgets = {os.fspath(k): int(v)
                              for k, v in (file_budgets or {}).items()}
        self._files: Dict[str, CachedFile] = {}
        self._shares: Dict[str, EngineShare] = {}
        # unmount refcounts for files several consumers mount and later
        # release independently (two tenants over one topology): see
        # retain()/unmount() — plain mount() calls do NOT count
        self._file_refs: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._resident = 0

    def _resident_delta(self, d: int) -> None:
        with self._lock:
            self._resident += d

    @property
    def resident_bytes(self) -> int:
        return self._resident

    # -- multi-tenant engine shares ----------------------------------------
    #: "budget argument omitted" marker for register_engine — distinct
    #: from an explicit None, which means "uncap"
    _BUDGET_UNSET = object()

    def register_engine(self, name: str,
                        max_resident_bytes=_BUDGET_UNSET) -> EngineShare:
        """Create (or fetch) the named :class:`EngineShare`.

        Re-registering an existing name WITH a budget argument resizes
        it in place (and enforces the new cap immediately), so a serving
        fleet can resize tenants' slices at runtime; an explicit ``None``
        uncaps.  Omitting the argument fetches the share untouched — a
        fetch must never silently delete a tenant's cap/reservation.
        """
        with self._lock:
            share = self._shares.get(name)
            if share is None:
                budget = (None if max_resident_bytes is self._BUDGET_UNSET
                          else max_resident_bytes)
                share = EngineShare(self, name, budget)
                self._shares[name] = share
                return share
        if max_resident_bytes is self._BUDGET_UNSET:
            return share
        share.max_resident_bytes = (None if max_resident_bytes is None
                                    else int(max_resident_bytes))
        share.enforce()
        return share

    def engine_share(self, name: str) -> Optional[EngineShare]:
        with self._lock:
            return self._shares.get(name)

    def retain(self, path: Union[str, os.PathLike]) -> None:
        """Declare a long-lived co-owner of one mounted file.

        Each retain is paired with one later ``unmount(path)``, which
        only truly unmounts once every retainer released — so two
        GraphHandles over the SAME CompBin file on a shared mount can
        close independently without one dropping the other's warm
        cache.  Plain :meth:`mount` calls (used freely as accessors) do
        not count."""
        key = os.fspath(path)
        with self._lock:
            self._file_refs[key] = self._file_refs.get(key, 0) + 1

    def set_file_budget(self, path: Union[str, os.PathLike],
                        max_resident_bytes: Optional[int]) -> None:
        """Cap (or uncap, with None) one file's share of the cache.

        Applies to an already-mounted file immediately: an over-budget
        file sweeps itself down on its next install (and right here, so
        the cap holds even for a file that is never read again).
        """
        key = os.fspath(path)
        with self._lock:
            if max_resident_bytes is None:
                self._file_budgets.pop(key, None)
            else:
                self._file_budgets[key] = int(max_resident_bytes)
            cf = self._files.get(key)
        if cf is not None:
            cf.max_resident_bytes = max_resident_bytes
            cf._enforce_file_budget()

    def _maybe_evict(self) -> None:
        """Revoke idle blocks while over the mount-wide budget.

        Files holding no more than their OWN declared budget are
        protected in the first pass, and so are the member files of any
        ENGINE share still inside its share budget: per-file and
        per-engine budgets are reservations as well as caps, so another
        tenant's churn cannot evict a budgeted warm set while it stays
        inside its slice.  Only if the unprotected files cannot cover
        the overage (budgets that oversubscribe the mount) does a
        second pass consider everyone.
        Victim selection inside a pass honors ``self.eviction``: LRU
        takes a global strict last-access order; clock sweeps files
        biggest-resident first (the churner pays first), each file's own
        hand supplying the second chances.
        """
        if self.max_resident_bytes is None or self._resident <= self.max_resident_bytes:
            return
        with self._lock:
            files = list(self._files.values())

        def within_budget(cf: CachedFile) -> bool:
            if (cf.max_resident_bytes is not None
                    and cf.resident_bytes <= cf.max_resident_bytes):
                return True
            return cf.share is not None and cf.share.within_budget()

        for victims in ([cf for cf in files if not within_budget(cf)], files):
            if self._resident <= self.max_resident_bytes:
                return
            if self.eviction == EVICT_CLOCK:
                for cf in sorted(victims, key=lambda f: -f.resident_bytes):
                    over = self._resident - self.max_resident_bytes
                    if over <= 0:
                        return
                    freed = cf.sweep(over)
                    if freed:
                        self._resident_delta(-freed)
            else:
                candidates = []
                for cf in victims:
                    for b in cf.resident_blocks():
                        candidates.append((cf._last_access[b], cf, int(b)))
                candidates.sort(key=lambda t: t[0])
                for _, cf, b in candidates:
                    if self._resident <= self.max_resident_bytes:
                        return
                    freed = cf.try_revoke(b)
                    if freed:
                        self._resident_delta(-freed)

    def mount(self, path: Union[str, os.PathLike], *,
              max_resident_bytes: Optional[int] = None,
              readahead: Optional[int] = None,
              engine: Optional[Union[str, EngineShare]] = None) -> CachedFile:
        """Mount (or return the existing cache of) one file.

        ``max_resident_bytes`` sets the file's budget at first mount (and
        registers it for the mount's lifetime); ``readahead`` overrides
        the mount default for THIS file — a random-access consumer mounts
        its file with ``readahead=0`` next to a sequentially-streamed
        neighbor without splitting the memory budget.  ``engine`` claims
        the file for a registered :class:`EngineShare` (by object or
        name), layering that tenant's budget over the per-file one.
        """
        share = None
        if engine is not None:
            # resolve the share BEFORE opening anything: an unknown name
            # is an error (a typo must not silently strand the file in a
            # fresh uncapped share), and raising here must not leak a
            # freshly created CachedFile/fd
            if isinstance(engine, EngineShare):
                share = engine
            else:
                share = self.engine_share(engine)
                if share is None:
                    raise ValueError(
                        f"unknown engine share {engine!r}; call "
                        f"register_engine() first")
        key = os.fspath(path)
        with self._lock:
            if max_resident_bytes is not None:
                self._file_budgets[key] = int(max_resident_bytes)
            cf = self._files.get(key)
            created = cf is None
            if created:
                cf = CachedFile(
                    key, block_size=self.block_size, fs=self,
                    pread_fn=self.pread_fn,
                    readahead=self.readahead if readahead is None else readahead,
                    eviction=self.eviction,
                    max_resident_bytes=self._file_budgets.get(key),
                    retries=self.retries,
                    retry_backoff_s=self.retry_backoff_s,
                    clock=self.clock)
                self._files[key] = cf
        if not created:
            # already mounted: apply the overrides to the LIVE cache rather
            # than silently recording a budget that is never enforced
            if readahead is not None:
                cf.readahead = int(readahead)
            if max_resident_bytes is not None:
                cf.max_resident_bytes = int(max_resident_bytes)
                cf._enforce_file_budget()
        if share is not None:
            share.add_file(cf)
        return cf

    def open(self, path: Union[str, os.PathLike]) -> CachedFileHandle:
        return self.mount(path).open()

    def stats(self) -> PGFuseStats:
        agg = PGFuseStats()
        with self._lock:
            for cf in self._files.values():
                agg.merge(cf.stats)
        return agg

    def unmount(self, path: Optional[Union[str, os.PathLike]] = None) -> None:
        with self._lock:
            if path is None:
                files, self._files = list(self._files.values()), {}
                self._file_refs.clear()
            else:
                key = os.fspath(path)
                refs = self._file_refs.get(key, 0)
                if refs > 1:  # other retainers still hold this file
                    self._file_refs[key] = refs - 1
                    return
                self._file_refs.pop(key, None)
                cf = self._files.pop(key, None)
                files = [cf] if cf else []
        for cf in files:
            if cf.share is not None:
                with cf.share._lock:
                    cf.share._files.pop(cf.path, None)
                cf.share = None
            cf.close()

    def __enter__(self) -> "PGFuseFS":
        return self

    def __exit__(self, *exc) -> None:
        self.unmount()
