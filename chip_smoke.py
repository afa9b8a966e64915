#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py            # full size (load phase at --scale 23)

It builds every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (bit for
bit: the path is integer), drives the port's main path -- load a CompBin
graph into HBM through PG-Fuse, then answer batches of neighbor queries
from the same file -- through the library entry points, checks every
result against the generated graph, and prints what it measured.

Output contract: the line before the last but one is the card's name and
power limit as ``nvidia-smi`` gives them; the last but one is one JSON
object ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.

The load/serve/LogCSR phases are plain functions of ``device`` and
``scale`` so the CPU tests run the same code at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import policy  # noqa: E402
from repro_torch.core.paragrapher import open_graph, save_graph  # noqa: E402
from repro_torch.data import assemble_csr, stream_partitions  # noqa: E402
from repro_torch.graph import rmat  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import Tracer, tier_times  # noqa: E402
from repro_torch.kernels.compbin_decode import (compbin_decode,  # noqa: E402
                                                compbin_decode_ref,
                                                stream_bucket_ids)
from repro_torch.query import NeighborQueryEngine  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline the
# kernels' bounds are stated against.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # non-tensor-core rate, used for integer ALU work

SERVE_BLOCK_SIZE = 1 << 16      # PG-Fuse block for the random-access mount
TPU_KERNEL = "src/repro/kernels/compbin_decode/kernel.py:53"
CUDA_SOURCE = "src/repro_torch/csrc/compbin_decode.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases 4-6: the main path, as functions of (device, scale)
# ---------------------------------------------------------------------------

def make_graph(scale: int, workdir: str, fmt: str = "compbin",
               edge_factor: int = 16, seed: int = 0):
    """Generate ``rmat(scale, edge_factor)`` and write it as ``fmt``.
    Returns (csr, path, seconds to generate, seconds to write)."""
    t0 = time.perf_counter()
    csr = rmat(scale, edge_factor, seed=seed)
    t1 = time.perf_counter()
    suffix = {"compbin": "cbin", "logcsr": "lgsr"}[fmt]
    path = os.path.join(workdir, f"rmat{scale}.{suffix}")
    save_graph(path, csr, format=fmt)
    return csr, path, t1 - t0, time.perf_counter() - t1


def phase_load(csr, path: str, device) -> dict:
    """Stream the file to ``device`` through PG-Fuse (sequential plan) and
    hold the assembled CSR against ``csr`` bit for bit."""
    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("stream")
    launches0 = compbin_decode.launches
    with open_graph(path, use_pgfuse=True, pgfuse_readahead=amode.readahead,
                    pgfuse_eviction=amode.eviction) as g:
        b = g.bytes_per_id
        with stream_partitions(g, device) as stream:
            shards = list(stream)           # every shard stays resident
        st = stream.stats
    launched = compbin_decode.launches - launches0
    assert st.decode_mode == "device", st.decode_reason
    assert st.host_decode_bytes == 0, st.host_decode_bytes
    assert st.partitions == len(shards) > 0
    for s in shards:
        assert s.neighbors.dtype == torch.int32
        assert s.offsets.dtype == torch.int64
        assert s.neighbors.is_cuda == on_gpu and s.offsets.is_cuda == on_gpu
        assert s.neighbors.shape == (s.n_edges,)
    # one launch per partition: even an empty one ships its 1024-id bucket
    assert launched == (len(shards) if on_gpu else 0), (launched, len(shards))
    out = assemble_csr(shards)
    assert out.offsets.dtype == np.int64
    assert np.array_equal(out.offsets, csr.offsets), "offsets differ"
    assert np.array_equal(out.neighbors, csr.neighbors), "neighbors differ"
    d = st.as_dict()
    return {"b": b, "partitions": st.partitions, "vertices": st.vertices,
            "edges": st.edges, "bytes_h2d": st.bytes_h2d,
            "wall_s": d["wall_s"], "edges_per_s": d["edges_per_s"],
            "h2d_bytes_per_s": d["h2d_bytes_per_s"],
            "decode_s": d["decode_s"], "launches": launched,
            "cache_hits": st.cache_hits, "cache_misses": st.cache_misses,
            "underlying_bytes": st.underlying_bytes,
            "max_partition_ids": max(stream_bucket_ids(s.n_edges)
                                     for s in shards)}


def _check_answers(csr, vertices, answers) -> int:
    """Every answer is int64 and equals the CSR's slice; returns the
    number of neighbor ids checked."""
    assert len(answers) == len(vertices)
    lo, hi = csr.offsets[vertices], csr.offsets[vertices + 1]
    assert [len(a) for a in answers] == (hi - lo).tolist(), "degree differs"
    for a in answers:
        assert a.dtype == np.int64
    want = np.concatenate([csr.neighbors[s:e] for s, e in zip(lo, hi)]
                          + [np.zeros(0, csr.neighbors.dtype)])
    got = np.concatenate(list(answers) + [np.zeros(0, np.int64)])
    assert np.array_equal(got, want.astype(np.int64)), "neighbor ids differ"
    return int(got.size)


def phase_serve(csr, path: str, device, *, n_batches: int = 32,
                batch: int = 1024, n_async: int = 4, n_auto: int = 4,
                n_traced: int = 4, seed: int = 1) -> dict:
    """Answer seeded random neighbor queries from the file through
    PG-Fuse (random-access plan) with the device decode, the async
    ``submit`` path, one ``decode="auto"`` run and a few span-traced
    batches (where a batch's time goes, by tier); every answer is held
    against ``csr``."""
    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("serve")
    rng = np.random.default_rng(seed)
    budget = max(64 * SERVE_BLOCK_SIZE, os.path.getsize(path) // 2)
    launches0 = compbin_decode.launches

    def mount():
        return open_graph(path, use_pgfuse=True,
                          pgfuse_block_size=SERVE_BLOCK_SIZE,
                          pgfuse_readahead=amode.readahead,
                          pgfuse_eviction=amode.eviction,
                          pgfuse_max_resident_bytes=budget)

    lat, checked = [], 0
    with mount() as g, NeighborQueryEngine(g, decode="device",
                                           device=device) as eng:
        for _ in range(n_batches):
            vs = rng.integers(0, g.n_vertices, batch)
            t0 = time.perf_counter()
            ans = eng.neighbors_batch(vs)
            lat.append(time.perf_counter() - t0)
            checked += _check_answers(csr, vs, ans)
        sync_batches = eng.stats.batches
        assert eng.stats.device_batches == sync_batches == n_batches
        # the async path: concurrent requests coalesce into micro-batches
        reqs = [rng.integers(0, g.n_vertices, batch // 4)
                for _ in range(n_async)]
        futs = [eng.submit(vs) for vs in reqs]
        for vs, fut in zip(reqs, futs):
            checked += _check_answers(csr, vs, fut.result(timeout=120))
        qs = eng.stats.as_dict()
    assert qs["device_batches"] == qs["batches"] > sync_batches
    assert qs["bytes_h2d"] > 0
    assert sum(qs["close_reasons"].values()) == qs["batches"]
    launched_device = compbin_decode.launches - launches0
    assert launched_device == (qs["batches"] if on_gpu else 0)

    # decode="auto": policy places each batch by its exact edge mass
    want_device = 0
    with mount() as g, NeighborQueryEngine(g, decode="auto",
                                           device=device) as eng:
        for _ in range(n_auto):
            vs = rng.integers(0, g.n_vertices, batch)
            uniq = np.unique(vs)
            mass = int((csr.offsets[uniq + 1] - csr.offsets[uniq]).sum())
            want_device += int(policy.choose_query_decode(
                mass, g.bytes_per_id, n_vertices=g.n_vertices).device)
            checked += _check_answers(csr, vs, eng.neighbors_batch(vs))
        auto = eng.stats.as_dict()
    assert auto["device_batches"] == want_device, (auto, want_device)

    # span-traced batches: exclusive seconds per tier (gather = the
    # batching machinery, storage = PG-Fuse reads, decode = H2D copy +
    # kernel + D2H on the device arm)
    tracer = Tracer()
    with mount() as g, NeighborQueryEngine(g, decode="device", device=device,
                                           tracer=tracer) as eng:
        for _ in range(n_traced):
            vs = rng.integers(0, g.n_vertices, batch)
            checked += _check_answers(csr, vs, eng.neighbors_batch(vs))
    tiers: dict = {}
    for root in tracer.drain():
        for tier, sec in tier_times(root).items():
            tiers[tier] = tiers.get(tier, 0.0) + sec / max(1, n_traced)
    launched = compbin_decode.launches - launches0
    assert launched == (launched_device + want_device + n_traced
                        if on_gpu else 0)
    lat_sorted = sorted(lat)
    return {"batches": qs["batches"], "device_batches": qs["device_batches"],
            "requests": qs["requests"], "edges_returned": qs["edges_returned"],
            "bytes_h2d": qs["bytes_h2d"], "close_reasons": qs["close_reasons"],
            "auto_device_batches": auto["device_batches"],
            "auto_batches": auto["batches"], "ids_checked": checked,
            "tier_s_per_traced_batch": tiers,
            "p50_s": lat_sorted[len(lat) // 2],
            "p99_s": lat_sorted[min(len(lat) - 1, int(0.99 * len(lat)))],
            "launches": launched}


def phase_logcsr(device, scale: int, workdir: str, *, n_batches: int = 8,
                 batch: int = 256) -> dict:
    """The same load and serve over a LogCSR file: its neighbors share
    CompBin's packed layout, so the same kernel decodes them."""
    csr, path, _, _ = make_graph(scale, workdir, "logcsr", seed=3)
    load = phase_load(csr, path, device)
    serve = phase_serve(csr, path, device, n_batches=n_batches, batch=batch,
                        n_async=2, n_auto=2, seed=4)
    return {"load": load, "serve": serve}


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def time_cuda(fn, *, reps: int = 10, warmup: int = 2, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, by CUDA
    events; ``flush`` (a large scratch tensor) is rewritten between
    launches so each one finds the L2 cache cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound_ms(n: int, b: int) -> tuple[float, str]:
    """Least time the card could take for ``n`` ids of ``b`` bytes: the
    larger of bytes moved (n*b read, n*4 written) over HBM bandwidth and
    the shift+mask per id over the integer ALU rate."""
    t_bytes = n * (b + 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_packed(n: int, b: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 256, (n * b,), dtype=torch.uint8, device="cuda",
                         generator=gen)


def library_call(b: int):
    """The one PyTorch call that computes the same function, where there
    is one (a yardstick only; the port never calls it)."""
    if b == 4:
        return lambda p: p.view(torch.int32).clone()
    if b == 1:
        return lambda p: p.to(torch.int32)
    return None


def measure_kernel(packed: torch.Tensor, b: int, flush) -> dict:
    """Compare kernel and plain version on ``packed`` (bit for bit) and
    time kernel, plain version and library call."""
    n = packed.numel() // b
    got = compbin_decode(packed, b)
    want = compbin_decode_ref(packed, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n,)
    equal = torch.equal(got, want)
    err = 0 if equal else int((got.long() - want.long()).abs().max())
    assert equal, f"kernel != plain at b={b} n={n} (max abs err {err})"
    del got, want
    ms = time_cuda(lambda: compbin_decode(packed, b), flush=flush)
    plain = time_cuda(lambda: compbin_decode_ref(packed, b), flush=flush,
                      reps=10, warmup=1)
    lib = library_call(b)
    lib_ms = time_cuda(lambda: lib(packed), flush=flush) if lib else None
    bms, by = bound_ms(n, b)
    return {"b": b, "n": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "gb_per_s": n * (b + 4) / (ms * 1e-3) / 1e9}


def phase_kernel_checks(large_log2: int) -> list:
    """Phase 3: kernel vs plain version on the card, bit-exact."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_cases = 0
    for b in (1, 2, 3, 4):
        for n in (1, 127, 128, 1000, 40000):
            p = random_packed(n, b, gen)
            assert torch.equal(compbin_decode(p, b), compbin_decode_ref(p, b)), \
                (b, n)
            n_cases += 1
        # a base pointer that is not 4-byte aligned (byte-wise path)
        for shift in (1, 2, 3):
            p = random_packed(1001, b, gen)[shift:]
            p = p[: (p.numel() // b) * b]
            assert p.data_ptr() % 4 == shift and p.is_contiguous()
            assert torch.equal(compbin_decode(p, b), compbin_decode_ref(p, b)), \
                ("misaligned", b, shift)
            n_cases += 1
    for b in (5, 6, 7, 8):      # wide ids whose high bytes are zero
        n = 4099
        p = random_packed(n, b, gen).reshape(n, b)
        p[:, 4:] = 0
        p[:, 3] &= 0x7F          # stay inside int32
        want = compbin_decode_ref(p[:, :4].contiguous().reshape(-1), 4)
        assert torch.equal(compbin_decode(p.reshape(-1), b), want), b
        p[n // 2, 4] = 1         # one non-zero high byte must raise
        try:
            compbin_decode(p.reshape(-1), b)
        except ValueError:
            pass
        else:
            raise AssertionError(f"b={b}: non-zero high byte did not raise")
        n_cases += 2
    torch.cuda.synchronize()
    log(f"[kernel] {n_cases} small/misaligned/wide cases equal the plain "
        f"version bit for bit (torch.equal)")

    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    n = 1 << large_log2
    for b in (1, 2, 3, 4):
        p = random_packed(n, b, gen)
        r = measure_kernel(p, b, flush)
        del p
        torch.cuda.empty_cache()
        lib = ("none: no single PyTorch call decodes 3-byte ids"
               if r["library_ms"] is None and b == 3 else
               "none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f}")
        log(f"[kernel] b={b} n=2^{large_log2}: kernel {r['ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"{r['gb_per_s']:.1f} GB/s  plain {r['plain_ms']:.4f} ms  "
            f"library_ms {lib}  max_abs_err {r['max_abs_err']}")
        rows.append(r)
    return rows


def phase_h2d(n_bytes: int = 64 << 20, reps: int = 5) -> dict:
    """Host-to-device copy rate of one staging-sized buffer, pageable (what
    the loader does today) against pinned memory."""
    out = {}
    for kind in ("pageable", "pinned"):
        host = torch.zeros(n_bytes, dtype=torch.uint8,
                           pin_memory=(kind == "pinned"))
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host.to("cuda", non_blocking=True)
            torch.cuda.current_stream().synchronize()
            times.append(time.perf_counter() - t0)
        out[kind + "_gb_per_s"] = n_bytes / statistics.median(times[1:]) / 1e9
    log(f"[h2d] {n_bytes >> 20} MiB host->device: pageable "
        f"{out['pageable_gb_per_s']:.2f} GB/s, pinned "
        f"{out['pinned_gb_per_s']:.2f} GB/s")
    return out


def phase_crossover(path: str, device) -> dict:
    """Phase 7: host vs device decode per batch edge mass, around
    ``policy.QUERY_DEVICE_MIN_EDGES`` (measured, the constant stays)."""
    rng = np.random.default_rng(7)
    rows = []
    with open_graph(path) as g, NeighborQueryEngine(
            g, decode="device", device=device) as eng:
        b, nv = g.bytes_per_id, g.n_vertices
        for log2 in range(8, 21):
            mass = 1 << log2
            span = 16                      # ids per adjacency run
            ids = rng.integers(0, nv, mass).astype("<u8")
            raw = ids.view(np.uint8).reshape(mass, 8)[:, :b].copy()
            packed = [raw[i:i + span].reshape(-1)
                      for i in range(0, mass, span)]
            reps = 20 if log2 <= 16 else 5
            host_t, dev_t = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                h, _ = eng._decode_host(packed)
                t1 = time.perf_counter()
                d, _ = eng._decode_device(packed)
                t2 = time.perf_counter()
                host_t.append(t1 - t0)
                dev_t.append(t2 - t1)
            assert all(np.array_equal(x, y) for x, y in zip(h, d))
            rows.append((mass, statistics.median(host_t),
                         statistics.median(dev_t)))
    crossover = None
    for i, (mass, ht, dt) in enumerate(rows):
        if all(d <= h for _, h, d in rows[i:]):
            crossover = mass
            break
    for mass, ht, dt in rows:
        log(f"[crossover] {mass:>8} edges: host {ht * 1e6:10.1f} us  "
            f"device {dt * 1e6:10.1f} us")
    log(f"[crossover] device decode is no slower than host from "
        f"{crossover} edges per batch on (spans of 16 ids, b={b}); "
        f"policy.QUERY_DEVICE_MIN_EDGES = {policy.QUERY_DEVICE_MIN_EDGES} "
        f"(unchanged)")
    return {"crossover_edges": crossover,
            "rows": [{"edges": m, "host_s": h, "device_s": d}
                     for m, h, d in rows]}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=23,
                    help="RMAT scale of the load/serve graph (2^scale "
                         "vertices, 16 edges each before dedup)")
    ap.add_argument("--logcsr-scale", type=int, default=16)
    ap.add_argument("--large-log2", type=int, default=28,
                    help="log2 of the id count of the timed kernel cases")
    ap.add_argument("--out", default=None,
                    help="also write the full results as JSON to this path")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)

    # phase 1: device and toolchain
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], check=True,
                                  capture_output=True, text=True
                                  ).stdout.strip().splitlines()[-2]
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  nvcc: {nvcc_version}")

    # phase 2: build every kernel, one compiler process per source
    t0 = time.perf_counter()
    ptxas = build.build_all(extra_flags=("-Xptxas", "-v"))
    build.load_library("compbin_decode")
    log(f"[build] {len(ptxas)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {build.build_seconds[k]:.1f} s" for k in ptxas))
    for name, out in ptxas.items():
        regs = [int(line.split("Used")[1].split()[0])
                for line in out.splitlines() if "registers" in line]
        spills = [line for line in out.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in line]
        log(f"[build] {name}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)} per thread, "
            f"{len(spills)} with spills (ptxas -v)")

    # phase 3: kernel vs plain version on the card
    large = phase_kernel_checks(args.large_log2)

    results = {"device": smi, "kernel_large": large}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        csr, path, gen_s, write_s = make_graph(args.scale, workdir)
        log(f"[graph] rmat({args.scale}, 16): {csr.n_vertices} vertices, "
            f"{csr.n_edges} edges, file {os.path.getsize(path)} bytes; "
            f"generated in {gen_s:.1f} s, written in {write_s:.1f} s")

        # phases 4-6: the main path, launch counter zeroed just before
        compbin_decode.launches = 0
        load = phase_load(csr, path, device)
        log(f"[load] scale {args.scale}: {load['partitions']} partitions, "
            f"b={load['b']}, wall {load['wall_s']:.3f} s, "
            f"{load['edges_per_s']:.4g} edges/s, "
            f"H2D {load['h2d_bytes_per_s']:.4g} B/s "
            f"({load['bytes_h2d']} bytes), decode_s {load['decode_s']:.3f}, "
            f"launches {load['launches']}, host_decode_bytes 0, "
            f"CSR equal bit for bit")
        serve = phase_serve(csr, path, device)
        log(f"[serve] {serve['batches']} batches ({serve['device_batches']} "
            f"on device), {serve['requests']} requests, "
            f"{serve['edges_returned']} edges, p50 {serve['p50_s'] * 1e3:.3f} "
            f"ms, p99 {serve['p99_s'] * 1e3:.3f} ms per 1024-vertex batch, "
            f"bytes_h2d {serve['bytes_h2d']}, auto: "
            f"{serve['auto_device_batches']}/{serve['auto_batches']} on "
            f"device, launches {serve['launches']}, "
            f"{serve['ids_checked']} ids equal the CSR")
        log("[serve] exclusive ms per traced batch by tier: " + ", ".join(
            f"{t} {s * 1e3:.3f}" for t, s in
            sorted(serve["tier_s_per_traced_batch"].items())))
        logcsr = phase_logcsr(device, args.logcsr_scale, workdir)
        log(f"[logcsr] scale {args.logcsr_scale}: load launches "
            f"{logcsr['load']['launches']}, serve launches "
            f"{logcsr['serve']['launches']}, all answers equal")
        main_path_launches = compbin_decode.launches
        assert main_path_launches == (load["launches"] + serve["launches"]
                                      + logcsr["load"]["launches"]
                                      + logcsr["serve"]["launches"])
        assert load["launches"] > 0 and serve["launches"] > 0

        # phase 7: host vs device crossover, and the copy it rides on
        cross = phase_crossover(path, device)
        h2d = phase_h2d()

        # phase 8: K1 at the shape the load path gives it (one padded
        # partition of the graph above)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
        k1 = measure_kernel(
            random_packed(load["max_partition_ids"], load["b"], gen),
            load["b"], flush)
    results.update(load=load, serve=serve, logcsr=logcsr, crossover=cross,
                   h2d=h2d,
                   kernel_main_path=k1, graph={
                       "scale": args.scale, "vertices": csr.n_vertices,
                       "edges": csr.n_edges, "generate_s": gen_s,
                       "write_s": write_s})
    log(f"[kernel] main-path shape b={k1['b']} n={k1['n']}: kernel "
        f"{k1['ms']:.4f} ms  bound {k1['bound_ms']:.4f} ms  "
        f"{k1['gb_per_s']:.1f} GB/s  plain {k1['plain_ms']:.4f} ms")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    kernels = [{
        "name": "compbin_decode", "route": "cuda", "source": CUDA_SOURCE,
        "replaces": TPU_KERNEL, "launches": main_path_launches,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "shape": f"uint8[{k1['n']}*{k1['b']}] -> int32[{k1['n']}]",
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
