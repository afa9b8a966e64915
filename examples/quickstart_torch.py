#!/usr/bin/env python
"""Quickstart on the PyTorch/CUDA port: the paper in one file.

The port's copy of ``examples/quickstart.py``: generates an RMAT graph,
saves it as WebGraph-style and CompBin, loads it back through ParaGrapher
with and without PG-Fuse, verifies the loads are identical, prints the
loading/decode split for each path, then streams the CompBin file into
the card's memory -- one host-to-device copy of the packed bytes per
partition, eq. (1) decoded there by the CUDA kernel
(``src/repro_torch/csrc/compbin_decode.cu``).

    PYTHONPATH=src python examples/quickstart_torch.py [--format compbin]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --scale 10

``--device`` defaults to the GPU and raises without one; ``--device cpu``
decodes with the kernel's plain version.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.convert import stats_ints  # noqa: E402
from repro_torch.core import paragrapher  # noqa: E402
from repro_torch.graph import rmat  # noqa: E402
from repro_torch.kernels.utils import resolve_device  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", choices=["compbin", "webgraph", "both"],
                    default="both")
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--workdir", default="/tmp/repro_quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def run(args, *, device) -> dict:
    """The example on ``device``; returns what it printed as numbers."""
    from repro_torch.data import assemble_csr, stream_partitions

    os.makedirs(args.workdir, exist_ok=True)
    print(f"generating RMAT scale={args.scale} ...")
    csr = rmat(args.scale, 16, seed=0)
    print(f"  |V|={csr.n_vertices:,} |E|={csr.n_edges:,}")
    out = {"vertices": csr.n_vertices, "edges": csr.n_edges, "formats": {}}

    formats = ["compbin", "webgraph"] if args.format == "both" else [args.format]
    results = {}
    for fmt in formats:
        path = os.path.join(args.workdir, f"g.{fmt}")
        n = paragrapher.save_graph(path, csr, format=fmt)
        print(f"[{fmt}] wrote {n/2**20:.2f} MiB")
        rec = out["formats"][fmt] = {"bytes_written": n}

        for use_fuse in (False, True):
            t0 = time.perf_counter()
            with paragrapher.open_graph(path, use_pgfuse=use_fuse,
                                        pgfuse_block_size=1 << 22) as g:
                loaded = g.read_full()
                dt = time.perf_counter() - t0
                stats = g.pgfuse_stats()
            assert loaded == csr, "loaded graph differs!"
            tag = "PG-Fuse" if use_fuse else "direct "
            extra = (f" underlying_reads={stats.underlying_reads} "
                     f"hits={stats.cache_hits}" if stats else "")
            print(f"[{fmt}] {tag} loaded+verified in {dt*1e3:8.1f} ms{extra}")
            results[(fmt, use_fuse)] = dt
            rec["pgfuse" if use_fuse else "direct"] = {
                "s": dt,
                "underlying_reads": stats.underlying_reads if stats else None,
                "hits": stats.cache_hits if stats else None}

    if len(formats) == 2:
        speedup = results[("webgraph", False)] / results[("compbin", False)]
        out["speedup"] = speedup
        print(f"\nCompBin vs WebGraph decode speedup on this host: "
              f"{speedup:.1f}x (paper: up to 21.8x on 128-core EPYC)")

    # async partitioned load (the ParaGrapher consumer/producer pattern)
    path = os.path.join(args.workdir, f"g.{formats[0]}")
    with paragrapher.open_graph(path, use_pgfuse=True) as g:
        got = []
        ar = g.read_async(g.partition_plan(8),
                          lambda buf: got.append(len(buf.neighbors)),
                          n_buffers=3, n_workers=4)
        ar.wait(60)
        print(f"async load: {len(got)} partitions, {sum(got):,} edges total")
    out["async"] = {"partitions": len(got), "edges": sum(got)}

    # Streaming loader: partition -> PG-Fuse -> raw packed bytes -> H2D ->
    # eq. (1) in the CUDA kernel -> device-resident CSR shards.  For
    # CompBin the neighbor IDs are never decoded on the host, so the
    # (4-b)/4 byte saving also applies to the host->device link.
    # stream.stats carries the per-stage accounting.
    cb_path = os.path.join(args.workdir, "g.compbin")
    if not os.path.exists(cb_path):
        paragrapher.save_graph(cb_path, csr, format="compbin")
    with paragrapher.open_graph(cb_path, use_pgfuse=True,
                                pgfuse_block_size=1 << 22,
                                pgfuse_readahead=2) as g:
        with stream_partitions(g, device, n_buffers=2,
                               readahead=2) as stream:
            shards = list(stream)
        assert assemble_csr(shards) == csr, "streamed graph differs!"
        st = stream.stats
        print(f"streaming loader: {st.partitions} device shards "
              f"[{st.decode_mode} decode], {st.underlying_reads} storage "
              f"reads (+{st.readahead_blocks} readahead blocks), "
              f"{st.bytes_h2d/2**20:.2f} MiB H2D, "
              f"{st.host_decode_bytes} host-decoded bytes, "
              f"{st.decode_edges_per_s/1e3:.0f}k edges/s on-device decode")
    out["stream"] = {**stats_ints(st), "decode_mode": st.decode_mode,
                     "decode_edges_per_s": st.decode_edges_per_s}
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
