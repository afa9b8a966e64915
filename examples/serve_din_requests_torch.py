#!/usr/bin/env python
"""Serve a DIN CTR model with batched requests, CompBin-packed ID
streams, on the PyTorch/CUDA port.

The port's copy of ``examples/serve_din_requests.py``: request
history/candidate IDs arrive CompBin-packed (3 bytes per ID for a
10M-item catalog -- the paper's byte-packing applied to the recsys request
path), are decoded with eq. (1) on the host, embedded, and scored with
target attention on the card (eager, under ``torch.inference_mode``).

    PYTHONPATH=src python examples/serve_din_requests_torch.py --requests 20
    PYTHONPATH=src python examples/serve_din_requests_torch.py --device cpu --items 1000

``--device`` defaults to the GPU and raises without one.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import compbin  # noqa: E402
from repro_torch.kernels.utils import resolve_device  # noqa: E402
from repro_torch.models.recsys import din  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--items", type=int, default=100_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def run(args, *, device, params=None) -> dict:
    """The example on ``device``, from ``params`` (default:
    ``din.init_params`` drawn on ``device`` from seed 0); returns what it
    printed as numbers, and every request's scores."""
    cfg = din.DINConfig(name="din-serve", embed_dim=18, seq_len=100,
                        n_items=args.items, n_cates=1000,
                        attn_mlp=(80, 40), mlp=(200, 80))
    if params is None:
        params = din.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    b = compbin.bytes_per_vertex(cfg.n_items)
    print(f"DIN catalog {cfg.n_items:,} items -> {b} bytes/ID on the wire "
          f"({(4-b)/4:.0%} smaller than int32)")

    def to_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    rng = np.random.default_rng(0)
    lat, scores_out = [], []
    wire_bytes = 0
    with torch.inference_mode():
        for _ in range(args.requests):
            # requests arrive packed (as they would over the network /
            # from the feature store through PG-Fuse)
            hist = rng.integers(0, cfg.n_items, (args.batch, cfg.seq_len))
            cand = rng.integers(0, cfg.n_items, args.batch)
            packed_hist = compbin.encode_ids(
                hist.reshape(-1).astype(np.uint64), b)
            packed_cand = compbin.encode_ids(cand.astype(np.uint64), b)
            wire_bytes += packed_hist.nbytes + packed_cand.nbytes

            t0 = time.perf_counter()
            hist_ids = compbin.decode_ids(packed_hist, b).astype(
                np.int64).reshape(args.batch, cfg.seq_len)
            cand_ids = compbin.decode_ids(packed_cand, b).astype(np.int64)
            batch = {
                "hist_items": to_device(hist_ids),
                "hist_cates": to_device(hist_ids % cfg.n_cates),
                "cand_item": to_device(cand_ids),
                "cand_cate": to_device(cand_ids % cfg.n_cates),
            }
            scores = din.forward(params, batch, cfg)
            if scores.is_cuda:
                torch.cuda.synchronize(scores.device)
            lat.append(time.perf_counter() - t0)
            scores_out.append(scores.cpu().numpy())

    lat_ms = np.asarray(lat[2:]) * 1e3
    p50, p99 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 99)
    print(f"batch={args.batch}: p50 {p50:.2f} ms, p99 {p99:.2f} ms "
          f"({args.batch/p50*1e3:,.0f} req/s/replica)")
    print(f"wire traffic: {wire_bytes/2**20:.2f} MiB packed "
          f"(int32 would be {wire_bytes/b*4/2**20:.2f} MiB)")
    return {"b": b, "p50_ms": float(p50), "p99_ms": float(p99),
            "wire_bytes": wire_bytes, "scores": scores_out}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
