#!/usr/bin/env python
"""Train a ~100M-param LM for a few hundred steps from CompBin-packed
token shards (the paper's byte-packing applied to the LM input pipeline),
on the PyTorch/CUDA port.

The port's copy of ``examples/train_lm_packed_tokens.py``.  Default
config is a ~103M-param llama-style model; --tiny switches to a
seconds-scale config.  The step is eager: autograd through the plain
attention backends (training never takes the flash-attention kernel,
which has no backward), then AdamW; a checkpoint every 100 steps.

    PYTHONPATH=src python examples/train_lm_packed_tokens_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_packed_tokens_torch.py --device cpu --tiny --steps 10

``--device`` defaults to the GPU and raises without one.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.data import (PrefetchIterator,  # noqa: E402
                              TokenShardReader, write_token_shard)
from repro_torch.kernels.utils import resolve_device  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--workdir", default="/tmp/repro_lm_example")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def model_config(args) -> tf.TransformerConfig:
    if args.tiny:
        return tf.TransformerConfig(
            name="lm-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128, vocab=2048, dtype=torch.float32,
            tie_embeddings=True)
    # ~103M params: 12L x 640d x (10H/5KV) x 2560ff, 32k vocab
    return tf.TransformerConfig(
        name="lm-100m", n_layers=12, d_model=640, n_heads=10,
        n_kv_heads=5, d_head=64, d_ff=2560, vocab=32_768,
        dtype=torch.float32, tie_embeddings=True, attn_chunk=128)


def run(args, *, device, params=None) -> dict:
    """The example on ``device``, from ``params`` (default:
    ``tf.init_params`` drawn on ``device`` from seed 0); returns what it
    printed as numbers: every step's loss and the PG-Fuse counters."""
    os.makedirs(args.workdir, exist_ok=True)
    cfg = model_config(args)
    print(f"model: {cfg.name}, {cfg.n_params()/1e6:.1f}M params")

    # synthetic corpus with learnable bigram structure (loss must drop
    # clearly below the unigram entropy)
    shard = os.path.join(args.workdir, f"corpus_{cfg.vocab}.ctok")
    if not os.path.exists(shard):
        rng = np.random.default_rng(0)
        n = 2_000_000 if not args.tiny else 100_000
        nxt = rng.integers(0, cfg.vocab, cfg.vocab)  # deterministic bigram
        toks = np.empty(n, np.int64)
        toks[0] = 1
        noise = rng.random(n) < 0.1
        rand = rng.integers(0, cfg.vocab, n)
        for i in range(1, n):
            toks[i] = rand[i] if noise[i] else nxt[toks[i - 1]]
        write_token_shard(shard, toks, cfg.vocab)
        print(f"wrote {os.path.getsize(shard)/2**20:.1f} MiB packed shard "
              f"({3}B/token vs {4}B int32: 25% smaller)")

    reader = TokenShardReader(shard, use_pgfuse=True,
                              pgfuse_block_size=1 << 20)
    raw = reader.batches(args.batch, args.seq, seed=0)

    def to_device(b):
        t = torch.as_tensor(b, dtype=torch.int64).to(device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    batches = PrefetchIterator(raw, depth=2, transform=to_device)

    if params is None:
        params = tf.init_params(cfg,
                                torch.Generator(device=device).manual_seed(0))
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    opt = adamw_init(params, opt_cfg)
    ckpt = AsyncCheckpointer(os.path.join(args.workdir, "ckpt"), keep_last=2)

    def step(params, opt, batch):
        p = tree_map(lambda v: v.detach().requires_grad_(), params)
        loss = tf.loss_fn(p, batch["tokens"], batch["labels"], cfg)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        params, opt, _ = adamw_update(params, tree_unflatten(p, grads), opt,
                                      opt_cfg)
        return params, opt, loss.detach()

    t0 = time.time()
    losses = []
    for i in range(1, args.steps + 1):
        params, opt, loss = step(params, opt, next(batches))
        losses.append(float(loss))
        if i % 25 == 0:
            tok_s = args.batch * args.seq * i / (time.time() - t0)
            print(f"step {i:4d} loss {losses[-1]:.4f} ({tok_s:,.0f} tok/s)")
        if i % 100 == 0:
            ckpt.save(i, {"params": params, "opt": opt})
    wall = time.time() - t0
    ckpt.wait()
    print(f"\nloss: {np.mean(losses[:20]):.3f} -> {np.mean(losses[-20:]):.3f} "
          f"(bigram structure learned: must be well below "
          f"ln(vocab)={np.log(cfg.vocab):.2f})")
    st = reader.pgfuse_stats()
    print(f"PG-Fuse: {st.underlying_reads} underlying reads / "
          f"{st.cache_hits:,} hits")
    batches.close()
    reader.close()
    return {"n_params": cfg.n_params(), "vocab": cfg.vocab,
            "losses": losses, "tokens_per_s": args.batch * args.seq
            * args.steps / wall,
            "pgfuse": {"underlying_reads": st.underlying_reads,
                       "cache_hits": st.cache_hits}}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
