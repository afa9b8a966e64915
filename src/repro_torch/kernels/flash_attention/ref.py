"""Plain PyTorch version of the flash-attention kernel: dense GQA
attention with materialised f32 scores.  The CPU path and the CPU tests
run it, and the on-card check holds the CUDA kernel against it; nothing
on the main path calls it when the tensors lie on a GPU.  Beside it, the
split-decode design's arithmetic (partials per key range, then their
merge) for the tests."""

from __future__ import annotations

import math

import torch

LOG2E = math.log2(math.e)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  offset: int | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """q: [B, Hq, Sq, Dh]; k, v: [B, Hkv, Skv, Dh]; Hq % Hkv == 0.

    Query row i sees key j when ``j < kv_len`` and, if ``causal``,
    ``j <= i + offset`` (the decode convention; ``offset`` defaults to
    ``Skv - Sq`` and ``kv_len`` to ``Skv``).  Returns [B, Hq, Sq, Dh] in
    float32.  K/V are repeated per group and the scores computed densely
    in f32.  A row that sees no key is 0: the JAX package's oracle gives
    NaN there (its ``-inf`` mask) and its Pallas op the mean of the padded
    V block (its ``-1e30`` sentinel); the port follows the Pallas
    kernel's stated contract (``kernel.py:72-76``) instead.
    """
    _, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    offset = skv - sq if offset is None else offset
    kv_len = skv if kv_len is None else kv_len
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos < kv_len
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + offset
        mask = mask & (kpos <= qpos)
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    den = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    return torch.where(den > 0, out / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(out))


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   nsplit: int, causal: bool = True,
                   scale: float | None = None, offset: int | None = None,
                   kv_len: int | None = None):
    """The split-decode design's first kernel, in plain PyTorch: the keys
    ``[0, kv_len)`` cut into ``nsplit`` ranges of ``ceil(kv_len /
    nsplit)`` (the last ones short or empty), and for each range every
    row's partial ``(m, l, acc)`` in f32: m the largest visible score in
    log2 units (scores times ``scale * log2(e)``), l the sum of
    ``exp2(score - m)``, acc the same weights times V.  A range in which
    a row sees no key gives ``m = -inf, l = 0, acc = 0``.  Shapes as
    :func:`attention_ref`; returns (m, l) of [nsplit, B, Hq, Sq] and acc
    of [nsplit, B, Hq, Sq, Dh].  Used by the tests only."""
    _, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    offset = skv - sq if offset is None else offset
    kv_len = skv if kv_len is None else kv_len
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * (scale * LOG2E), kk)
    kpos = torch.arange(skv, device=q.device)[None, :]
    visible = kpos < kv_len
    if causal:
        visible = visible & (kpos <= torch.arange(sq, device=q.device)[:, None]
                             + offset)
    kps = -(-kv_len // nsplit) if kv_len else 0
    ms, ls, accs = [], [], []
    for i in range(nsplit):
        mask = visible & (kpos >= i * kps) & (kpos < (i + 1) * kps)
        si = s.masked_fill(~mask, float("-inf"))
        m = si.amax(-1)
        p = torch.exp2(si - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vv))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge_splits(m: torch.Tensor, l: torch.Tensor,
                 acc: torch.Tensor) -> torch.Tensor:
    """The split-decode design's combine kernel, in plain PyTorch: the
    partials of :func:`split_partials` rescaled to their common max and
    summed; a row that no range saw is 0.  Returns [B, Hq, Sq, Dh] f32."""
    mx = m.amax(0)
    w = torch.where(torch.isfinite(m), torch.exp2(m - torch.where(
        torch.isfinite(mx), mx, 0.0)), 0.0)
    den = (w * l).sum(0)
    num = (w[..., None] * acc).sum(0)
    return torch.where(den[..., None] > 0,
                       num / torch.where(den > 0, den, 1.0)[..., None],
                       torch.zeros_like(num))


def attention_split_ref(q, k, v, *, nsplit: int, causal: bool = True,
                        scale: float | None = None, offset: int | None = None,
                        kv_len: int | None = None) -> torch.Tensor:
    """:func:`attention_ref` computed the split-decode design's way:
    :func:`split_partials` over ``nsplit`` key ranges, then
    :func:`merge_splits`."""
    return merge_splits(*split_partials(q, k, v, nsplit=nsplit,
                                        causal=causal, scale=scale,
                                        offset=offset, kv_len=kv_len))
