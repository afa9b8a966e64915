"""Plain PyTorch version of the flash-attention kernel: dense GQA
attention with materialised f32 scores.  The CPU path and the CPU tests
run it, and the on-card check holds the CUDA kernel against it; nothing
on the main path calls it when the tensors lie on a GPU."""

from __future__ import annotations

import torch


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
