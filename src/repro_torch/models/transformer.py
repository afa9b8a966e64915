"""Decoder-only transformer family of the port (dense + MoE) — plain
functions over a params dict, mirroring the JAX package's
``models/transformer.py``.

Covers the five LM architectures through one config: GQA attention
(``n_kv_heads <= n_heads``), optional QKV bias (qwen2), RoPE with partial
rotary (stablelm ``rope_pct=0.25``), RMSNorm or LayerNorm, tied or
separate LM head, and a dense SwiGLU FFN or the MoE FFN (:func:`moe_ffn`:
routed top-k experts with capacity-based dispatch by sort + scatter, the
``scatter`` and ``gather`` arms of ``moe_dispatch``, optional shared
experts with a sigmoid gate).  Entry points: ``forward``, ``prefill``
(builds the KV cache) and ``decode_step`` (one token against it) for
serving; ``loss_fn`` and ``forward_hidden`` for training.

Mesh fields (``attn_head_axis``, ``attn_batch_shard_axes``,
``batch_axes``, ``moe_ep_axis``): the JAX package turns them into
sharding constraints on activations (``_wsc`` and the constraints on
q/k/v and the MoE dispatch buffer).  A constraint never changes a value,
and a tensor of one process has one shard, so here they are accepted and
each constraint is the identity (:func:`_wsc`); ``attn_kv_expand`` acts
as there.

Attention: serving on a CUDA tensor sends EVERY call — prefill and
decode, whatever ``attn_impl`` says — through the hand-written
flash-attention kernel (:mod:`repro_torch.kernels.flash_attention`),
handed the ``[B, S, H, dh]`` projections and the live part of the cache
as strided views.  The kernel has no backward (neither has the JAX
package's), so the training entry points (``loss_fn``,
``forward_hidden``) take the plain backends on every device, as the
JAX package trains through its jnp attention.  On a CPU tensor the JAX
package's own plain backends run: ``dense`` (materialised scores) or
``chunked`` (online softmax over KV chunks, Python loops in place of
``scan``; fully-future chunks are skipped, which leaves every number as
it was).

MoE combine: the scatter arm's segment sum of the weighted expert
outputs by token goes through the segment-sum kernel
(:mod:`repro_torch.kernels.segment_sum`) on a CUDA tensor, and, where
it requires grad, its backward kernel; the expert SwiGLU is batched
matrix products (the JAX package computes it outside any Pallas kernel).

KV cache: ``{"k": [L x tensor], "v": [L x tensor], "len": int}`` — one
``[B, Smax, Hk, dh]`` tensor per layer, written in place
(``cache_k[:, len:len+S] = k``), ``len`` a Python int.  The JAX package
stacks the layers (``[L, B, Smax, Hk, dh]``) and returns a new cache.

``remat``, ``unroll_layers``, ``attn_unroll`` and ``ce_chunk`` shape the
JAX program (rematerialisation, unrolling for its cost analysis, chunked
loss); the port runs eagerly and reads none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.kernels.flash_attention import attention_bshd
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.common import (cross_entropy_loss, dense_init,
                                       layer_norm, rms_norm, wide)

Params = dict


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "transformer"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 1024
    max_seq: int = 4096
    qkv_bias: bool = False
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    rope_pct: float = 1.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    shared_expert_gate: bool = False
    router_norm_topk: bool = False
    capacity_factor: float = 1.25
    lb_loss_coef: float = 0.01
    moe_dispatch: str = "scatter"
    # --- runtime ---
    dtype: Any = torch.bfloat16
    attn_impl: str = "chunked"        # "dense" | "chunked" (CPU path only)
    attn_chunk: int = 1024
    remat: bool = True
    moe_ep_axis: Optional[str] = None
    unroll_layers: bool = False
    attn_unroll: bool = False
    attn_p_bf16: bool = False
    ce_chunk: int = 0
    attn_head_axis: Optional[str] = None
    attn_kv_expand: bool = False
    attn_batch_shard_axes: Optional[tuple] = None
    batch_axes: Optional[tuple] = None

    @property
    def e_pad(self) -> int:
        return self.n_experts_padded or self.n_experts

    def n_params(self) -> int:
        """Total parameter count (padding experts excluded)."""
        d, H, Hk, dh, f = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.d_head, self.d_ff)
        attn = d * (H * dh) + 2 * d * (Hk * dh) + (H * dh) * d
        if self.qkv_bias:
            attn += (H + 2 * Hk) * dh
        if self.moe:
            ffn = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            if self.n_shared_experts:
                ffn += 3 * d * self.shared_d_ff + (d if self.shared_expert_gate else 0)
        else:
            ffn = 3 * d * f
        norms = 2 * d * (2 if self.norm == "layernorm" else 1)
        per_layer = attn + ffn + norms
        embed = self.vocab * d
        head = 0 if self.tie_embeddings else d * self.vocab
        return self.n_layers * per_layer + embed + head + d

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k routed + shared)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        routed_all = self.n_experts * 3 * d * self.moe_d_ff
        routed_act = self.top_k * 3 * d * self.moe_d_ff
        return self.n_params() - self.n_layers * (routed_all - routed_act)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights from ``generator`` in ``cfg.dtype`` (the JAX
    package's shapes and distributions, not its bits), on ``device``
    (None: the generator's device).  The MoE router is float32 whatever
    ``cfg.dtype`` is; the expert weights hold ``e_pad`` slots (the
    padded ones included) and are drawn a layer at a time, so the
    float32 draw never holds more than one layer's."""
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L, dt = cfg.n_layers, cfg.dtype
    device = generator.device if device is None else device

    def W(*shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dt,
                          device=device)

    def W_by_layer(*shape):
        out = torch.empty((L, *shape), dtype=dt, device=device)
        for i in range(L):
            out[i] = W(*shape)
        return out

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    layers = {
        "attn_norm_scale": const(1.0, L, d),
        "ffn_norm_scale": const(1.0, L, d),
        "wq": W(L, d, H, dh),
        "wk": W(L, d, Hk, dh),
        "wv": W(L, d, Hk, dh),
        "wo": W(L, H, dh, d),
    }
    if cfg.norm == "layernorm":
        layers["attn_norm_bias"] = const(0.0, L, d)
        layers["ffn_norm_bias"] = const(0.0, L, d)
    if cfg.qkv_bias:
        layers["bq"] = const(0.0, L, H, dh)
        layers["bk"] = const(0.0, L, Hk, dh)
        layers["bv"] = const(0.0, L, Hk, dh)
    if cfg.moe:
        E, fe = cfg.e_pad, cfg.moe_d_ff
        layers["router"] = dense_init(generator, (L, d, cfg.n_experts),
                                      dtype=torch.float32, device=device)
        layers["we_gate"] = W_by_layer(E, d, fe)
        layers["we_up"] = W_by_layer(E, d, fe)
        layers["we_down"] = W_by_layer(E, fe, d)
        if cfg.n_shared_experts:
            fs = cfg.shared_d_ff
            layers["ws_gate"] = W(L, d, fs)
            layers["ws_up"] = W(L, d, fs)
            layers["ws_down"] = W(L, fs, d)
            if cfg.shared_expert_gate:
                layers["shared_gate"] = W(L, d, 1)
    else:
        f = cfg.d_ff
        layers["w_gate"] = W(L, d, f)
        layers["w_up"] = W(L, d, f)
        layers["w_down"] = W(L, f, d)
    params = {"embed": W(cfg.vocab, d, scale=0.02),
              "final_norm_scale": const(1.0, d), "layers": layers}
    if cfg.norm == "layernorm":
        params["final_norm_bias"] = const(0.0, d)
    if not cfg.tie_embeddings:
        params["lm_head"] = W(d, cfg.vocab)
    return params


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_freqs(cfg: TransformerConfig, device=None) -> torch.Tensor:
    rot = int(cfg.d_head * cfg.rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: TransformerConfig) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] (absolute). Partial rotary,
    angles in f32."""
    freqs = _rope_freqs(cfg, x.device)
    rot = 2 * freqs.shape[0]
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = wide(x[..., :rot])
    half = rot // 2
    x1, x2 = xr[..., :half], xr[..., half:]
    if torch.is_grad_enabled():
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        # the same products and sums, written in place: no [.., rot]
        # temporaries beyond one half (a 32 x 32768-token prefill's q
        # holds 4 GB less)
        out = torch.empty_like(xr)
        torch.mul(x1, cos, out=out[..., :half]).sub_(x2 * sin)
        torch.mul(x2, cos, out=out[..., half:]).add_(x1 * sin)
    del xr, x1, x2          # freed before the cast allocates
    if rot == x.shape[-1]:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# attention backends
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, *, causal: bool, q_offset: int) -> torch.Tensor:
    """q: [B,S,H,dh]; k,v: [B,T,Hk,dh].  q_offset: absolute position of
    q[0] minus absolute position of k[0] (for caches/prefill)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    qh = q.reshape(B, S, Hk, g, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", wide(qh),
                          wide(k)) * (dh ** -0.5)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + q_offset
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, wide(v))
    return out.reshape(B, S, H, dh).to(q.dtype)


def _chunked_attention(q, k, v, *, causal: bool, q_offset: int, chunk: int,
                       p_bf16: bool = False) -> torch.Tensor:
    """Online softmax over (q-chunk outer, kv-chunk inner) loops — the
    FlashAttention dataflow in plain tensor ops, f32 compute.  KV chunks
    wholly in a query chunk's future are skipped (they would change no
    number: exp(-1e30 - m) is 0 and alpha 1)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    g = H // Hk
    bq, bk = min(chunk, S), min(chunk, T)
    qf = wide(q).reshape(B, S, Hk, g, dh)
    kf, vf = wide(k), wide(v)
    outs = []
    for q0 in range(0, S, bq):
        qb = qf[:, q0:q0 + bq]
        nb = qb.shape[1]
        qpos = q0 + torch.arange(nb, device=q.device)[:, None] + q_offset
        m = qf.new_full((B, Hk, g, nb), -1e30)
        l = qf.new_zeros((B, Hk, g, nb))
        acc = qf.new_zeros((B, Hk, g, nb, dh))
        for k0 in range(0, T, bk):
            if causal and k0 > q0 + nb - 1 + q_offset:
                break                        # every later chunk too
            kb, vb = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * (dh ** -0.5)
            if causal:
                kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            if p_bf16:
                # bf16 operands, f32 products and sums
                p = p.to(torch.bfloat16).float()
                vb = vb.to(torch.bfloat16).float()
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
            acc = alpha[..., None] * acc + pv
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)                 # [B, Hk, g, S, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dh)


def attention_plain(q, k, v, cfg: TransformerConfig, *, causal: bool,
                    q_offset: int = 0) -> torch.Tensor:
    """The JAX package's ``attention()``: ``dense`` for ``attn_impl ==
    "dense"`` or one query, ``chunked`` otherwise."""
    if cfg.attn_impl == "dense" or q.shape[1] == 1:
        return _dense_attention(q, k, v, causal=causal, q_offset=q_offset)
    return _chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                              chunk=cfg.attn_chunk, p_bf16=cfg.attn_p_bf16)


def attention(q, k, v, cfg: TransformerConfig, *, causal: bool,
              q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,H,dh]; k,v: [B,T,Hk,dh] (T may be a cache's Smax: keys
    after ``q_offset + S`` are never seen when causal).  On a CUDA tensor
    the flash-attention kernel over the live keys, with no copy of the
    cache; on a CPU tensor :func:`attention_plain`."""
    if not q.is_cuda:
        return attention_plain(q, k, v, cfg, causal=causal,
                               q_offset=q_offset)
    live = min(q_offset + q.shape[1], k.shape[1]) if causal else k.shape[1]
    return attention_bshd(q, k[:, :live], v[:, :live], causal=causal,
                          offset=q_offset, kv_len=live)


# ---------------------------------------------------------------------------
# FFN / blocks / forward
# ---------------------------------------------------------------------------

def swiglu(x, wg, wu, wd):
    """``(silu(x @ wg) * (x @ wu)) @ wd``; where no gradient is taken the
    SiLU and the product run in place (the same values, two [.., f]
    buffers fewer: a 32 x 32768-token prefill's FFN holds 11 GB less)."""
    if torch.is_grad_enabled():
        h = torch.nn.functional.silu(x @ wg) * (x @ wu)
    else:
        h = torch.nn.functional.silu(x @ wg, inplace=True).mul_(x @ wu)
    return h @ wd


def moe_capacity(cfg: TransformerConfig, T: int, *, no_drop: bool = False,
                 eval_mode: bool = False) -> int:
    """Slots per expert for ``T`` tokens: ``T*K`` under ``no_drop``
    (nothing is ever dropped), a 2x capacity factor capped at ``T*K``
    under ``eval_mode``, ``cfg.capacity_factor`` otherwise — the JAX
    package's Python arithmetic."""
    K, Ep = cfg.top_k, cfg.e_pad
    if no_drop:
        return T * K
    if eval_mode:
        return min(T * K, max(1, int(2.0 * T * K / Ep)))
    return max(1, int(cfg.capacity_factor * T * K / Ep))


def route(x: torch.Tensor, router: torch.Tensor, cfg: TransformerConfig):
    """Router of [T, d] tokens: ``(probs [T, E], gates [T, K], idx [T,
    K])`` — softmax over the float32 logits, then the top k, the gates
    renormalised only under ``router_norm_topk``."""
    probs = torch.softmax(wide(x) @ wide(router), dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, idx


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of ``0..n-1`` occurs in ``ids`` (int64; no host
    sync, unlike ``torch.bincount`` on the card)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))


def sort_assignments(idx: torch.Tensor, n_slots: int, capacity: int):
    """The T*K assignments of ``idx`` [T, K] sorted by expert, stably (so
    within an expert in token order, as ``jnp.argsort``): ``(order,
    e_sorted, t_sorted, pos, keep)``, ``pos`` the assignment's place
    within its expert (unique there) and ``keep = pos < capacity``."""
    T, K = idx.shape
    expert_flat = idx.reshape(-1)
    tok_flat = torch.arange(T, device=idx.device).repeat_interleave(K)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    t_sorted = tok_flat[order]
    counts = _count(e_sorted, n_slots)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * K, device=idx.device) - starts[e_sorted]
    return order, e_sorted, t_sorted, pos, pos < capacity


def moe_ffn(x: torch.Tensor, lp: Params, cfg: TransformerConfig, *,
            no_drop: bool = False, eval_mode: bool = False):
    """Routed top-k MoE with capacity-based dispatch (sort + scatter).

    x: [T, d] (flattened tokens).  Returns (out [T, d] in x's dtype,
    lb_loss float32 scalar).  ``no_drop``, ``eval_mode``: see
    :func:`moe_capacity`.  An assignment past its expert's capacity is
    dropped from the dispatch and weighted 0 in the combine.  The
    scatter arm's combine is a segment sum of the [T*K, d] float32
    weighted outputs by token (:func:`segment_sum`: the kernel on a CUDA
    tensor); the gather arm's, the JAX package's sum over K."""
    T, d = x.shape
    E, Ep = cfg.n_experts, cfg.e_pad
    C = moe_capacity(cfg, T, no_drop=no_drop, eval_mode=eval_mode)
    probs, gates, idx = route(x, lp["router"], cfg)

    # Switch-style load-balance loss over the *routed* experts
    me = probs.mean(0)
    ce = _count(idx, E).float() / idx.numel()
    lb_loss = cfg.lb_loss_coef * E * torch.sum(me * ce)

    order, e_sorted, t_sorted, pos, keep = sort_assignments(idx, Ep, C)
    slot = e_sorted * C + pos.clamp(max=C - 1)          # a kept one's slot
    if cfg.moe_dispatch == "gather":
        # slot -> token gather: buf[e, c] = x[token filling slot (e, c)]
        counts = _count(e_sorted, Ep)
        starts = torch.cumsum(counts, 0) - counts
        c = torch.arange(C, device=x.device)
        slot_tok = t_sorted[(starts[:, None] + c).clamp(max=idx.numel() - 1)]
        valid = (c[None, :] < counts[:, None])[..., None]
        buf = torch.where(valid, x[slot_tok], 0)
    else:
        # overflow assignments go to one spare slot past the buffer
        flat = torch.where(keep, slot, Ep * C)
        buf = x.new_zeros(Ep * C + 1, d).index_put(
            (flat,), x[t_sorted])[:Ep * C].view(Ep, C, d)
    # per-expert SwiGLU: [Ep, C, d] x [Ep, d, f]
    h = torch.nn.functional.silu(torch.bmm(buf, lp["we_gate"])) * \
        torch.bmm(buf, lp["we_up"])
    yb = torch.bmm(h, lp["we_down"]).view(Ep * C, d)

    if cfg.moe_dispatch == "gather":
        # combine by gather in assignment order + a sum over K
        pos_unsorted = torch.empty_like(pos).index_copy_(0, order, pos)
        y_flat = yb[idx.reshape(-1) * C + pos_unsorted.clamp(max=C - 1)]
        w = gates.reshape(-1) * (pos_unsorted < C)
        out = (wide(y_flat.view(T, -1, d))
               * w.view(T, -1)[..., None]).sum(1)
    else:
        gate_sorted = gates.reshape(-1)[order] * keep
        out = segment_sum(wide(yb[slot]) * gate_sorted[:, None],
                          t_sorted.to(torch.int32), T)

    if cfg.n_shared_experts:
        shared = swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
        if cfg.shared_expert_gate:
            # x.astype(f32) @ shared_gate promotes the gate in JAX
            shared = shared * torch.sigmoid(
                wide(x) @ wide(lp["shared_gate"])).to(shared.dtype)
        out = out + wide(shared)
    return out.to(x.dtype), lb_loss


def _norm(x, scale, bias, cfg: TransformerConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _wsc(x: torch.Tensor, axes_first, ndim: int) -> torch.Tensor:
    """The JAX package's sharding constraint on the leading (batch) dim:
    the identity on a tensor of one process."""
    del axes_first, ndim
    return x


def _layer(x, lp: Params, cfg: TransformerConfig, positions, cache_k,
           cache_v, cache_len: int, training: bool = False, attend=None):
    """One transformer block: ``(x, lb_loss)``.  cache_*: [B, Smax, Hk,
    dh] or None; the new keys and values are written into them in place.
    ``training`` sends the attention to its plain backends (the kernel
    has no backward); otherwise it goes through ``attend`` (default
    :func:`attention`), called as :func:`attention` is.  Serving (a
    cache) sizes the MoE buffer for no drop at B*S <= 4096 and at a 2x
    capacity factor above."""
    B, S, d = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    h = _norm(x, lp["attn_norm_scale"], lp.get("attn_norm_bias"), cfg)
    if cfg.attn_batch_shard_axes and cache_k is None:
        h = _wsc(h, cfg.attn_batch_shard_axes, 3)
    q = (h @ lp["wq"].reshape(d, H * dh)).view(B, S, H, dh)
    k = (h @ lp["wk"].reshape(d, Hk * dh)).view(B, S, Hk, dh)
    v = (h @ lp["wv"].reshape(d, Hk * dh)).view(B, S, Hk, dh)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)

    if cache_k is not None:
        # the cache stores UNexpanded KV heads
        cache_k[:, cache_len:cache_len + S] = k.to(cache_k.dtype)
        cache_v[:, cache_len:cache_len + S] = v.to(cache_v.dtype)
        kk, vv, q_offset = cache_k, cache_v, cache_len
    else:
        kk, vv, q_offset = k, v, 0
    if S > 1 and cfg.attn_kv_expand:
        kk = kk.repeat_interleave(H // Hk, dim=2)
        vv = vv.repeat_interleave(H // Hk, dim=2)
    # the JAX package's head-axis constraint on q/k/v (S > 1) is the
    # identity here, as _wsc is

    attend = attention_plain if training else (attend or attention)
    attn = attend(q, kk, vv, cfg, causal=True, q_offset=q_offset)
    attn_out = attn.reshape(B, S, H * dh) @ lp["wo"].reshape(H * dh, d)
    if cfg.attn_batch_shard_axes and cache_k is None:
        attn_out = _wsc(attn_out, cfg.batch_axes, 3)
    x = x + attn_out
    # the attention's tensors are dead past here: free them before the
    # FFN's [B, S, f] buffers exist (autograd keeps what it saved)
    del q, k, v, kk, vv, attn, attn_out
    h = _norm(x, lp["ffn_norm_scale"], lp.get("ffn_norm_bias"), cfg)
    if not cfg.moe:
        return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    serving = cache_k is not None
    y, lb = moe_ffn(h.reshape(B * S, d), lp, cfg,
                    no_drop=serving and B * S <= 4096, eval_mode=serving)
    return x + y.view(B, S, d), lb


def _hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: Optional[Params], training: bool = False, attend=None):
    """Final-normed hidden states [B, S, d] and the load-balance loss
    summed over layers (float32; 0 for a dense FFN); advances
    ``cache["len"]``.  ``attend``: as :func:`_layer` takes it."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    cache_len = cache["len"] if cache is not None else 0
    positions = torch.arange(S, device=tokens.device)[None, :] + cache_len
    lb_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in layers.items()}
        if cache is not None:
            x, lb = _layer(x, lp, cfg, positions, cache["k"][i],
                           cache["v"][i], cache_len, attend=attend)
        else:
            x, lb = _layer(x, lp, cfg, positions, None, None, 0, training,
                           attend)
        lb_sum = lb_sum + lb
    if cache is not None:
        cache["len"] = cache_len + S
    x = _norm(x, params["final_norm_scale"], params.get("final_norm_bias"),
              cfg)
    return x, lb_sum


def _logits(params: Params, x: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            cache: Optional[Params] = None):
    """tokens: [B, S] -> (logits [B, S, V], cache, lb_loss).

    With ``cache`` (see :func:`init_cache`) the call is a prefill (S > 1)
    or decode (S == 1) step at position ``cache["len"]``; the cache is
    updated in place and returned.  ``lb_loss`` is the MoE load-balance
    loss summed over layers (0 for a dense FFN)."""
    x, lb = _hidden(params, tokens, cfg, cache)
    return _logits(params, x, cfg), cache, lb


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: TransformerConfig):
    """forward() without the LM head and without a cache, on the
    training route (the plain attention backends): (final hidden states
    [B, S, d], lb_loss)."""
    return _hidden(params, tokens, cfg, None, training=True)


def loss_fn(params: Params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Causal LM loss: mean token cross-entropy in float32 plus the
    load-balance loss, through :func:`forward_hidden`.  ``ce_chunk`` is
    accepted and the loss computed unchunked (the chunking shapes only
    the JAX program's memory)."""
    x, lb = forward_hidden(params, tokens, cfg)
    return cross_entropy_loss(_logits(params, x, cfg), labels) + lb


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device=None) -> Params:
    """An empty cache: one zero [batch, max_len, Hk, dh] K and V tensor
    per layer, ``len`` 0."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype

    def zeros():
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.n_layers)]

    return {"k": zeros(), "v": zeros(), "len": 0}


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: Optional[int] = None, *, attend=None):
    """Build a KV cache from a prompt; returns (last-token logits, cache).
    Only the last position goes through the LM head (the JAX package
    computes every position's logits and keeps the last).  ``attend``
    replaces :func:`attention` (a cost trace's footprint, a check)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len or S, device=tokens.device)
    x, _ = _hidden(params, tokens, cfg, cache, attend=attend)
    return _logits(params, x[:, -1], cfg), cache


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: TransformerConfig, *, attend=None):
    """One-token decode: tokens [B, 1] -> (logits [B, V], cache updated
    in place); ``attend`` as :func:`prefill` takes it."""
    x, _ = _hidden(params, tokens, cfg, cache, attend=attend)
    return _logits(params, x[:, -1], cfg), cache
