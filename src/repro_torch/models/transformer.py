"""Decoder-only transformer of the port (dense FFN) — plain functions over
a params dict, mirroring the JAX package's ``models/transformer.py``.

Covers the dense LM architectures through one config: GQA attention
(``n_kv_heads <= n_heads``), optional QKV bias (qwen2), RoPE with partial
rotary (stablelm ``rope_pct=0.25``), RMSNorm or LayerNorm, SwiGLU FFN,
tied or separate LM head.  Entry points for serving: ``forward``,
``prefill`` (builds the KV cache) and ``decode_step`` (one token against
it).  The MoE FFN (``moe_ffn``), the training entry points (``loss_fn``,
``forward_hidden``) and the mesh options are not ported yet.

Attention: on a CUDA tensor EVERY call — prefill and decode, whatever
``attn_impl`` says — goes through the hand-written flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), handed the ``[B, S, H, dh]``
projections and the live part of the cache as strided views.  On a CPU
tensor the JAX package's own plain backends run: ``dense`` (materialised
scores) or ``chunked`` (online softmax over KV chunks, Python loops in
place of ``scan``; fully-future chunks are skipped, which leaves every
number as it was).  The JAX transformer never calls its Pallas kernel
(its docstring says the kernel implements the same contract on a TPU).

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
from repro_torch.models.common import dense_init, layer_norm, rms_norm

Params = dict

_MESH_FIELDS = ("attn_head_axis", "attn_batch_shard_axes", "batch_axes",
                "moe_ep_axis")


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
    # --- MoE (not ported yet: init_params and forward raise) ---
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

    def __post_init__(self):
        for name in _MESH_FIELDS:
            if getattr(self, name) is not None:
                raise ValueError(f"{name}={getattr(self, name)!r}: the port "
                                 f"runs on one card and has no mesh")

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


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers (moe_ffn) are not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights from ``generator`` in ``cfg.dtype`` (the JAX
    package's shapes and distributions, not its bits), on ``device``
    (None: the generator's device)."""
    _require_dense(cfg)
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    L, f, dt = cfg.n_layers, cfg.d_ff, cfg.dtype
    device = generator.device if device is None else device

    def W(*shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dt,
                          device=device)

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
    xr = x[..., :rot].float()
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
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
    scores = torch.einsum("bshgd,bthd->bhgst", qh.float(),
                          k.float()) * (dh ** -0.5)
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + q_offset
        kpos = torch.arange(T, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
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
    qf = q.float().reshape(B, S, Hk, g, dh)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, S, bq):
        qb = qf[:, q0:q0 + bq]
        nb = qb.shape[1]
        qpos = q0 + torch.arange(nb, device=q.device)[:, None] + q_offset
        m = torch.full((B, Hk, g, nb), -1e30, device=q.device)
        l = torch.zeros((B, Hk, g, nb), device=q.device)
        acc = torch.zeros((B, Hk, g, nb, dh), device=q.device)
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
    h = torch.nn.functional.silu(x @ wg) * (x @ wu)
    return h @ wd


def _norm(x, scale, bias, cfg: TransformerConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, scale, bias)
    return rms_norm(x, scale)


def _layer(x, lp: Params, cfg: TransformerConfig, positions, cache_k,
           cache_v, cache_len: int):
    """One transformer block.  cache_*: [B, Smax, Hk, dh] or None; the
    new keys and values are written into them in place."""
    B, S, d = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    h = _norm(x, lp["attn_norm_scale"], lp.get("attn_norm_bias"), cfg)
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

    attn = attention(q, kk, vv, cfg, causal=True, q_offset=q_offset)
    x = x + attn.reshape(B, S, H * dh) @ lp["wo"].reshape(H * dh, d)
    h = _norm(x, lp["ffn_norm_scale"], lp.get("ffn_norm_bias"), cfg)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _hidden(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: Optional[Params]) -> torch.Tensor:
    """Final-normed hidden states [B, S, d]; advances ``cache["len"]``."""
    _require_dense(cfg)
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    cache_len = cache["len"] if cache is not None else 0
    positions = torch.arange(S, device=tokens.device)[None, :] + cache_len
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in layers.items()}
        if cache is not None:
            x = _layer(x, lp, cfg, positions, cache["k"][i], cache["v"][i],
                       cache_len)
        else:
            x = _layer(x, lp, cfg, positions, None, None, 0)
    if cache is not None:
        cache["len"] = cache_len + S
    return _norm(x, params["final_norm_scale"], params.get("final_norm_bias"),
                 cfg)


def _logits(params: Params, x: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            cache: Optional[Params] = None):
    """tokens: [B, S] -> (logits [B, S, V], cache, lb_loss).

    With ``cache`` (see :func:`init_cache`) the call is a prefill (S > 1)
    or decode (S == 1) step at position ``cache["len"]``; the cache is
    updated in place and returned.  ``lb_loss`` is 0 (dense FFN only)."""
    x = _hidden(params, tokens, cfg, cache)
    lb = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, x, cfg), cache, lb


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
            max_len: Optional[int] = None):
    """Build a KV cache from a prompt; returns (last-token logits, cache).
    Only the last position goes through the LM head (the JAX package
    computes every position's logits and keeps the last)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len or S, device=tokens.device)
    x = _hidden(params, tokens, cfg, cache)
    return _logits(params, x[:, -1], cfg), cache


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: TransformerConfig):
    """One-token decode: tokens [B, 1] -> (logits [B, V], cache updated
    in place)."""
    x = _hidden(params, tokens, cfg, cache)
    return _logits(params, x[:, -1], cfg), cache
