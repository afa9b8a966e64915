"""DIN — Deep Interest Network [arXiv:1706.06978].

Config: embed_dim=18, seq_len=100, attention MLP 80-40, final MLP 200-80,
target-attention interaction.

The hot path is the embedding lookup over a huge sparse table (items
10M x 18, categories 10k x 18): a plain tensor gather (``table[ids]``),
as the JAX package's ``jnp.take``, whose backward is autograd's
(``index_put_`` with accumulation into a dense table-shaped gradient).
The JAX package has no kernel for either.  Padding ids (-1) give zero
rows; an id at or above the table's row count reads the last row, as
the JAX package's gather clamps it.

Target attention (the paper's contribution): per history item j,
  a_j = MLP([e_j, e_c, e_j - e_c, e_j * e_c]) -> scalar (sigmoid, no
softmax) with the candidate embedding e_c; the user interest is
sum_j a_j e_j.  ``score_candidates`` broadcasts one user's history
against N candidates for retrieval scoring, as one [N, S, 4d] MLP sweep.

The parameters are a dict with the JAX package's keys
(``item_table``, ``cate_table``, ``attn``: ``a0_w, a0_b, ...``, ``mlp``:
``m0_w, ...``); :func:`repro_torch.convert.din_params_from_numpy`
carries the reference's weights over.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import dense_init, init_mlp, mlp, wide


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    embed_dim: int = 18
    seq_len: int = 100
    n_items: int = 10_000_000
    n_cates: int = 10_000
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    dtype: torch.dtype = torch.float32

    @property
    def d_item(self) -> int:          # item embedding || category embedding
        return 2 * self.embed_dim


def _attn_names(cfg: DINConfig) -> list[str]:
    return [f"a{i}" for i in range(len(cfg.attn_mlp) + 1)]


def _mlp_names(cfg: DINConfig) -> list[str]:
    return [f"m{i}" for i in range(len(cfg.mlp) + 1)]


def init_params(cfg: DINConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights drawn from ``generator`` on its own device
    (truncated-normal; the tables at scale 0.01), zero biases, placed on
    ``device`` (default: the generator's).  Pass a generator on the card
    to draw the 10M x 18 item table there rather than on the host."""
    device = generator.device if device is None else device
    d = cfg.d_item
    attn_sizes = [4 * d, *cfg.attn_mlp, 1]
    mlp_sizes = [3 * d, *cfg.mlp, 1]
    return {
        "item_table": dense_init(generator, (cfg.n_items, cfg.embed_dim),
                                 scale=0.01, dtype=cfg.dtype, device=device),
        "cate_table": dense_init(generator, (cfg.n_cates, cfg.embed_dim),
                                 scale=0.01, dtype=cfg.dtype, device=device),
        "attn": init_mlp(generator, attn_sizes, _attn_names(cfg), cfg.dtype,
                         device),
        "mlp": init_mlp(generator, mlp_sizes, _mlp_names(cfg), cfg.dtype,
                        device),
    }


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with every id clamped into [0, rows): the JAX
    package's gather semantics (no index error, no device assert)."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def embed_items(params: dict, item_ids: torch.Tensor,
                cate_ids: torch.Tensor) -> torch.Tensor:
    """[...] ids -> [..., 2*embed_dim]; item id == -1 -> zeros (padding);
    ids at or above a table's row count read its last row."""
    e = torch.cat([_rows(params["item_table"], item_ids),
                   _rows(params["cate_table"], cate_ids)], dim=-1)
    return torch.where((item_ids >= 0)[..., None], e, 0)


def target_attention(params: dict, hist: torch.Tensor, cand: torch.Tensor,
                     mask: torch.Tensor, cfg: DINConfig) -> torch.Tensor:
    """hist: [B, S, d]; cand: [B, d]; mask: [B, S] -> interest [B, d]."""
    c = cand[:, None, :].expand(hist.shape)
    a_in = torch.cat([hist, c, hist - c, hist * c], dim=-1)
    scores = mlp(params["attn"], a_in, _attn_names(cfg), act=torch.sigmoid)
    scores = torch.where(mask[..., None], scores, 0)    # no softmax (paper)
    return torch.sum(scores * hist, dim=1)


def forward(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """CTR logits [B].  batch: hist_items/hist_cates [B,S], cand_item/
    cand_cate [B]; padding ids == -1."""
    hist = embed_items(params, batch["hist_items"], batch["hist_cates"])
    cand = embed_items(params, batch["cand_item"], batch["cand_cate"])
    mask = batch["hist_items"] >= 0
    interest = target_attention(params, hist, cand, mask, cfg)
    feats = torch.cat([interest, cand, interest * cand], dim=-1)
    return mlp(params["mlp"], feats, _mlp_names(cfg))[..., 0]


def score_candidates(params: dict, batch: dict,
                     cfg: DINConfig) -> torch.Tensor:
    """Retrieval scoring: one user, N candidates -> logits [N].

    batch: hist_items/hist_cates [S], cand_items/cand_cates [N].  The
    target attention is recomputed per candidate (that is DIN's point),
    batched over N as one [N, S, 4d] MLP sweep, not a loop.
    """
    hist = embed_items(params, batch["hist_items"], batch["hist_cates"])
    cands = embed_items(params, batch["cand_items"], batch["cand_cates"])
    mask = batch["hist_items"] >= 0
    n, s = cands.shape[0], hist.shape[0]
    hist_b = hist[None].expand(n, s, hist.shape[-1])
    interest = target_attention(params, hist_b, cands,
                                mask[None].expand(n, s), cfg)
    feats = torch.cat([interest, cands, interest * cands], dim=-1)
    return mlp(params["mlp"], feats, _mlp_names(cfg))[..., 0]


def loss_fn(params: dict, batch: dict, cfg: DINConfig) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy of the CTR logits, in f32
    (float64 stays float64: :func:`repro_torch.models.common.wide`)."""
    logits = wide(forward(params, batch, cfg))
    labels = batch["labels"].to(logits.dtype)
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
