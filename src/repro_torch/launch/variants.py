"""Named configuration variants (the JAX package's 16, unchanged).

``apply_variant(arch, shape, name)`` returns the kwargs for
:func:`repro_torch.launch.steps.build_cell` realizing that variant;
"baseline" is the paper-faithful configuration.  From the CLI:

    python -m repro_torch.launch.dryrun --arch dbrx-132b \
        --shape decode_32k --variant <name> --mesh card

Every override reaches a field the port has.  ``attn_chunk`` sizes the
plain chunked attention (training anywhere, serving on the CPU; serving
on the card calls the flash-attention kernel, which has its own tiles);
``remat`` and ``ce_chunk`` are accepted and read by nothing (they shape
the JAX program's memory).  ``moe_dispatch``, ``capacity_factor``,
``attn_p_bf16`` and ``attn_impl`` (where the plain attention runs) and
``gcn_transform_first`` act; ``edges_compbin`` hands the GNN cells
CompBin-packed edge ids that the loss decodes with the CompBin decode
op.
"""

from __future__ import annotations

from typing import Any


def apply_variant(arch: str, shape: str, name: str) -> dict[str, Any]:
    if name == "baseline":
        return {}
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}; known: {list(VARIANTS)}")
    return VARIANTS[name](arch, shape)


def _dense_attn(arch: str, shape: str) -> dict:
    return {"cfg_overrides": {"attn_impl": "dense"}}


def _chunk(n: int):
    def f(arch: str, shape: str) -> dict:
        return {"cfg_overrides": {"attn_chunk": n}}
    return f


def _no_remat(arch: str, shape: str) -> dict:
    return {"cfg_overrides": {"remat": False}}


def _moe_gather(arch: str, shape: str) -> dict:
    return {"cfg_overrides": {"moe_dispatch": "gather"}}


def _ce_chunk(n: int):
    def f(arch: str, shape: str) -> dict:
        return {"cfg_overrides": {"ce_chunk": n}}
    return f


def _edges_compbin(arch: str, shape: str) -> dict:
    return {"edges_packed": True}


def _combo_lm_best(arch: str, shape: str) -> dict:
    # best-of combination for LM train cells
    over = {"ce_chunk": 512, "attn_chunk": 1024}
    return {"cfg_overrides": over}


def _combo_moe_best(arch: str, shape: str) -> dict:
    return {"cfg_overrides": {"moe_dispatch": "gather", "ce_chunk": 512}}


def _moe_gather_cf(cf: float):
    def f(arch: str, shape: str) -> dict:
        return {"cfg_overrides": {"moe_dispatch": "gather",
                                  "capacity_factor": cf}}
    return f


VARIANTS = {
    "dense_attn": _dense_attn,
    "chunk_1024": _chunk(1024),
    "chunk_2048": _chunk(2048),
    "chunk_4096": _chunk(4096),
    "chunk_8192": _chunk(8192),
    "no_remat": _no_remat,
    "moe_gather": _moe_gather,
    "moe_gather_cf1": _moe_gather_cf(1.0),
    "moe_gather_cf2": _moe_gather_cf(2.0),
    "ce_chunk_512": _ce_chunk(512),
    "ce_chunk_1024": _ce_chunk(1024),
    "edges_compbin": _edges_compbin,
    "combo_lm_best": _combo_lm_best,
    "combo_moe_best": _combo_moe_best,
    "attn_p_bf16": lambda a, s: {"cfg_overrides": {"attn_p_bf16": True}},
    "gcn_transform_first": lambda a, s: {"gnn_cfg_overrides":
                                         {"transform_first": True}},
}
