"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  Ported: the MoE LMs (``qwen2-moe-a2.7b``, ``dbrx-132b``),
the dense LMs (``smollm-360m``, ``qwen2-1.5b``, ``stablelm-1.6b``) and
the GNNs (``dimenet``, ``meshgraphnet``, ``gcn-cora``, ``pna``), in the
JAX package's order; its recsys architecture (``din``) raises
``KeyError`` saying so."""

from __future__ import annotations

from repro_torch.configs import (dbrx_132b, dimenet,  # noqa: F401
                                 gcn_cora, meshgraphnet, pna, qwen2_1_5b,
                                 qwen2_moe_a2_7b, shapes, smollm_360m,
                                 stablelm_1_6b)
from repro_torch.configs.base import ArchSpec

_MODULES = [qwen2_moe_a2_7b, dbrx_132b, smollm_360m, qwen2_1_5b,
            stablelm_1_6b, dimenet, meshgraphnet, gcn_cora, pna]

REGISTRY: dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in _MODULES}

ARCH_IDS = list(REGISTRY)

#: the JAX package's architectures that this port does not hold yet
NOT_PORTED = ("din",)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{ARCH_IDS}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return REGISTRY[arch_id]


def all_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells of the ported architectures."""
    out = []
    for arch_id, spec in REGISTRY.items():
        for shape_id in spec.shapes:
            out.append((arch_id, shape_id))
    return out
