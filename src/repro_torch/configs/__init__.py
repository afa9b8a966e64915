"""Architecture registry: ``--arch <id>`` resolution for the port's
launchers.  Ported: the GNNs (``gcn-cora``, ``pna``, ``meshgraphnet``,
``dimenet``) and the dense LMs (``smollm-360m``, ``qwen2-1.5b``,
``stablelm-1.6b``), in the JAX package's order; its other architectures
raise ``KeyError`` saying so."""

from __future__ import annotations

from repro_torch.configs import (dimenet, gcn_cora,  # noqa: F401
                                 meshgraphnet, pna, qwen2_1_5b, shapes,
                                 smollm_360m, stablelm_1_6b)
from repro_torch.configs.base import ArchSpec

_MODULES = [smollm_360m, qwen2_1_5b, stablelm_1_6b, dimenet, meshgraphnet,
            gcn_cora, pna]

REGISTRY: dict[str, ArchSpec] = {m.SPEC.arch_id: m.SPEC for m in _MODULES}

ARCH_IDS = list(REGISTRY)

#: the JAX package's architectures that this port does not hold yet
NOT_PORTED = ("qwen2-moe-a2.7b", "dbrx-132b", "din")


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
