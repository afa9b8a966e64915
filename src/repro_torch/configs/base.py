"""ArchSpec: one assigned architecture = full config + reduced smoke config
+ its shape catalog."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs import shapes as sh


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                      # "lm" | "gnn" | "recsys"
    citation: str
    make_config: Callable[[], Any]   # full (paper-exact) config
    make_reduced: Callable[[], Any]  # tiny same-family config for CPU smoke

    @property
    def shapes(self) -> dict:
        return {"lm": sh.LM_SHAPES, "gnn": sh.GNN_SHAPES,
                "recsys": sh.RECSYS_SHAPES}[self.family]
