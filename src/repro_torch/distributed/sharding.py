"""Device placement for streamed CSR shards (data/graph_stream.py).

The JAX package places each shard on a slice of a device mesh; this port
drives one GPU per process, so both functions reduce to "the one device"
and return a :class:`torch.device`.  The names and arguments are kept so
the loader reads the same in both packages.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.utils import resolve_device


def host_submesh(device: "torch.device | str | None" = None,
                 process_index: int = 0,
                 process_count: int = 1) -> torch.device:
    """The device process ``process_index`` of ``process_count`` drives.

    Every process of a multi-host load owns its own card and passes it as
    ``device`` (``None`` = the current CUDA device; raises without one).
    """
    if not 0 <= process_index < max(1, process_count):
        raise ValueError(
            f"process_index {process_index} not in [0, {process_count})")
    return resolve_device(device)


def stream_shard_placement(device: "torch.device | str | None",
                           n_edges: int, *, process_index: int = 0,
                           process_count: int = 1
                           ) -> tuple[torch.device, torch.device]:
    """(neighbors, offsets) placement for one streamed CSR partition:
    both live whole on the calling process's device."""
    dev = host_submesh(device, process_index, process_count)
    return dev, dev
