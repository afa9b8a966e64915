"""A frozen CompBin writer (the paper's format, version 1).

Layout, little-endian: a 24-byte header (``b"CBIN"``, u16 version 1,
u8 ``b``, u8 flags with bit 0 = rows sorted, u64 ``|V|``, u64 ``|E|``),
``|V|+1`` u64 offsets, then ``|E|`` ids of ``b = ceil(log2 |V| / 8)``
bytes each, low byte first (eq. (1)).  The bytes equal the port's
``write_compbin`` on the same CSR; a copy lives here so that a change to
the program cannot move the benchmark's input.  The ids are packed where
they lie (on the card for a large graph) and copied to the host once.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

HEADER = struct.Struct("<4sHBBQQ")
MAGIC = b"CBIN"
VERSION = 1
FLAG_SORTED = 1


def bytes_per_id(n_vertices: int) -> int:
    """``b``: the fewest whole bytes that hold the id ``|V| - 1`` (at
    least 1, at most 8)."""
    return min(8, max(1, (max(n_vertices - 1, 1).bit_length() + 7) // 8))


def pack_ids(ids: torch.Tensor, b: int) -> torch.Tensor:
    """Non-negative ids as ``b`` little-endian bytes each: uint8[n * b],
    on the ids' device."""
    ids = ids.to(torch.int64)
    cols = [((ids >> (8 * i)) & 255).to(torch.uint8) for i in range(b)]
    return torch.stack(cols, dim=1).reshape(-1)


def write(path, offsets: torch.Tensor, neighbors: torch.Tensor,
          *, sorted_rows: bool = True) -> int:
    """Write the CSR (``offsets`` int64[|V|+1], ``neighbors`` ids) to
    ``path`` (a path or a binary file).  Returns the bytes written."""
    n = offsets.numel() - 1
    e = neighbors.numel()
    b = bytes_per_id(n)
    header = HEADER.pack(MAGIC, VERSION, b,
                         FLAG_SORTED if sorted_rows else 0, n, e)
    offs = offsets.to(torch.int64).cpu().numpy().astype("<u8", copy=False)
    packed = pack_ids(neighbors, b).cpu().numpy()
    own = isinstance(path, (str, os.PathLike))
    f = open(path, "wb") if own else path
    try:
        written = f.write(header)
        written += f.write(memoryview(np.ascontiguousarray(offs)).cast("B"))
        written += f.write(memoryview(np.ascontiguousarray(packed)))
        if own:
            # on storage before anyone reads it: no write-back in a window
            f.flush()
            os.fsync(f.fileno())
    finally:
        if own:
            f.close()
    return written
