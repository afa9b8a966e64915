"""CompBin-packed token shards — the paper's idea applied to the LM input
pipeline (the JAX package's ``data/tokens.py``, byte for byte the same
files).

CompBin packs any bounded-alphabet integer stream in ``ceil(log2 A / 8)``
bytes per symbol.  Token IDs with vocab 151,936 (qwen2) or 49,152 (smollm)
need 3 bytes, not 4 — 25% less storage *and* 25% less host->device traffic
per step.  Decode is eq. (1): shifts and adds, either on the host (numpy)
or on the card (``kernels/compbin_decode``, K1, from the packed batch
that ``batches(packed=True)`` yields).

Shard layout:

    magic b"CTOK" | version u16 | b u8 | pad u8 | vocab u64 | n_tokens u64
    packed tokens  n_tokens * b bytes (little-endian per token)

Shards are read through PG-Fuse (large-block cache) so many worker threads
issuing small batch reads against shared storage coalesce into 32 MiB
underlying requests — the exact pathology/remedy pair of paper §III.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator, Optional, Union

import numpy as np

from repro_torch.core import compbin, pgfuse

MAGIC = b"CTOK"
VERSION = 1
HEADER_SIZE = 24
_HEADER_STRUCT = struct.Struct("<4sHBBQQ")
assert _HEADER_STRUCT.size == HEADER_SIZE


class TokenShardWriter:
    def __init__(self, path: Union[str, os.PathLike], vocab: int):
        self.path = os.fspath(path)
        self.vocab = int(vocab)
        self.b = compbin.bytes_per_vertex(self.vocab)
        self._f: BinaryIO = open(self.path, "wb")
        self._n = 0
        self._f.write(_HEADER_STRUCT.pack(MAGIC, VERSION, self.b, 0, self.vocab, 0))

    def append(self, tokens: np.ndarray) -> None:
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.size and int(tokens.max()) >= self.vocab:
            raise ValueError("token id >= vocab")
        self._f.write(compbin.encode_ids(tokens.astype(np.uint64), self.b).tobytes())
        self._n += tokens.size

    def close(self) -> None:
        self._f.seek(0)
        self._f.write(_HEADER_STRUCT.pack(MAGIC, VERSION, self.b, 0, self.vocab, self._n))
        self._f.close()

    def __enter__(self) -> "TokenShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_token_shard(path: Union[str, os.PathLike], tokens: np.ndarray,
                      vocab: int) -> None:
    with TokenShardWriter(path, vocab) as w:
        w.append(tokens)


class TokenShardReader:
    """Random-access batch reader over a packed shard.

    ``use_pgfuse=True`` interposes the block cache; ``batches(...,
    packed=True)`` yields the *packed* uint8 batch for on-device decode
    with ``kernels/compbin_decode`` (saving (4-b)/4 of host->HBM
    traffic).
    """

    def __init__(self, path: Union[str, os.PathLike], *,
                 use_pgfuse: bool = False,
                 pgfuse_block_size: int = pgfuse.DEFAULT_BLOCK_SIZE,
                 pgfuse_max_resident_bytes: Optional[int] = None):
        self.path = os.fspath(path)
        self._fs: Optional[pgfuse.PGFuseFS] = None
        if use_pgfuse:
            self._fs = pgfuse.PGFuseFS(block_size=pgfuse_block_size,
                                       max_resident_bytes=pgfuse_max_resident_bytes)
        with self._open() as f:
            raw = f.read(HEADER_SIZE)
        magic, version, b, _, vocab, n_tokens = _HEADER_STRUCT.unpack(raw)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a token shard (magic {magic!r})")
        if version != VERSION:
            raise ValueError(f"unsupported token shard version {version}")
        self.b, self.vocab, self.n_tokens = b, vocab, n_tokens

    def _open(self):
        if self._fs is not None:
            return self._fs.open(self.path)
        return open(self.path, "rb")

    def read_packed(self, start: int, count: int) -> np.ndarray:
        """Packed bytes for tokens [start, start+count) -> uint8[count*b]."""
        with self._open() as f:
            f.seek(HEADER_SIZE + start * self.b)
            raw = f.read(count * self.b)
        return np.frombuffer(raw, dtype=np.uint8)

    def read_tokens(self, start: int, count: int) -> np.ndarray:
        return compbin.decode_ids(self.read_packed(start, count), self.b).astype(np.int32)

    def batches(self, batch: int, seq: int, *, n_steps: Optional[int] = None,
                seed: int = 0, packed: bool = False) -> Iterator[np.ndarray]:
        """Yield [batch, seq(+1)] token windows (+1 for next-token labels).

        packed=True yields uint8[batch, (seq+1)*b] for on-device decode.
        """
        per = seq + 1
        n_windows = self.n_tokens // per
        if n_windows < batch:
            raise ValueError("shard too small for the requested batch")
        rng = np.random.default_rng(seed)
        step = 0
        while n_steps is None or step < n_steps:
            idx = rng.integers(0, n_windows, batch)
            rows = []
            for w in idx:
                if packed:
                    rows.append(self.read_packed(int(w) * per, per))
                else:
                    rows.append(self.read_tokens(int(w) * per, per))
            yield np.stack(rows)
            step += 1

    def pgfuse_stats(self) -> Optional[pgfuse.PGFuseStats]:
        return self._fs.stats() if self._fs is not None else None

    def close(self) -> None:
        if self._fs is not None:
            self._fs.unmount()
