"""Helpers shared by the ``test_torch_*`` suites: both packages side by
side (``ref`` = the JAX package, ``port`` = the PyTorch/CUDA port), fed
from numpy so neither sees the other's types."""

from __future__ import annotations

import io
import types

import numpy as np

import repro.core.codec
import repro.core.compbin
import repro.core.csr
import repro.core.paragrapher
import repro.core.pgfuse
import repro.core.policy
import repro.core.webgraph
import repro.graph
import repro_torch.core.codec
import repro_torch.core.compbin
import repro_torch.core.csr
import repro_torch.core.paragrapher
import repro_torch.core.pgfuse
import repro_torch.core.policy
import repro_torch.core.webgraph
import repro_torch.graph
from repro_torch.convert import csr_from_numpy

ref = types.SimpleNamespace(
    name="ref", codec=repro.core.codec, compbin=repro.core.compbin,
    csr=repro.core.csr, paragrapher=repro.core.paragrapher,
    pgfuse=repro.core.pgfuse, policy=repro.core.policy,
    webgraph=repro.core.webgraph, graph=repro.graph)
port = types.SimpleNamespace(
    name="port", codec=repro_torch.core.codec,
    compbin=repro_torch.core.compbin, csr=repro_torch.core.csr,
    paragrapher=repro_torch.core.paragrapher,
    pgfuse=repro_torch.core.pgfuse, policy=repro_torch.core.policy,
    webgraph=repro_torch.core.webgraph, graph=repro_torch.graph)

FORMATS = ("compbin", "logcsr", "webgraph")
SUFFIX = {"compbin": "cbin", "logcsr": "lgsr", "webgraph": "wg"}


def as_csr(side, offsets, neighbors):
    """``side``'s own CSR class over the given numpy arrays."""
    if side is port:
        return csr_from_numpy(offsets, neighbors)
    return side.csr.CSR(offsets=np.asarray(offsets, dtype=np.int64),
                        neighbors=np.asarray(neighbors))


def encode(side, offsets, neighbors, fmt: str) -> bytes:
    buf = io.BytesIO()
    side.paragrapher.save_graph(buf, as_csr(side, offsets, neighbors),
                                format=fmt)
    return buf.getvalue()


def assert_csr_equal(a, b) -> None:
    """Zero tolerance: integer arrays, compared element for element."""
    np.testing.assert_array_equal(np.asarray(a.offsets), np.asarray(b.offsets))
    np.testing.assert_array_equal(np.asarray(a.neighbors),
                                  np.asarray(b.neighbors))


def write_pair(tmp_path, offsets, neighbors, fmt: str, stem: str = "g"):
    """Write the graph with BOTH packages; asserts the bytes are equal and
    returns the (single) path both then read."""
    blob_ref = encode(ref, offsets, neighbors, fmt)
    blob_port = encode(port, offsets, neighbors, fmt)
    assert blob_ref == blob_port
    path = tmp_path / f"{stem}.{SUFFIX[fmt]}"
    path.write_bytes(blob_port)
    return str(path)
