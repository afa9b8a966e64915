"""The port's CompBin decode op surface held against the JAX package.

Same packed bytes (numpy, from a seed) go through the port's plain
PyTorch version (what its wrapper takes for a CPU tensor), the JAX
package's Pallas kernel in interpret mode, and the numpy host decoder.
Everything here is integer: the tolerance is ZERO (assert_array_equal).
The CUDA kernel itself cannot run without a GPU; ``chip_smoke.py`` holds
it against the same plain version on the card.
"""

import _torch_env  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compbin as ref_compbin
from repro.kernels import compbin_decode as ref_ops
from repro_torch.core import compbin as port_compbin
from repro_torch.kernels import compbin_decode as port_ops
from repro_torch.kernels.utils import ceil_div


def _packed(n: int, b: int, seed: int, hi=None):
    rng = np.random.default_rng(seed)
    hi = hi if hi is not None else min(2 ** (8 * b), 2 ** 31)
    ids = rng.integers(0, hi, n, dtype=np.int64)
    return ids, ref_compbin.encode_ids(ids, b)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 40000])
def test_decode_sweep_equals_reference(b, n):
    ids, packed = _packed(n, b, b * 1000 + n)
    out_port = port_ops.compbin_decode(torch.from_numpy(packed), b)
    out_plain = port_ops.compbin_decode_ref(torch.from_numpy(packed), b)
    out_jax = ref_ops.compbin_decode(jnp.asarray(packed), b, interpret=True)
    assert out_port.dtype == torch.int32 and out_port.shape == (n,)
    np.testing.assert_array_equal(out_port.numpy(), np.asarray(out_jax))
    np.testing.assert_array_equal(out_plain.numpy(), np.asarray(out_jax))
    np.testing.assert_array_equal(
        out_port.numpy(), ref_compbin.decode_ids(packed, b).astype(np.int32))
    np.testing.assert_array_equal(out_port.numpy(), ids.astype(np.int32))
    # the port's own host decoder is the same oracle
    np.testing.assert_array_equal(port_compbin.decode_ids(packed, b),
                                  ref_compbin.decode_ids(packed, b))
    np.testing.assert_array_equal(port_compbin.encode_ids(ids, b), packed)


@pytest.mark.parametrize("b", [5, 6, 7, 8])
def test_wide_ids_strip_to_four_bytes(b):
    ids, packed = _packed(3000, b, 50 + b, hi=2 ** 31)
    out_port = port_ops.compbin_decode(torch.from_numpy(packed), b)
    out_jax = ref_ops.compbin_decode(jnp.asarray(packed), b, interpret=True)
    np.testing.assert_array_equal(out_port.numpy(), np.asarray(out_jax))
    np.testing.assert_array_equal(out_port.numpy(), ids.astype(np.int32))


@pytest.mark.parametrize("b", [5, 8])
def test_wide_ids_with_high_bytes_raise_in_both(b):
    _, packed = _packed(100, b, 7, hi=2 ** 31)
    packed = packed.copy()
    packed[4 + b * 50] = 1           # byte 4 of id 50
    with pytest.raises(ValueError, match="IDs >= 2\\^32"):
        port_ops.compbin_decode(torch.from_numpy(packed), b)
    with pytest.raises(ValueError, match="IDs >= 2\\^32"):
        ref_ops.compbin_decode(jnp.asarray(packed), b, interpret=True)


@pytest.mark.parametrize("b", [0, 9])
def test_b_out_of_range_raises_in_both(b):
    raw = np.zeros(72, np.uint8)
    with pytest.raises(ValueError):
        port_ops.compbin_decode(torch.from_numpy(raw), b)
    with pytest.raises(ValueError):
        ref_ops.compbin_decode(jnp.asarray(raw), b, interpret=True)


def test_plain_version_rejects_wide_b_like_the_reference():
    raw = np.zeros(40, np.uint8)
    with pytest.raises(ValueError):
        port_ops.compbin_decode_ref(torch.from_numpy(raw), 5)
    with pytest.raises(ValueError):
        ref_ops.compbin_decode_ref(jnp.asarray(raw), 5)


def test_wrapper_checks_its_arguments():
    with pytest.raises(TypeError):
        port_ops.compbin_decode(torch.zeros(8, dtype=torch.int32), 2)
    with pytest.raises(TypeError):
        port_ops.compbin_decode(np.zeros(8, np.uint8), 2)
    with pytest.raises(ValueError, match="multiple"):
        port_ops.compbin_decode(torch.zeros(7, dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="contiguous"):
        port_ops.compbin_decode(torch.zeros(16, dtype=torch.uint8)[::2], 2)
    assert port_ops.compbin_decode(torch.zeros(0, dtype=torch.uint8),
                                   3).shape == (0,)


def test_cpu_tensor_never_counts_a_launch():
    before = port_ops.compbin_decode.launches
    port_ops.compbin_decode(torch.zeros(12, dtype=torch.uint8), 3)
    assert port_ops.compbin_decode.launches == before


def _bucket_sweep():
    ns = {0, 1, 2, 1000, 1023, 1024, 1025, 40000, 123457, (1 << 22)}
    for k in range(1, 23):
        ns.update({(1 << k) - 1, 1 << k, (1 << k) + 1})
    return sorted(n for n in ns if n <= (1 << 22))


def test_stream_bucket_ids_equal_over_sweep():
    assert port_ops.STREAM_GRANULE_IDS == ref_ops.STREAM_GRANULE_IDS
    from repro.kernels.compbin_decode.ops import stream_bucket_ids as ref_bucket
    for n in _bucket_sweep():
        for granule in (ref_ops.STREAM_GRANULE_IDS, 1 << 12, 1 << 20):
            assert port_ops.stream_bucket_ids(n, granule) == \
                ref_bucket(n, granule), (n, granule)
    assert ceil_div(7, 2) == 4 and ceil_div(8, 2) == 4


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 1024, 1025, 40000])
def test_pad_packed_for_stream_bytes_equal(b, n):
    _, packed = _packed(n, b, n + b)
    got, n_got = port_ops.pad_packed_for_stream(packed, b)
    want, n_want = ref_ops.pad_packed_for_stream(packed, b)
    assert n_got == n_want == n
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_pad_packed_for_stream_rejects_ragged_length_in_both():
    for ops in (port_ops, ref_ops):
        with pytest.raises(ValueError, match="not a multiple"):
            ops.pad_packed_for_stream(np.zeros(7, np.uint8), 3)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 777, 1024, 5000, 40000])
def test_decode_packed_stream_same_ids_and_bytes_h2d(b, n):
    _, packed = _packed(n, b, 31 * n + b)
    ids_p, h2d_p = port_ops.decode_packed_stream(packed, b, device="cpu")
    ids_r, h2d_r = ref_ops.decode_packed_stream(packed, b, interpret=True)
    assert ids_p.dtype == ids_r.dtype == np.int64
    assert h2d_p == h2d_r
    np.testing.assert_array_equal(ids_p, ids_r)
    np.testing.assert_array_equal(
        ids_p, ref_compbin.decode_ids(packed, b).astype(np.int64))


def test_packed_stream_decoder_registry_and_error():
    assert sorted(port_ops.PACKED_STREAM_DECODERS) == \
        sorted(ref_ops.PACKED_STREAM_DECODERS) == ["compbin", "logcsr"]
    for name in ("compbin", "logcsr"):
        assert port_ops.packed_stream_decoder(name) is \
            port_ops.decode_packed_stream
    with pytest.raises(ValueError, match="no device stream decoder") as e_port:
        port_ops.packed_stream_decoder("webgraph")
    with pytest.raises(ValueError, match="no device stream decoder") as e_ref:
        ref_ops.packed_stream_decoder("webgraph")
    assert str(e_port.value) == str(e_ref.value)
