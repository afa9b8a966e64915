"""K2, the segment sum: the port's ``segment_sum`` on CPU tensors (its
plain version) against the JAX package's op with the Pallas kernel in
interpret mode, on the same numpy inputs.  Tolerance as the JAX package
holds its own kernel (``tests/test_kernels.py``): f32 rtol 1e-5 / atol
1e-4, bf16 inputs rtol 2e-2 / atol 2e-1; the result is f32 either way."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_sum import segment_sum as ref_segment_sum
from repro.kernels.segment_sum import segment_sum_ref as ref_oracle
from repro_torch.kernels.segment_sum import segment_sum, segment_sum_ref

TOL = {"f32": 1e-5, "bf16": 2e-2}
SWEEP = [(64, 16, 4), (513, 200, 7), (2048, 128, 1024), (100, 1, 100),
         (1, 8, 1)]


def _both(e, d, n, dtype, id_hi=None, seed=None):
    rng = np.random.default_rng(e + d + n if seed is None else seed)
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(-1, n if id_hi is None else id_hi, e).astype(np.int32)
    jmsgs = jnp.asarray(msgs)
    tmsgs = torch.from_numpy(msgs)
    if dtype == "bf16":
        jmsgs, tmsgs = jmsgs.astype(jnp.bfloat16), tmsgs.to(torch.bfloat16)
    want = np.asarray(ref_segment_sum(jmsgs, jnp.asarray(ids), n,
                                      interpret=True))
    got = segment_sum(tmsgs, torch.from_numpy(ids), n)
    return got, want


def _close(got, want, dtype):
    tol = TOL[dtype]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("E,D,N", SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segment_sum_sweep_matches_jax(E, D, N, dtype):
    got, want = _both(E, D, N, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_more_segments_than_the_tpu_kernel_takes(dtype):
    # N > MAX_KERNEL_SEGMENTS: the JAX op falls back to XLA, the port's
    # op has no cliff
    got, want = _both(3000, 6, 9000, dtype, seed=3)
    _close(got, want, dtype)


@pytest.mark.parametrize("E,D,N", [(513, 200, 7), (100, 1, 100), (1, 8, 1)])
def test_ids_at_or_above_n_are_dropped(E, D, N):
    got, want = _both(E, D, N, "f32", id_hi=N + 2)
    _close(got, want, "f32")


@pytest.mark.parametrize("E,D,N", [(0, 8, 5), (6, 3, 0), (0, 0, 0)])
def test_empty_inputs(E, D, N):
    msgs = torch.randn(E, D)
    ids = torch.zeros(E, dtype=torch.int32)
    out = segment_sum(msgs, ids, N)
    assert out.dtype == torch.float32 and tuple(out.shape) == (N, D)
    assert not out.any()
    # the JAX op's Pallas arm cannot tile zero edges; its oracle can
    want = np.asarray(ref_oracle(jnp.asarray(msgs.numpy()),
                                 jnp.asarray(ids.numpy()), N))
    assert want.shape == (N, D) and not want.any()


def test_cpu_path_is_the_plain_version_bit_for_bit():
    rng = np.random.default_rng(9)
    msgs = torch.from_numpy(rng.standard_normal((700, 33)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 60, 700))          # int64 ids
    before = segment_sum.launches
    got = segment_sum(msgs, ids, 50)
    assert segment_sum.launches == before     # a CPU tensor never launches
    assert torch.equal(got, segment_sum_ref(msgs, ids, 50))
    want = np.zeros((50, 33), np.float64)
    for e, i in enumerate(ids.numpy()):
        if 0 <= i < 50:
            want[i] += msgs[e].double().numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bad_arguments_raise():
    m = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="\\[E, D\\]"):
        segment_sum(m[:, 0], torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="E mismatch"):
        segment_sum(m, torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(TypeError, match="floating"):
        segment_sum(m.int(), torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(TypeError, match="int32 or int64"):
        segment_sum(m, torch.zeros(4), 3)
    with pytest.raises(ValueError, match="num_segments"):
        segment_sum(m, torch.zeros(4, dtype=torch.int32), -1)
