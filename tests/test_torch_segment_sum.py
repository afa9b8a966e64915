"""K2, the segment sum: the port's ``segment_sum`` on CPU tensors (its
plain version) against the JAX package's op with the Pallas kernel in
interpret mode, on the same numpy inputs.  Tolerance as the JAX package
holds its own kernel (``tests/test_kernels.py``): f32 rtol 1e-5 / atol
1e-4, bf16 inputs rtol 2e-2 / atol 2e-1; the result is f32 either way."""

from _torch_env import load_chip_smoke  # first: one torch thread
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


# --- int64 ids too wide for int32, the two CUDA designs' plan, layouts ---

from repro_torch.kernels.segment_sum import plan  # noqa: E402
from repro_torch.kernels.segment_sum.ops import (  # noqa: E402
    ROWS_MAX_EDGES, ROWS_MIN_WIDTH, _segment_sum_design)

WIDE = [2 ** 32, 2 ** 32 + 5, -2 ** 32 + 3, 2 ** 31]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wide_int64_ids_are_dropped_as_the_contract_says(dtype):
    """Ids outside [0, N) are dropped, int64 ones too wide for int32
    included (a cast to int32 would wrap 2^32 into segment 0, 2^32+5
    into 5).  The JAX op narrows its ids to int32 itself (``astype`` in
    its Pallas arm, XLA's scatter on the CPU), so it is given the ids the
    contract makes of these: -1."""
    n = 9
    rng = np.random.default_rng(16)
    ids = np.sort(rng.integers(-1, n, 200))
    at = rng.choice(200, 2 * len(WIDE) + 2, replace=False)
    ids[at] = WIDE * 2 + [n, n]                 # N itself is dropped too
    msgs = rng.standard_normal((200, 5)).astype(np.float32)
    tmsgs = torch.from_numpy(msgs)
    jmsgs = jnp.asarray(msgs)
    if dtype == "bf16":
        tmsgs, jmsgs = tmsgs.to(torch.bfloat16), jmsgs.astype(jnp.bfloat16)
    got = segment_sum(tmsgs, torch.from_numpy(ids), n)
    dropped = np.where((ids >= 0) & (ids < n), ids, -1).astype(np.int32)
    want = np.asarray(ref_segment_sum(jmsgs, jnp.asarray(dropped), n,
                                      interpret=True))
    _close(got, want, dtype)
    # and exactly what the same ids give with the wide ones written as -1
    assert torch.equal(got, segment_sum(tmsgs, torch.from_numpy(dropped), n))
    wrapped = torch.from_numpy(ids).to(torch.int32)      # what was fixed
    assert not torch.equal(got, segment_sum(tmsgs, wrapped, n))


def _tree_dst(n_seeds, fanouts, rng, p_valid=0.7):
    """edge_dst of a padded tree block as the GCN server builds it."""
    from types import SimpleNamespace
    from repro_torch.launch.data_gnn import block_to_edges
    valid = [np.ones(n_seeds, bool)]
    for f in fanouts:
        valid.append(np.repeat(valid[-1], f)
                     & (rng.random(valid[-1].size * f) < p_valid))
    block = SimpleNamespace(layer_nodes=[np.zeros(v.size) for v in valid],
                            layer_valid=valid, fanouts=fanouts)
    _, dst, n = block_to_edges(block)
    return dst.astype(np.int32), n


def _layout(kind, rng):
    if kind == "served":
        return _tree_dst(16, (5, 5), rng)
    if kind == "sorted":
        return np.sort(rng.integers(0, 300, 900)).astype(np.int32), 300
    if kind == "permuted":
        return rng.permutation(np.sort(rng.integers(0, 300, 900))
                               ).astype(np.int32), 300
    if kind == "all_invalid":
        return rng.choice(np.array([-1, 40, 47], np.int32), 500), 40
    if kind == "one_segment":
        return np.full(700, 3, np.int32), 10
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["served", "sorted", "permuted",
                                  "all_invalid", "one_segment"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layouts_match_jax(kind, dtype):
    """The id layouts the CUDA designs are held to on the card, here
    through the plain version against the JAX op (Pallas, interpret)."""
    rng = np.random.default_rng(7)
    ids, n = _layout(kind, rng)
    msgs = rng.standard_normal((ids.size, 19)).astype(np.float32)
    tmsgs, jmsgs = torch.from_numpy(msgs), jnp.asarray(msgs)
    if dtype == "bf16":
        tmsgs, jmsgs = tmsgs.to(torch.bfloat16), jmsgs.astype(jnp.bfloat16)
    want = np.asarray(ref_segment_sum(jmsgs, jnp.asarray(ids), n,
                                      interpret=True))
    _close(segment_sum(tmsgs, torch.from_numpy(ids), n), want, dtype)


def test_plain_version_sums_each_row_in_edge_order_from_zero():
    """The sum the rows design takes on the card (each row from +0.0,
    its edges in order, in f32) is what the CPU plain version gives, bit
    for bit: so the two can be held to each other with torch.equal."""
    rng = np.random.default_rng(11)
    ids, n = _tree_dst(32, (5, 5), rng)
    msgs = rng.standard_normal((ids.size, 23)).astype(np.float32)
    want = np.zeros((n, 23), np.float32)
    for e in range(ids.size):
        if ids[e] >= 0:
            want[ids[e]] = want[ids[e]] + msgs[e]       # f32 adds in order
    got = segment_sum(torch.from_numpy(msgs), torch.from_numpy(ids), n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("design", ["atomic", "rows"])
def test_design_entry_on_cpu_is_the_plain_version(design):
    rng = np.random.default_rng(5)
    msgs = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 40, 300))
    before = segment_sum.launches
    got = _segment_sum_design(msgs, ids, 40, design)
    assert segment_sum.launches == before
    assert torch.equal(got, segment_sum_ref(msgs, ids, 40))


def test_design_entry_refuses_an_unknown_design():
    with pytest.raises(ValueError, match="design must be one of"):
        _segment_sum_design(torch.zeros(2, 2), torch.zeros(2,
                            dtype=torch.int32), 2, "sorted")


@pytest.mark.parametrize("e,d,n,want", [
    (30720, 1433, 31744, "rows"),       # served layer 0 (Cora's width)
    (30720, 16, 31744, "atomic"),       # served layer 1 (d_hidden)
    (30720, 1, 31744, "atomic"),        # served degree
    (ROWS_MAX_EDGES, ROWS_MIN_WIDTH, 10, "rows"),
    (ROWS_MAX_EDGES + 1, ROWS_MIN_WIDTH, 10, "atomic"),
    (ROWS_MAX_EDGES, ROWS_MIN_WIDTH - 1, 10, "atomic"),
    (0, ROWS_MIN_WIDTH, 10, "rows"),
])
def test_plan_at_the_served_shapes_and_its_limits(e, d, n, want):
    assert plan(e, d, n) == want


# --- K2's backward against the JAX package's own gradient --------------

import jax  # noqa: E402

from repro.models.gnn.layers import scatter_sum  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    grad_vector_width, segment_sum_backward, segment_sum_grad_ref)
from repro_torch.kernels.segment_sum.ops import (  # noqa: E402
    GRAD_VECS, _segment_sum_backward_vec)

#: chip_smoke.py's K2_SWEEP, and its int32 layouts (``wide`` holds int64
#: ids, which the JAX op wraps: ROADMAP Queue 3)
K2_SWEEP = [(64, 16, 4), (513, 200, 7), (2048, 128, 1024), (100, 1, 100),
            (1, 8, 1), (40000, 24, 20000)]
INT32_LAYOUTS = ["served", "sorted", "permuted", "all_invalid",
                 "one_segment", "ids_ge_n", "many_segments", "no_edges"]


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, for its K2 sweep and id layouts."""
    return load_chip_smoke()


def _grads_match_jax(ids, n, d, rng):
    """The gradient of the sum with respect to the messages, for one
    ``grad_out``: the JAX package's, by ``jax.vjp`` of the reference's
    training op (``scatter_sum``, XLA's segment sum), against the port's
    plain backward, its public entry and autograd through its
    ``segment_sum``, all on the same numpy inputs.  Tolerance zero: the
    gradient of a sum is a gather, with no arithmetic."""
    e = ids.size
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    g = rng.standard_normal((n, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda m: scatter_sum(m, jnp.asarray(ids), n,
                                           use_kernel=False),
                     jnp.asarray(msgs))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tids, tg = torch.from_numpy(ids), torch.from_numpy(g)
    np.testing.assert_array_equal(segment_sum_grad_ref(tg, tids, n).numpy(),
                                  want)
    np.testing.assert_array_equal(segment_sum_backward(tg, tids, n).numpy(),
                                  want)
    tm = torch.from_numpy(msgs).requires_grad_()
    out = segment_sum(tm, tids, n)
    if out.requires_grad:                 # E = 0: nothing to differentiate
        out.backward(tg)
        np.testing.assert_array_equal(tm.grad.numpy(), want)
    else:
        assert e == 0 and want.shape == (0, d)


@pytest.mark.parametrize("E,D,N", K2_SWEEP)
@pytest.mark.parametrize("above", [0, 3])
def test_backward_on_the_sweep_matches_jax(smoke, E, D, N, above):
    """Ids over [-1, N) and [-1, N+3), as ``phase_segment_sum_checks``
    draws them: -1 padding and ids >= N give zero rows in both."""
    assert [tuple(x) for x in K2_SWEEP] == list(smoke.K2_SWEEP)
    rng = np.random.default_rng(E + D + N + above)
    ids = rng.integers(-1, N + above, E).astype(np.int32)
    _grads_match_jax(ids, N, D, rng)


@pytest.mark.parametrize("kind", INT32_LAYOUTS)
def test_backward_on_the_layouts_matches_jax(smoke, kind):
    assert tuple(INT32_LAYOUTS) + ("wide",) == smoke.K2_LAYOUTS
    rng = np.random.default_rng(INT32_LAYOUTS.index(kind) + 40)
    ids, n, d, _ = smoke.k2_layout(kind, rng)
    assert ids.dtype == np.int32
    _grads_match_jax(ids, n, d, rng)


@pytest.mark.parametrize("d,offset,want", [
    (16, False, 4),            # GCN's hidden width: 16-byte vectors
    (6, False, 2),
    (1433, False, 1),          # Cora's width
    (16, True, 1),             # a view one float into its allocation
])
def test_grad_vector_width(d, offset, want):
    base = torch.zeros(3 * d + 4)
    grad = base[1:3 * d + 1] if offset else base[:3 * d]
    out = torch.zeros(5, d)
    assert base.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert grad_vector_width(d, grad.view(3, d), out) == want
    assert grad_vector_width(d, out, grad.view(3, d)) == want


def test_backward_width_entry_on_cpu_is_the_plain_version():
    """The entry that forces a vector width takes the plain version on a
    CPU tensor whatever the width, launches nothing, and refuses a width
    the kernel has not."""
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 33, 200))
    before = segment_sum.grad_launches
    for vec in GRAD_VECS:
        assert torch.equal(_segment_sum_backward_vec(g, ids, 30, vec),
                           segment_sum_grad_ref(g, ids, 30))
    assert segment_sum.grad_launches == before
    with pytest.raises(ValueError, match="vec must be one of"):
        _segment_sum_backward_vec(g, ids, 30, 3)


# --- K2's fused forward, gather_scale_sum, on the CPU ---

from repro_torch.kernels.segment_sum import gather_scale_sum  # noqa: E402

_I32 = torch.int32


@pytest.mark.parametrize("args,err,match", [
    ((torch.zeros(4), torch.zeros(3, dtype=_I32), torch.zeros(3),
      torch.zeros(3, dtype=_I32), 2), ValueError, "\\[NX, D\\]"),
    ((torch.zeros(4, 2), torch.zeros(3, dtype=_I32), torch.zeros(2),
      torch.zeros(3, dtype=_I32), 2), ValueError, "E mismatch"),
    ((torch.zeros(4, 2, dtype=_I32), torch.zeros(3, dtype=_I32),
      torch.zeros(3), torch.zeros(3, dtype=_I32), 2), TypeError,
     "floating"),
    ((torch.zeros(4, 2), torch.zeros(3), torch.zeros(3),
      torch.zeros(3, dtype=_I32), 2), TypeError, "src must be int32"),
    ((torch.zeros(4, 2), torch.zeros(3, dtype=_I32), torch.zeros(3),
      torch.zeros(3, dtype=torch.int16), 2), TypeError,
     "dst must be int32"),
    ((torch.zeros(4, 2), torch.zeros(3, dtype=_I32), torch.zeros(3),
      torch.zeros(3, dtype=torch.int64), 2), TypeError,
     "share a dtype"),
    ((torch.zeros(4, 2), torch.zeros(3, dtype=_I32), torch.zeros(3),
      torch.zeros(3, dtype=_I32), -1), ValueError, "num_segments"),
    ((torch.zeros(0, 2), torch.zeros(3, dtype=_I32), torch.zeros(3),
      torch.zeros(3, dtype=_I32), 2), ValueError, "no rows"),
    ((torch.zeros(4, 2), torch.zeros(3, dtype=_I32),
      torch.zeros(3, device="meta"), torch.zeros(3, dtype=_I32), 2),
     ValueError, "weights on meta"),
])
def test_gather_scale_sum_refuses_bad_arguments(args, err, match):
    """The fused op checks its arguments as the segment sum does, before
    any path: shapes, dtypes, the segment count, one device, and rows of
    x to gather from."""
    before = segment_sum.launches, segment_sum.gather_launches
    with pytest.raises(err, match=match):
        gather_scale_sum(*args)
    assert (segment_sum.launches, segment_sum.gather_launches) == before


def test_gather_scale_sum_on_the_cpu_is_differentiable_and_launches_none():
    """On the CPU the op is its plain version, which autograd
    differentiates (only the card's kernel has no backward); no count
    moves."""
    x = torch.randn(5, 3, requires_grad=True)
    w = torch.randn(6, requires_grad=True)
    src = torch.tensor([0, 4, -1, 9, 4, 2])
    dst = torch.tensor([1, 1, 0, 3, -1, 7])
    before = segment_sum.launches, segment_sum.gather_launches
    gx, gw = torch.autograd.grad(gather_scale_sum(x, src, w, dst, 4).sum(),
                                 (x, w))
    assert (segment_sum.launches, segment_sum.gather_launches) == before
    # x's rows 4 (src 4, and 9 clamped) and 0 reach a kept dst
    assert torch.equal(gx.sum(1) != 0, torch.tensor([True, False, False,
                                                     False, True]))
    assert torch.equal(gw != 0, torch.tensor([True, True, False, True,
                                              False, False]))
