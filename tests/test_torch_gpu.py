"""The port on a CUDA device: each kernel against its plain version, and
the call sites going through the kernels.  Every test here carries the
``gpu`` marker and skips where there is no card; run them on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_gpu.py`` (the first test of each kernel builds it with
nvcc).  Integer results: tolerance ZERO (``torch.equal``); the segment
sum: f32 rtol 1e-5 / atol 1e-4, bf16 inputs 2e-2 / 2e-1 (atomics add in
no fixed order; the rows design on sorted ids is held bit for bit to
itself and to the CPU plain version; its backward, a gather, bit for
bit); flash attention: f32 2e-4, bf16 2e-2 (rtol and atol, the JAX
package's own kernel tolerances); the GNN gather's gradient (K2's sum
of the gradient rows): bit for bit on integer-valued inputs; a GCN
training step, and the first
step of PNA, MeshGraphNet and DimeNet: chip_smoke's ``TRAIN_LOSS_RTOL``
/ ``TRAIN_GRAD_TOL`` against the plain path (the other GNNs' gradients
against the float64 plain path, chip_smoke's ``exact_close``)."""

from _torch_env import load_chip_smoke  # first: one torch thread

import numpy as np
import pytest
import torch

from repro_torch.core.paragrapher import open_graph, save_graph
from repro_torch.data import assemble_csr, stream_partitions
from repro_torch.graph import rmat
from repro_torch.kernels.compbin_decode import (compbin_decode,
                                                compbin_decode_ref)
from repro_torch.kernels.flash_attention import (attention_bshd,
                                                 attention_ref,
                                                 flash_attention, plan)
from repro_torch.kernels.segment_sum import (segment_sum,
                                             segment_sum_backward,
                                             segment_sum_grad_ref,
                                             segment_sum_ref)
from repro_torch.kernels.segment_sum import plan as k2_plan
from repro_torch.kernels.segment_sum.ops import (
    _segment_sum_backward_vec, _segment_sum_design, grad_vector_width)
from repro_torch.query import NeighborQueryEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 40000])
def test_kernel_equals_plain_version(cuda, b, n):
    rng = np.random.default_rng(b * 1000 + n)
    packed = torch.from_numpy(
        rng.integers(0, 256, n * b, dtype=np.uint8)).to(cuda)
    before = compbin_decode.launches
    out = compbin_decode(packed, b)
    torch.cuda.synchronize()
    assert compbin_decode.launches == before + 1
    assert torch.equal(out, compbin_decode_ref(packed, b))
    # a base pointer off the 4-byte grid takes the byte-wise path
    view = torch.cat([packed[:1], packed])[1:]
    assert view.data_ptr() % 4 == 1
    assert torch.equal(compbin_decode(view, b), compbin_decode_ref(view, b))


def test_load_and_serve_go_through_the_kernel(cuda, tmp_path):
    csr = rmat(12, 8, seed=1)
    path = str(tmp_path / "g.cbin")
    save_graph(path, csr)
    before = compbin_decode.launches
    with open_graph(path, use_pgfuse=True) as g:
        with stream_partitions(g) as stream:       # device=None -> the GPU
            shards = list(stream)
        assert all(s.neighbors.is_cuda for s in shards)
        assert compbin_decode.launches == before + len(shards)
        assert assemble_csr(shards) == csr
        assert stream.stats.host_decode_bytes == 0
        with NeighborQueryEngine(g, decode="device") as eng:
            vs = np.arange(0, csr.n_vertices, 3)
            for v, got in zip(vs, eng.neighbors_batch(vs)):
                np.testing.assert_array_equal(got, csr.neighbors_of(v))
            assert eng.stats.device_batches == 1
        assert compbin_decode.launches == before + len(shards) + 1


@pytest.mark.parametrize("E,D,N", [(64, 16, 4), (513, 200, 7),
                                   (2048, 128, 1024), (100, 1, 100),
                                   (1, 8, 1), (30720, 1433, 31744)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_equals_plain_version(cuda, E, D, N, dtype):
    rng = np.random.default_rng(E + D + N)
    msgs = torch.from_numpy(
        rng.standard_normal((E, D)).astype(np.float32)).to(cuda, dtype)
    ids = torch.from_numpy(rng.integers(-1, N + 2, E).astype(np.int32)
                           ).to(cuda)
    before = segment_sum.launches
    out = segment_sum(msgs, ids, N)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (N, D)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, segment_sum_ref(msgs, ids, N),
                               rtol=tol, atol=tol * 10)
    assert not segment_sum(msgs[:0], ids[:0], N).any()
    # a tensor that requires grad goes through the forward kernel and the
    # backward kernel, which equals the plain version's gradient
    m = msgs.detach().float().requires_grad_()
    before = segment_sum.launches, segment_sum.grad_launches
    segment_sum(m, ids, N).sum().backward()
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_sum.grad_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(m.grad, segment_sum_grad_ref(
        torch.ones(N, D, device=cuda), ids, N))


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, for its K2 id layouts."""
    return load_chip_smoke()


K2_LAYOUTS = ["served", "sorted", "permuted", "all_invalid", "one_segment",
              "ids_ge_n", "many_segments", "no_edges", "wide"]


@pytest.mark.parametrize("kind", K2_LAYOUTS)
@pytest.mark.parametrize("design", ["atomic", "rows", "public"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_designs_on_every_layout(cuda, smoke, kind, design,
                                             dtype):
    """Each design forced through the private entry, and the public path
    (the design ``plan`` picks), against the plain version on the card,
    on ``chip_smoke.k2_layout``'s layouts: f32 rtol 1e-5 / atol 1e-4,
    bf16 inputs 2e-2 / 2e-1, bit for bit on the exact layout; one count
    of ``segment_sum.launches`` per call with work; int64 ids of 2^31 and
    more dropped, never wrapped."""
    assert tuple(K2_LAYOUTS) == smoke.K2_LAYOUTS
    rng = np.random.default_rng(K2_LAYOUTS.index(kind))
    ids_np, n, d, exact = smoke.k2_layout(kind, rng)
    a = (rng.integers(-8, 9, (ids_np.size, d)) if exact
         else rng.standard_normal((ids_np.size, d))).astype(np.float32)
    msgs = torch.from_numpy(a).to(cuda, dtype)
    ids = torch.from_numpy(ids_np).to(cuda)
    before = segment_sum.launches
    if design == "public":
        design = k2_plan(ids.numel(), d, n)
        out = segment_sum(msgs, ids, n)
    else:
        out = _segment_sum_design(msgs, ids, n, design)
    torch.cuda.synchronize()
    work = n * d if design == "rows" else ids.numel() * d * n
    assert segment_sum.launches == before + int(work > 0)
    want = segment_sum_ref(msgs, ids, n)
    assert out.dtype == torch.float32 and out.shape == (n, d)
    if exact:
        assert torch.equal(out, want)
    else:
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out, want, rtol=tol, atol=tol * 10)
    if kind == "wide":         # the same sums as with the wide ids at -1
        minus = torch.where((ids >= 0) & (ids < n), ids, -1).int()
        torch.testing.assert_close(
            out, _segment_sum_design(msgs, minus, n, design),
            rtol=1e-5, atol=1e-4)


def test_segment_sum_rows_is_deterministic_and_equals_the_cpu(cuda, smoke):
    ids_np, n = smoke.served_tree_ids(1024, seed=3)
    msgs = torch.randn(ids_np.size, 1433, device=cuda)
    ids = torch.from_numpy(ids_np).to(cuda)
    first = _segment_sum_design(msgs, ids, n, "rows")
    second = _segment_sum_design(msgs, ids, n, "rows")
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), segment_sum_ref(msgs.cpu(), ids.cpu(), n))


@pytest.mark.parametrize("design", ["atomic", "rows"])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_sum_makes_no_host_sync(cuda, smoke, design, ids_dtype):
    ids_np, n = smoke.served_tree_ids(64, seed=4)
    msgs = torch.randn(ids_np.size, 600, device=cuda)
    ids = torch.from_numpy(ids_np).to(cuda, ids_dtype)
    _segment_sum_design(msgs, ids, n, design)          # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _segment_sum_design(msgs, ids, n, design)
        if design == k2_plan(ids.numel(), 600, n):
            segment_sum(msgs, ids, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(out, segment_sum_ref(msgs, ids, n),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", K2_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vec", [4, 2, 1])
def test_segment_sum_backward_on_every_layout(cuda, smoke, kind, dtype, vec):
    """K2's backward bit for bit against its plain version on
    ``chip_smoke.k2_layout``'s layouts (int64 wide ids dropped, never
    wrapped): the kernel entry, the kernel forced to ``vec`` floats a
    vector (refused with an error where D or the pointers do not allow
    it), autograd through ``segment_sum`` (the grad in the messages'
    dtype) and an expanded ``grad_out``; one count of
    ``segment_sum.grad_launches`` per call with work."""
    rng = np.random.default_rng(100 + K2_LAYOUTS.index(kind))
    ids_np, n, d, _ = smoke.k2_layout(kind, rng)
    ids = torch.from_numpy(ids_np).to(cuda)
    forced = int(ids.numel() * d > 0 or d % vec == 0)
    assert smoke.check_k2_backward(ids, n, d, dtype, rng, kind,
                                   vecs=(vec,)) == \
        (3 if n and d else 2) + forced
    torch.cuda.synchronize()


@pytest.mark.parametrize("d", [1, 2, 3, 5, 16, 67, 1433])
@pytest.mark.parametrize("offset", [False, True])
def test_segment_sum_backward_at_every_width(cuda, smoke, d, offset):
    """The backward at widths that take each vector width and none, with
    ``grad_out`` on the allocator's grid and one float off it (4-byte
    vectors only): every width bit for bit where allowed, refused
    where not."""
    rng = np.random.default_rng(d)
    ids = torch.from_numpy(rng.integers(-1, 203, 2000).astype(
        np.int32)).to(cuda)
    widest = 1 if offset else 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    assert smoke.check_k2_backward(ids, 200, d, torch.float32, rng,
                                   f"D={d}", offset=offset) == 3 + 3
    got = segment_sum_backward(torch.zeros(200, d, device=cuda), ids, 200)
    view = torch.zeros(200 * d + 1, device=cuda)[1:].view(200, d)
    assert grad_vector_width(d, view if offset else got, got) == widest
    torch.cuda.synchronize()


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_sum_backward_makes_no_host_sync(cuda, smoke, ids_dtype):
    """At GCN's hidden width (16 floats: 16-byte vectors, VEC 4) the
    backward, forced and picked, and autograd through it run without a
    host sync."""
    ids_np, n = smoke.served_tree_ids(64, seed=6)
    ids = torch.from_numpy(ids_np).to(cuda, ids_dtype)
    msgs = torch.randn(ids_np.size, 16, device=cuda, requires_grad=True)
    grad_out = torch.randn(n, 16, device=cuda)
    first = segment_sum_backward(grad_out, ids, n)        # build and load
    assert grad_vector_width(16, grad_out, first) == 4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = segment_sum_backward(grad_out, ids, n)
        forced = _segment_sum_backward_vec(grad_out, ids, n, 4)
        segment_sum(msgs, ids, n).backward(grad_out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = segment_sum_grad_ref(grad_out, ids, n)
    assert torch.equal(got, want) and torch.equal(msgs.grad, want)
    assert torch.equal(forced, want)


def test_segment_sum_backward_refuses_a_width_it_cannot_take(cuda):
    """A width that D or the pointers do not allow raises at the launch
    and never falls back to a narrower one."""
    ids = torch.tensor([0, 1, -1, 2], dtype=torch.int32, device=cuda)
    before = segment_sum.grad_launches
    with pytest.raises(RuntimeError, match="VEC=4"):
        _segment_sum_backward_vec(torch.randn(3, 6, device=cuda), ids, 3, 4)
    view = torch.randn(3 * 16 + 1, device=cuda)[1:].view(3, 16)
    with pytest.raises(RuntimeError, match="VEC=2"):
        _segment_sum_backward_vec(view, ids, 3, 2)
    assert segment_sum.grad_launches == before
    assert torch.equal(_segment_sum_backward_vec(view, ids, 3, 1),
                       segment_sum_grad_ref(view, ids, 3))


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_sum_gradient_agrees_with_the_plain_autograd(cuda, smoke,
                                                             ids_dtype):
    """gradcheck-style: the gradient of a random linear functional of the
    kernel's sum equals autograd of the plain version bit for bit, and
    satisfies the adjoint identity <S m, g> = <m, S^T g> in float64."""
    ids_np, n = smoke.served_tree_ids(128, seed=8)
    ids = torch.from_numpy(ids_np).to(cuda, ids_dtype)
    m = torch.randn(ids_np.size, 24, device=cuda, dtype=torch.float64)
    w = torch.randn(n, 24, device=cuda)
    mk = m.float().requires_grad_()
    mp = m.float().requires_grad_()
    (segment_sum(mk, ids, n) * w).sum().backward()
    (segment_sum_ref(mp, ids, n) * w).sum().backward()
    assert torch.equal(mk.grad, mp.grad)
    lhs = (segment_sum_ref(m, ids, n).double() * w.double()).sum()
    rhs = (m * segment_sum_backward(w, ids, n).double()).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=1e-5)


def test_gcn_full_graph_step_on_the_card(cuda, smoke, tmp_path):
    """One --full-graph training step (2 simulated hosts, gcn-cora
    reduced): K2's forward and backward launch as the step's requests
    ask (``chip_smoke.k2_as_asked``: the sums, the gather's backward,
    the backward of the sums that need a gradient); the loss and every
    gradient within chip_smoke's training tolerance of the plain path
    on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as tr
    from repro_torch.models.gnn import gcn

    cfg = get_arch("gcn-cora").make_reduced()
    fb = tr._gnn_full_graph_batches("gcn-cora", cfg, str(tmp_path), True, 2,
                                    device=cuda)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)

    def loss_grads():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = gcn.loss_fn(p, fb.batch, cfg)
        return float(loss.detach()), dict(zip(p, torch.autograd.grad(
            loss, list(p.values()))))

    with smoke.k2_as_asked("gcn-cora step") as asked:
        loss_k, grads_k = loss_grads()
    assert min(vars(asked).values()) > 0, asked
    with smoke.plain_segment_sum():
        loss_p, grads_p = loss_grads()
    assert abs(loss_k - loss_p) <= smoke.TRAIN_LOSS_RTOL * abs(loss_p)
    for k in grads_p:
        smoke.train_close(grads_k[k], grads_p[k], k)


def _gather_grad(x, ids, w, through_cat=False):
    """The output and the gradient of ``sum(gather(x, ids) * w)`` through
    the public ``gather``, with ``through_cat`` of ``cat([gather(x, ids),
    gather(x, flipped ids)])``, whose halves hand the backward strided
    rows, as PNA's message input does."""
    from repro_torch.models.gnn.layers import gather

    x = x.detach().requires_grad_()
    out = gather(x, ids)
    if through_cat:
        out = torch.cat([out, gather(x, ids.flip(0))], dim=-1)
    (g,) = torch.autograd.grad((out * w).sum(), x)
    return out.detach(), g


def _check_gather_grad(cuda, ids_np, n, d, rng, through_cat=False):
    """The gather's output and gradient on the card against the CPU's
    plain path, bit for bit on integer-valued rows and weights; K2
    launched once for a backward with work, counted on
    ``gather.grad_launches`` and ``segment_sum.launches`` alike."""
    from repro_torch.models.gnn.layers import gather

    x = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-8, 9, (ids_np.size, d * (
        1 + through_cat))).astype(np.float32))
    ids = torch.from_numpy(ids_np)
    before = gather.grad_launches, segment_sum.launches
    out, g = _gather_grad(x.to(cuda), ids.to(cuda), w.to(cuda), through_cat)
    torch.cuda.synchronize()
    launches = int(ids_np.size * d > 0) * (1 + through_cat)
    assert (gather.grad_launches - before[0],
            segment_sum.launches - before[1]) == (launches, launches)
    want_out, want_g = _gather_grad(x, ids, w, through_cat)
    assert gather.grad_launches - before[0] == launches   # none on the CPU
    assert torch.equal(out.cpu(), want_out)
    assert g.dtype == torch.float32 and torch.equal(g.cpu(), want_g)


@pytest.mark.parametrize("kind", K2_LAYOUTS)
def test_gather_gradient_on_every_layout(cuda, smoke, kind):
    """The gather's gradient on the card (K2's sum of the gradient rows)
    equals the CPU's plain gradient bit for bit on ``chip_smoke.k2_layout``'s
    layouts: -1 and other negative ids send nothing, ids at or above N
    (int64 ids of 2^31 and more among them) send their rows to row N - 1;
    E = 0 launches nothing."""
    rng = np.random.default_rng(300 + K2_LAYOUTS.index(kind))
    ids_np, n, d, _ = smoke.k2_layout(kind, rng)
    _check_gather_grad(cuda, ids_np, n, d, rng)


@pytest.mark.parametrize("through_cat", [False, True])
@pytest.mark.parametrize("d", [1, 8, 16, 75, 128])
def test_gather_gradient_at_the_models_widths(cuda, d, through_cat):
    """At the GNNs' widths (DimeNet's 8, GCN's 16, PNA's 75,
    MeshGraphNet's 128) on hub ids (a third of 60,000 on five rows, with
    -1 padding and ids at or above N), also through a ``torch.cat``:
    bit for bit against the CPU's plain gradient."""
    rng = np.random.default_rng(d)
    n = 3000
    ids = rng.integers(-1, n + 4, 60000)
    hubs = rng.random(ids.size) < 1 / 3
    ids[hubs] = rng.integers(0, 5, int(hubs.sum()))
    _check_gather_grad(cuda, ids.astype(np.int32), n, d, rng, through_cat)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_gather_backward_makes_no_host_sync(cuda, ids_dtype):
    """The gather's backward at PNA's width runs without a host sync."""
    from repro_torch.models.gnn.layers import gather

    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(-1, 1030, 20000)).to(cuda,
                                                               ids_dtype)
    x = torch.randn(1024, 75, device=cuda, requires_grad=True)
    w = torch.randn(ids.numel(), 75, device=cuda)
    (first,) = torch.autograd.grad(gather(x, ids), x, w)   # build and load
    out = gather(x, ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (g,) = torch.autograd.grad(out, x, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(g, first, rtol=1e-5, atol=1e-4)


def test_gather_engages_its_function_only_in_a_training_step(cuda):
    """On the card the gather's autograd function engages for a tensor
    that requires grad under grad mode, and the plain gather serves a
    tensor that needs no gradient and any call under ``no_grad``."""
    from repro_torch.models.gnn.layers import gather

    ids = torch.tensor([0, 3, -1, 7, 3], device=cuda)
    x = torch.randn(5, 4, device=cuda)
    xg = x.clone().requires_grad_()
    with torch.no_grad():
        assert gather(xg, ids).grad_fn is None
    assert gather(x, ids).grad_fn is None
    out = gather(xg, ids)
    assert type(out.grad_fn).__name__ == "_GatherBackward"
    assert torch.equal(out.detach(), gather(x, ids))


@pytest.mark.parametrize("arch", ["gcn-cora", "pna"])
def test_full_graph_step_sums_the_gathers_gradient_on_k2(cuda, smoke, arch):
    """One full-graph loss and its gradients at the configs' full widths
    (rmat(9, 8)): each gather of a tensor that needs a gradient (GCN's
    layer 1, PNA's two a layer) sums its gradient on K2, one
    ``gather.grad_launches`` a gather the counter saw, and K2 launches
    as the step's requests ask; then the loss within chip_smoke's
    training tolerance of the plain path."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.data_gnn import full_graph_batch
    from repro_torch.launch.steps import _GNN_MODULES
    from repro_torch.models.gnn.layers import gather

    cfg = get_arch(arch).make_config()
    mod = _GNN_MODULES[arch]
    batch = full_graph_batch(arch, cfg, rmat(9, 8, seed=2),
                             np.random.default_rng(0), n_classes=4,
                             device=cuda)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    before = gather.grad_launches
    with smoke.k2_as_asked(arch) as asked:
        smoke.loss_and_grads(lambda p: mod.loss_fn(p, batch, cfg), params)
    assert gather.grad_launches - before == asked.grad_gathers > 0
    smoke.first_step_pair(lambda p: mod.loss_fn(p, batch, cfg), params)


def _fused_inputs(cuda, d, offset, ids_dtype, seed):
    """x f32[NX, d] (a view ``offset`` floats past an aligned base), w
    f32[E] and unsorted hub ids: a third of the edges on five rows of x
    and five segments, -1 and other negative ids, ids at or above NX and
    N (int64 ones of 2^32 among them)."""
    rng = np.random.default_rng(seed)
    nx, n, e = 3000, 2900, 40000
    src, dst = rng.integers(-2, nx + 4, e), rng.integers(-2, n + 4, e)
    hubs = rng.random(e) < 1 / 3
    src[hubs], dst[hubs] = (rng.integers(0, 5, int(hubs.sum())),
                            rng.integers(0, 5, int(hubs.sum())))
    if ids_dtype == torch.int64:
        src[7::1000], dst[11::1000] = 2 ** 32, 2 ** 32 + 3
    base = torch.randn(nx * d + offset, device=cuda)
    x = base[offset:].view(nx, d)
    w = torch.from_numpy(rng.standard_normal(e).astype(np.float32)).to(cuda)
    return (x, torch.from_numpy(src).to(cuda, ids_dtype), w,
            torch.from_numpy(dst).to(cuda, ids_dtype), n)


def _assert_within_f32_rounding(got, x, src, w, dst, n):
    """``got`` against the fused forward's plain version in float64: each
    row within the f32 rounding of its products and of its adds in any
    order, ``k * 2^-23 * sum|terms|`` for a row of k terms; returns k."""
    from repro_torch.kernels.segment_sum import gather_scale_sum_ref

    want = gather_scale_sum_ref(x.double(), src, w.double(), dst, n)
    terms = gather_scale_sum_ref(x.double().abs(), src, w.double().abs(),
                                 dst, n)
    k = gather_scale_sum_ref(torch.ones(x.shape[0], 1, device=x.device,
                                        dtype=torch.float64), src,
                             torch.ones_like(w, dtype=torch.float64), dst, n)
    assert ((got.double() - want).abs() <= k * 2.0 ** -23 * terms).all()
    return k


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("d", [1, 16, 75, 100, 1433])
def test_fused_kernel_equals_the_plain_version_in_float64(cuda, d, offset,
                                                          ids_dtype):
    """K2's fused forward (``k2_gather_atomic``) against its plain version
    in float64 on unsorted hub ids with padding and ids at or above NX
    and N: each row within the f32 rounding of its products and of its
    adds in any order, ``k * 2^-23 * sum|terms|`` for a row of k terms;
    at every vector width (D 16 and 100 aligned take 4, two floats off
    2, one float off and odd widths 1)."""
    from repro_torch.kernels.segment_sum import gather_scale_sum

    x, src, w, dst, n = _fused_inputs(cuda, d, offset, ids_dtype, d + offset)
    out = torch.zeros(n, d, device=cuda)
    want_vec = 4 if d % 4 == 0 and offset == 0 else \
        2 if d % 2 == 0 and offset % 2 == 0 else 1
    assert grad_vector_width(d, x, out) == want_vec
    before = segment_sum.launches, segment_sum.gather_launches
    got = gather_scale_sum(x, src, w, dst, n)
    torch.cuda.synchronize()
    assert (segment_sum.launches - before[0],
            segment_sum.gather_launches - before[1]) == (1, 1)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    k = _assert_within_f32_rounding(got, x, src, w, dst, n)
    assert (k[:5] > 1000).all()             # the hubs drew their edges


def test_fused_kernel_counts_calls_with_work_only(cuda):
    """``segment_sum.gather_launches`` and ``segment_sum.launches`` each
    rise by one a call with work and by none for E, D or N of 0; the
    seam's unfused path (x needs a gradient) adds nothing to the fused
    count; a float64 input, an x that needs a gradient and an x of no
    rows under edges are refused before any launch."""
    from repro_torch.kernels.segment_sum import gather_scale_sum
    from repro_torch.models.gnn.layers import weighted_scatter_sum

    x, src, w, dst, n = _fused_inputs(cuda, 16, 0, torch.int32, 1)
    for args, work in (((x, src, w, dst, n), 1),
                       ((x, src[:0], w[:0], dst[:0], n), 0),
                       ((x[:, :0], src, w, dst, n), 0),
                       ((x, src, w, dst, 0), 0)):
        before = segment_sum.launches, segment_sum.gather_launches
        out = gather_scale_sum(*args)
        torch.cuda.synchronize()
        assert (segment_sum.launches - before[0],
                segment_sum.gather_launches - before[1]) == (work, work)
        assert out.shape == (args[4], args[0].shape[1])
        if not work:
            assert not out.any()
    before = segment_sum.launches, segment_sum.gather_launches
    xg = x.clone().requires_grad_()
    weighted_scatter_sum(xg, src, w, dst, n).sum().backward()
    assert segment_sum.gather_launches == before[1]
    assert segment_sum.launches - before[0] == 2     # the sum, the gather's
    for bad, err in (((x.double(), src, w.double(), dst, n), TypeError),
                     ((xg, src, w, dst, n), ValueError),
                     ((x[:0], src, w, dst, n), ValueError)):
        with pytest.raises(err):
            gather_scale_sum(*bad)
    assert segment_sum.gather_launches == before[1]


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_fused_kernel_makes_no_host_sync(cuda, ids_dtype):
    """The fused forward at the GCN cell's width runs without a host
    sync."""
    from repro_torch.kernels.segment_sum import gather_scale_sum

    x, src, w, dst, n = _fused_inputs(cuda, 100, 0, ids_dtype, 2)
    gather_scale_sum(x, src, w, dst, n)                  # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gather_scale_sum(x, src, w, dst, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_within_f32_rounding(got, x, src, w, dst, n)


def test_gcn_step_takes_the_fused_kernel_at_layer_0(cuda, smoke):
    """One full-graph GCN loss and its gradients at the cell's feature
    width (D 100, rmat(9, 8)): layer 0 (features that need no gradient)
    launches ``k2_gather_atomic`` once, layer 1 keeps its K2 sum, its
    gather's backward on K2 and its ``k2_grad``; K2 launches as the
    requests ask, and the loss within chip_smoke's training tolerance of
    the plain path."""
    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.launch.data_gnn import full_graph_batch
    from repro_torch.models.gnn import gcn
    from repro_torch.models.gnn.layers import gather

    cfg = make_config(d_in=100, n_classes=4)
    batch = full_graph_batch("gcn-cora", cfg, rmat(9, 8, seed=2),
                             np.random.default_rng(0), n_classes=4,
                             device=cuda)
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    before = (segment_sum.launches, segment_sum.gather_launches,
              segment_sum.grad_launches, gather.grad_launches)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with smoke.k2_as_asked("gcn-cora D 100") as asked:
            smoke.loss_and_grads(lambda p: gcn.loss_fn(p, batch, cfg),
                                 params)
        torch.cuda.synchronize()
    # the degree, layer 0 fused, layer 1's sum, its gather's backward
    assert (segment_sum.launches - before[0],
            segment_sum.gather_launches - before[1],
            segment_sum.grad_launches - before[2],
            gather.grad_launches - before[3]) == (4, 1, 1, 1)
    assert asked == smoke.KernelRequests(sums=3, grad_sums=1,
                                         grad_gathers=1)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("k2_gather_atomic" in x for x in names) == 1
    assert sum("k2_grad" in x for x in names) == 1
    smoke.first_step_pair(lambda p: gcn.loss_fn(p, batch, cfg), params)


def test_gcn_serving_goes_through_both_kernels(cuda, smoke, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_gnn_server

    cfg = get_arch("gcn-cora").make_reduced()
    k1 = compbin_decode.launches
    with smoke.k2_as_asked("gcn-cora served") as asked:
        answer, engine, close = make_gnn_server(
            "gcn-cora", cfg, str(tmp_path), fanouts=(5, 5), decode="device")
        try:
            logits = answer(np.arange(64))
        finally:
            close()
    assert logits.shape == (64, cfg.n_classes) and np.isfinite(logits).all()
    assert compbin_decode.launches - k1 == engine.stats.device_batches > 0
    assert asked.sums > 0


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,Dh,causal", [
    (2, 4, 2, 256, 256, 64, True), (1, 8, 8, 128, 128, 128, True),
    (1, 4, 1, 1, 384, 64, True), (2, 6, 3, 100, 100, 64, True),
    (1, 2, 2, 64, 256, 64, True), (1, 2, 2, 128, 128, 64, False),
    (1, 15, 5, 64, 64, 64, True), (2, 12, 2, 300, 300, 128, True),
    (1, 4, 2, 40, 16, 64, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_equals_plain_version(cuda, B, Hq, Hkv, Sq,
                                                     Skv, Dh, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + Skv)

    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, dtype)
    q, k, v = t(B, Hq, Sq, Dh, scale=0.3), t(B, Hkv, Skv, Dh, scale=0.3), \
        t(B, Hkv, Skv, Dh)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), attention_ref(q, k, v,
                                                          causal=causal),
                               rtol=tol, atol=tol)
    if Sq > Skv:
        assert not out[:, :, :Sq - Skv].any()


def test_flash_attention_on_a_strided_cache_view(cuda):
    g = torch.Generator(device="cuda").manual_seed(0)
    cache = torch.randn(2, 2, 96, 5, 64, generator=g, device=cuda
                        ).to(torch.bfloat16)
    q = torch.randn(2, 3, 15, 64, generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v = cache[0, :, :71], cache[1, :, :71]
    out = attention_bshd(q, k, v, offset=68, kv_len=71)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=68, kv_len=71)
    torch.testing.assert_close(out.float(), want.transpose(1, 2),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(RuntimeError, match="no backward"):
        attention_bshd(q.float().requires_grad_(), k.float(), v.float())
    with pytest.raises(ValueError, match="Dh"):
        flash_attention(*(torch.zeros(1, 2, 4, 32, device=cuda),) * 3)


def _bf16(rng, *shape, scale=1.0, device="cuda"):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device, torch.bfloat16)


@pytest.mark.parametrize("Sq", [63, 64, 65, 100, 128, 129, 300, 1024])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_prefill_across_its_tile_edges(cuda, Sq, Dh, causal):
    """bf16 prefill on the tensor cores: row counts either side of the
    64-row warpgroup and 128-row block, key counts off the 64-key tile."""
    rng = np.random.default_rng(Sq * Dh + causal)
    q = _bf16(rng, 1, 2, Sq, Dh, scale=0.3)
    k, v = _bf16(rng, 1, 2, Sq, Dh, scale=0.3), _bf16(rng, 1, 2, Sq, Dh)
    assert plan(torch.bfloat16, Sq, Sq, Dh, 2)[0] == "tc_prefill"
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), attention_ref(q, k, v,
                                                          causal=causal),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("Dh", [64, 128])
def test_tc_prefill_on_views_with_unseeing_rows(cuda, Dh):
    """q, k and v as [B, S, H, Dh] slices of one fused projection (GQA,
    3 query heads per KV head), Sq > Skv: the first rows see no key and
    must be exactly 0."""
    rng = np.random.default_rng(Dh)
    B, S, Hq, Hkv, skv = 2, 150, 6, 2, 100
    qkv = _bf16(rng, B, S, (Hq + 2 * Hkv) * Dh, scale=0.3)
    q = qkv[..., :Hq * Dh].view(B, S, Hq, Dh)
    k = qkv[:, :skv, Hq * Dh:(Hq + Hkv) * Dh].view(B, skv, Hkv, Dh)
    v = qkv[:, :skv, (Hq + Hkv) * Dh:].view(B, skv, Hkv, Dh) * 3
    assert not q.is_contiguous() and not k.is_contiguous()
    out = attention_bshd(q, k, v)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
    assert not out[:, :S - skv].any()


@pytest.mark.parametrize("kv_len", [1, 5, 64, 65, 1087, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_on_a_strided_cache_view(cuda, kv_len, dtype):
    rng = np.random.default_rng(kv_len)
    cache = torch.from_numpy(rng.standard_normal(
        (2, 2, kv_len + 9, 2, 64)).astype(np.float32)).to(cuda, dtype)
    k, v = cache[0, :, :kv_len], cache[1, :, :kv_len]
    q = torch.from_numpy(rng.standard_normal((2, 1, 6, 64)).astype(
        np.float32) * 0.3).to(cuda, dtype)
    assert not k.is_contiguous()
    design, nsplit = plan(dtype, 3, kv_len, 64, 4)
    assert design == "split_decode" and (nsplit > 1) == (kv_len >= 128)
    before = flash_attention.launches
    out = attention_bshd(q, k, v, offset=kv_len - 1, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=kv_len - 1,
                         kv_len=kv_len).transpose(1, 2)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_ranges_that_see_no_key(cuda, dtype):
    """A 5-token chunk at offset 40 of a 1000-key cache: the keys are
    split by kv_len, so every range past key 44 sees nothing; with
    offset -10 no row sees anything and the output is 0."""
    rng = np.random.default_rng(7)

    def t(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(cuda, dtype)
    q, k, v = t(1, 5, 6, 64, scale=0.3), t(1, 1000, 2, 64, scale=0.3), \
        t(1, 1000, 2, 64)
    assert plan(dtype, 15, 1000, 64, 2)[1] > 1
    out = attention_bshd(q, k, v, offset=40, kv_len=1000)
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), offset=40,
                         kv_len=1000).transpose(1, 2)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
    none = attention_bshd(q, k, v, offset=-10, kv_len=1000)
    torch.cuda.synchronize()
    assert torch.isfinite(none).all() and not none.any()


def test_lm_serving_goes_through_the_kernel(cuda):
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch("smollm-360m").make_config(),
                              n_layers=2, dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    before = flash_attention.launches
    tokens, t = serve_lm(cfg, batch=2, prompt_len=40, n_tokens=4,
                         params=params, keep_logits=True)
    assert flash_attention.launches - before == 2 * 4
    saved = tf.attention
    tf.attention = tf.attention_plain
    try:
        want_tokens, want = serve_lm(cfg, batch=2, prompt_len=40,
                                     n_tokens=4, params=params,
                                     keep_logits=True)
    finally:
        tf.attention = saved
    np.testing.assert_allclose(t["logits"], want["logits"], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(tokens, want_tokens)


@pytest.fixture(scope="module")
def serving_graph(smoke, tmp_path_factory):
    csr, path, _, _ = smoke.make_graph(
        13, str(tmp_path_factory.mktemp("serving")))
    return csr, path


def test_hotset_tier_lives_on_the_card(cuda, smoke, serving_graph):
    """``chip_smoke.phase_hotset`` at scale 13 (every answer of the cold
    and hot arms equal to the CSR as int64; K1's launches equal the device
    batches), then a tier built from a byte budget with ``device=None``:
    its runs are int32 tensors on the card, re-widened on every hit."""
    csr, path = serving_graph
    out = smoke.phase_hotset(csr, path, cuda, n_batches=6, batch=1024)
    assert out["hot"]["hotset"]["hits"] > 0
    assert out["cold"]["launches"] > 0 and out["hot"]["card_bytes"] > 0
    hubs = np.argsort(np.diff(csr.offsets))[::-1][:64].astype(np.int64)
    with open_graph(path, use_pgfuse=True) as g, \
            NeighborQueryEngine(g, decode="auto", hotset=1 << 22) as eng:
        for _ in range(2):
            for v, got in zip(hubs, eng.neighbors_batch(hubs)):
                assert got.dtype == np.int64
                np.testing.assert_array_equal(got, csr.neighbors_of(int(v)))
        assert eng.hotset.stats.hits >= len(hubs)
        entry = eng.hotset._entries[int(hubs[0])]
        assert entry.store.is_cuda and entry.store.dtype == torch.int32


@pytest.mark.parametrize("arm", ["one_engine", "sharded"])
def test_traversal_threads_and_replicas_count_every_launch(
        cuda, smoke, serving_graph, arm):
    """``chip_smoke.phase_traversal`` at scale 13: executor threads (and,
    sharded, four replica engines on the one card) launch K1 concurrently;
    every answer equals the plain numpy traversal and K1's launch delta
    equals the engines' merged device batches."""
    csr, path = serving_graph
    kw = dict(shards=2, replication=2, hotset_bytes=1 << 20) \
        if arm == "sharded" else {}
    out = smoke.phase_traversal(csr, path, cuda,
                                sequential={"khop": 3, "bfs": 3, "path": 3},
                                n_concurrent=24, batch=32, **kw)
    assert out["launches"] == out["device_batches"] > 0
    assert out["executor_threads"] > 1


# ---------------------------------------------------------------------------
# the other GNNs (PNA, MeshGraphNet, DimeNet): every segment sum on K2,
# every gradient of one on its backward; held to the CPU path, which
# tests/test_torch_gnn_{layers,models}.py hold to the JAX package
# ---------------------------------------------------------------------------

def _agg_case(kind: str, seed: int = 3):
    rng = np.random.default_rng(seed)
    n, e, d = 12, 80, 5
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    if kind == "padding":
        ids[rng.random(e) < 0.3] = -1
    elif kind == "ids_at_or_above_n":
        ids[::4] = n + rng.integers(0, 3, ids[::4].size)
    elif kind == "planted_ties":
        ids = np.repeat(np.arange(n), e // n + 1)[:e].astype(np.int32)
        msgs[ids == 3] = msgs.max() + 1.0
    elif kind == "relu_zeros":
        msgs = np.maximum(msgs, 0)
        msgs[ids == 2] = 0
    return msgs, ids, n


def _agg(name, msgs, ids, n, w, device, dtype=torch.float32):
    from repro_torch.models.gnn import layers
    m = torch.from_numpy(msgs).to(device, dtype).requires_grad_()
    out = getattr(layers, name)(m, torch.from_numpy(ids).to(device), n)
    (g,) = torch.autograd.grad(
        (out * torch.from_numpy(w).to(device, dtype)).sum(), m)
    return out.detach().cpu().double(), g.cpu().double()


@pytest.mark.parametrize("kind", ["padding", "ids_at_or_above_n",
                                  "planted_ties", "relu_zeros"])
@pytest.mark.parametrize("name", ["scatter_max", "scatter_min",
                                  "scatter_std"])
def test_pna_aggregators_on_the_card(cuda, smoke, monkeypatch, name, kind):
    """Max and min (``index_reduce``) equal the CPU path bit for bit,
    values and gradients, and ask nothing of K2; the std's two means
    launch K2 and its backward as their requests ask, and its gradients
    are held to the float64 CPU path as chip_smoke holds PNA's
    (:func:`exact_close`)."""
    from repro_torch.models.gnn import layers
    msgs, ids, n = _agg_case(kind)
    w = np.random.default_rng(4).standard_normal(
        (n, msgs.shape[1])).astype(np.float32)
    with smoke.k2_as_asked(name) as asked:
        out, g = _agg(name, msgs, ids, n, w, cuda)
    assert (asked.grad_sums > 0) == (name == "scatter_std"), asked
    cpu_out, cpu_g = _agg(name, msgs, ids, n, w, "cpu")
    if name != "scatter_std":
        assert torch.equal(out, cpu_out) and torch.equal(g, cpu_g)
        return
    torch.testing.assert_close(out, cpu_out, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(layers, "segment_sum", smoke.segment_sum_f64)
    _, exact = _agg(name, msgs, ids, n, w, "cpu", torch.float64)
    smoke.exact_close(g, exact, smoke.relative_distance({"g": cpu_g},
                                                        {"g": exact}),
                      "scatter_std grad")


@pytest.mark.parametrize("arch", ["pna", "meshgraphnet", "dimenet"])
def test_other_gnn_first_step_on_the_card(cuda, smoke, arch):
    """One loss and its gradients (reduced config, ``full_graph_batch``
    of rmat(9, 8)): K2's launches as its requests ask; the loss within
    chip_smoke's training tolerance of the plain path on the card, the
    gradients held to the float64 plain path as ``[gnn2]`` holds them
    (``exact_close``)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.data_gnn import full_graph_batch
    from repro_torch.launch.steps import _GNN_MODULES

    cfg = get_arch(arch).make_reduced()
    mod = _GNN_MODULES[arch]
    batch = full_graph_batch(arch, cfg, rmat(9, 8, seed=2),
                             np.random.default_rng(0), n_classes=4,
                             device=cuda)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    out = smoke.first_step_parity(
        lambda p: mod.loss_fn(p, batch, cfg), params,
        exact=smoke.exact_plain_grads(mod, cfg, batch, params))
    assert np.isfinite(out["loss"]) and out["launches"]["k2_grad"] > 0


def test_pna_serving_goes_through_k2(cuda, smoke, tmp_path):
    """PNA served on the card (reduced): K2 launches as the request's
    sums ask (none on the CPU), logits within 1e-5 of the same server
    on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import make_gnn_server
    from repro_torch.models.gnn import pna

    cfg = get_arch("pna").make_reduced()
    params = pna.init_params(cfg, torch.Generator().manual_seed(0))
    seeds = np.arange(0, 256, 7)
    logits = {}
    for dev in (cuda, "cpu"):
        answer, _, close = make_gnn_server(
            "pna", cfg, str(tmp_path), device=dev, params=params,
            decode="host")
        try:
            with smoke.k2_as_asked(f"pna served on {dev}") as asked:
                logits[str(dev)] = answer(seeds)
        finally:
            close()
        assert (asked.sums > 0) == (dev is cuda)
    np.testing.assert_allclose(logits[str(cuda)], logits["cpu"], rtol=1e-5,
                               atol=1e-5)


def test_gather_on_ids_past_n_does_not_assert_on_the_card(cuda):
    """``gather`` clamps ids at or above N on the card as on the CPU (an
    unclamped index was a device-side assert that poisons the context)."""
    from repro_torch.models.gnn.layers import gather

    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([0, -1, 3, 4, 7])
    got = gather(x.to(cuda), idx.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gather(x, idx))
    assert torch.equal(got.cpu()[[2, 3, 4]], x[[3, 3, 3]])
    assert not got[1].any()


def _small_moe(**kw):
    """A small MoE config the card's K3 takes (head dim 64): 2 layers, 6
    experts in 8 slots, top-2, shared experts with their gate."""
    from repro_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        name="moe-small", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=64, d_ff=0, vocab=512, qkv_bias=True, moe=True, n_experts=6,
        n_experts_padded=8, top_k=2, moe_d_ff=96, n_shared_experts=2,
        shared_d_ff=128, shared_expert_gate=True, dtype=torch.float32, **kw)


def test_moe_serving_goes_through_k3_and_k2(cuda, smoke):
    """``chip_smoke.moe_check`` on a small MoE: K3 on every attention
    call and K2 on every combine (one each a layer a step), routing held
    to the plain path's as integers, logits within 1e-3."""
    out = smoke.moe_check(cuda, _small_moe(), batch=2, prompt_len=40,
                          n_tokens=4)
    assert out["k3_launches"] == out["k2_launches"] == 2 * 4
    assert out["routing"]["flips"] == 0


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_moe_training_step_on_the_card(cuda, smoke, dispatch):
    """One loss and its gradients of the small MoE: K2 forward and its
    backward one a layer on the scatter arm (none on the gather arm);
    the loss within chip_smoke's training tolerance of the plain path,
    the gradients held to the float64 plain path."""
    import dataclasses

    from repro_torch.models import transformer as tf

    cfg = _small_moe(moe_dispatch=dispatch)
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 33), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    def loss_fn(p, c=cfg):
        return tf.loss_fn(p, toks[:, :-1], toks[:, 1:], c)

    def exact():
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        with smoke.plain_segment_sum(smoke.segment_sum_f64):
            return smoke.loss_and_grads(
                lambda p: loss_fn(p, c64),
                {k: (v.double() if not isinstance(v, dict) else
                     {kk: vv.double() for kk, vv in v.items()})
                 for k, v in params.items()})[1]

    out = smoke.first_step_parity(loss_fn, params, exact=exact)
    assert np.isfinite(out["loss"])
    k = out["launches"]
    assert (k["k2"] > 0 and k["k2_grad"] > 0) if dispatch == "scatter" \
        else k == {"k2": 0, "k2_grad": 0}


def _din_small(n_items: int = 1000):
    from repro_torch.configs import get_arch
    import dataclasses
    return dataclasses.replace(get_arch("din").make_reduced(),
                               n_items=n_items)


def test_din_forward_on_the_card_equals_the_cpu(cuda, smoke):
    """The reduced DIN's logits on the card within chip_smoke's
    ``DIN_TOL`` of the same params and batch on the CPU."""
    from repro_torch.models.recsys import din
    cfg = _din_small()
    params = din.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"hist_items": rng.integers(-1, cfg.n_items, (64, cfg.seq_len)),
             "hist_cates": rng.integers(0, cfg.n_cates, (64, cfg.seq_len)),
             "cand_item": rng.integers(0, cfg.n_items, 64),
             "cand_cate": rng.integers(0, cfg.n_cates, 64)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = din.forward(params, batch, cfg)
    got = din.forward({k: (v.to(cuda) if not isinstance(v, dict) else
                           {kk: vv.to(cuda) for kk, vv in v.items()})
                       for k, v in params.items()},
                      {k: v.to(cuda) for k, v in batch.items()}, cfg)
    smoke.din_close(got, want, "DIN on the card")


def test_din_ids_past_the_tables_do_not_assert_on_the_card(cuda):
    """An item id at or above ``n_items`` (a category id at or above
    ``n_cates``) reads the last row on the card as on the CPU, -1 reads
    zeros; no device-side assert."""
    from repro_torch.models.recsys import din
    cfg = _din_small()
    params = din.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    items = torch.tensor([0, -1, 999, 1000, 2 ** 40], device=cuda)
    cates = torch.tensor([0, 3, 31, 32, 2 ** 40], device=cuda)
    got = din.embed_items(params, items, cates)
    torch.cuda.synchronize()
    last = torch.cat([params["item_table"][-1], params["cate_table"][-1]])
    for i in (2, 3, 4):
        assert torch.equal(got[i], last)
    assert not got[1].any()


def test_din_packed_requests_decode_through_k1(cuda, smoke):
    """``chip_smoke.din_packed_serve`` at b = 3 (a catalog of 2^17 + 1
    items): one K1 launch a request, the decoded ids equal
    ``decode_ids`` as int64, the logits within ``DIN_TOL`` of the plain
    CPU path."""
    from repro_torch.models.recsys import din
    cfg = _din_small(n_items=2 ** 17 + 1)
    params = din.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    out = smoke.din_packed_serve(cfg, params, cuda, batch=16, n_requests=3)
    assert out["b"] == 3 and out["k1_launches"] == 3
    assert out["ids_checked"] == 3 * 16 * (cfg.seq_len + 1)


def test_compressed_step_on_an_nccl_world_of_one(cuda, smoke):
    """One ``--compress-grads`` step of the reduced DIN on a world-size-1
    NCCL group (int8 all-reduce on the card), every residual within half
    the quantisation step (``chip_smoke.checked_ef``)."""
    import torch.distributed as dist

    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig, adamw_init, ef_state_init
    cfg = _din_small()
    calls = []
    with tr.process_group(cuda) as group:
        assert dist.get_backend(group) == "nccl"
        init_fn, step = tr._make_step("din", cfg, AdamWConfig(), "recsys",
                                      True, device=cuda)
        state = {"params": init_fn(0)}
        state["opt"] = adamw_init(state["params"], AdamWConfig())
        state["ef"] = ef_state_init(state["params"])
        batch = next(tr._din_batches(cfg, 32, device=cuda))
        with smoke.checked_ef(calls):
            state, met = step(state, batch)
        torch.cuda.synchronize()
    assert not dist.is_initialized()
    assert len(calls) == 1 and np.isfinite(float(met["loss"]))


def _cell(smoke, arch, shape, variant="baseline", **kw):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.variants import apply_variant
    build = {**apply_variant(arch, shape, variant), **kw}
    rec = run_cell(arch, shape, "card", variant, build_kw=kw)
    return build_cell(arch, shape, card_mesh(), **build), rec


@pytest.mark.parametrize("arch", ["gcn-cora", "pna", "meshgraphnet",
                                  "dimenet"])
def test_gnn_cell_steps_on_the_card(cuda, smoke, arch):
    """``[cells]``'s runner on a GNN's ``molecule`` cell: K2 and its
    backward launched as the step's requests ask, every step, the
    outputs' shapes and dtypes the abstract trace's, the first step held
    to the plain path and to the CPU, losses finite."""
    cell, rec = _cell(smoke, arch, "molecule")
    r = smoke.run_cell_on_device(cell, rec, cuda, reps=1, parity=True)
    want = r["expected_per_step"]
    for k in ("k2", "k2_grad"):
        assert r["main_launches"][k] == 3 * want[k] and want[k] > 0
    assert r["parity"]["cpu_loss_rel_err"] <= smoke.TRAIN_LOSS_RTOL
    assert r["max_memory_allocated"] > 0


def test_compbin_cell_decodes_through_k1(cuda, smoke):
    """gcn-cora on ``full_graph_sm`` under ``edges_compbin``: two K1
    launches a step, the ids K1 decodes equal the packed ones, and the
    first step (K1 and K2) held to the plain path fed the int64 ids."""
    cell, rec = _cell(smoke, "gcn-cora", "full_graph_sm", "edges_compbin")
    r = smoke.run_cell_on_device(cell, rec, cuda, reps=1, parity=True)
    assert r["main_launches"]["k1"] == 3 * 2
    assert r["check_launches"]["k1"] == 2 + 2
    assert r["ids_checked"] == 2 * 10_752
    assert r["parity"]["loss_rel_err"] <= smoke.TRAIN_LOSS_RTOL


def test_prefill_cell_goes_through_k3(cuda, smoke):
    """A 2-layer smollm-360m prefill cell at full width on a [2, 1024]
    batch: one K3 launch a layer, sampled rows held to float64."""
    cell, rec = _cell(smoke, "smollm-360m", "prefill_32k",
                      cfg_overrides={"n_layers": 2})
    r = smoke.run_cell_on_device(cell, rec, cuda, reps=1,
                                 lm_shape=(2, 1024))
    assert r["main_launches"]["k3"] == 2 * 2
    assert r["shadow_calls"] == 2 and r["shadow_worst_err_over_atol"] <= 1


def test_dry_run_estimate_bounds_a_cells_memory(cuda, smoke):
    """DIN ``serve_p99``: the card-path estimate is the memory the step
    took beyond what was allocated before it, to the caching
    allocator's rounding of each block up to 512 B."""
    cell, rec = _cell(smoke, "din", "serve_p99")
    r = smoke.run_cell_on_device(cell, rec, cuda, reps=1)
    assert 0.999 <= r["estimate_over_measured"] <= 1.05
    assert r["main_launches"] == {"k1": 0, "k2": 0, "k2_grad": 0, "k3": 0}


def test_examples_run_on_the_card(cuda, smoke, tmp_path):
    """``[examples]``' runner on the card at a few steps: the quickstart
    streams its graph through K1 (once a partition), the GNN example's
    two regimes take K1, K2 and its backward as ``example_launches``
    reckons them (K2 as the run's requests ask) with the first step held
    to the plain path and the loss falling, DIN's first request within
    ``DIN_TOL`` of the plain CPU path."""
    argv = {"quickstart_compbin": ("--format", "compbin", "--scale", "12"),
            "gnn": ("--steps", "20"),
            "gnn_sampled": ("--sampled", "--steps", "20"),
            "din": ("--items", "1000", "--requests", "3", "--batch", "8")}
    runs = tuple(run._replace(argv=argv[run.label])
                 for run in smoke.EXAMPLE_RUNS if run.label in argv)
    r = smoke.phase_examples(cuda, str(tmp_path), runs=runs)["runs"]
    assert r["quickstart_compbin"]["launches"]["k1"] == \
        r["quickstart_compbin"]["stream"]["partitions"] > 0
    for label in ("gnn", "gnn_sampled"):
        k = r[label]["launches"]
        assert k["k1"] > 0 and k["k2"] > 0 and k["k2_grad"] > 0
        assert r[label]["checks"]["parity"]["loss_rel_err"] <= \
            smoke.TRAIN_LOSS_RTOL
    assert r["din"]["checks"]["max_abs_err"] <= smoke.DIN_TOL
