"""PNA's aggregators in the port (``scatter_max``, ``scatter_min``,
``scatter_std``) against the JAX package's on the same numpy inputs,
values and gradients (``jax.grad`` of a weighted sum against autograd of
the same sum).  Values: f32 rtol 1e-5 / atol 1e-6 (max and min pick
elements, so they are held bit for bit too); gradients: rtol 1e-4 /
atol 1e-6 x max|g|, but for ``scatter_std``'s: at a zero variance its
gradient is the difference of two terms that cancel exactly, scaled by
1 / (2 sqrt(1e-5)) ~ 158, so either package's f32 rounding shows as
~1e-5 where the exact gradient is 0.  Those are held to the JAX
package's own run in float64: no further from it than twice the f32
reference is, plus 1e-6 x max|g|.  The cases cover ``-1`` padding, ids at or above N
(dropped), empty segments (0), planted ties (a tied maximum shares its
segment's gradient evenly, as ``jax.ops.segment_max`` does) and relu
zeros (all-zero segments: ``scatter_std``'s variance sits at the
``maximum``'s tie).  The gather's autograd function (``_Gather``, the
card's training path, whose gradient is K2's segment sum) is held bit
for bit to autograd of the plain gather on the CPU."""

import _torch_env  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import layers as ref_layers
from repro_torch.kernels.segment_sum import segment_sum
from repro_torch.models.gnn import layers as port_layers

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-6
AGGS = ("scatter_max", "scatter_min", "scatter_std")


def _case(kind: str, seed: int = 0):
    """(messages f32[E, D], ids int32[E], n) for one case."""
    rng = np.random.default_rng(seed)
    n, e, d = 12, 80, 5
    msgs = rng.standard_normal((e, d)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    if kind == "padding":
        ids[rng.random(e) < 0.3] = -1
    elif kind == "ids_at_or_above_n":
        ids[::4] = n + rng.integers(0, 3, ids[::4].size)
    elif kind == "empty_segments":
        ids = rng.integers(0, n // 2, e).astype(np.int32) * 2   # odd: empty
        ids[:5] = -1
    elif kind == "planted_ties":
        ids = np.repeat(np.arange(n), e // n + 1)[:e].astype(np.int32)
        top = msgs.max() + 1.0
        msgs[ids == 3] = top                      # a whole segment tied
        msgs[np.flatnonzero(ids == 5)[:3], 1] = top   # three tied maxima
        msgs[np.flatnonzero(ids == 7)[:2], :] = -top  # two tied minima
    elif kind == "relu_zeros":
        msgs = np.maximum(msgs, 0)
        msgs[ids == 2] = 0                        # an all-zero segment
    return msgs, ids, n


KINDS = ("padding", "ids_at_or_above_n", "empty_segments", "planted_ties",
         "relu_zeros")


def _ref(name, msgs, ids, n, w):
    fn = getattr(ref_layers, name)

    def loss(m):
        return jnp.sum(fn(m, jnp.asarray(ids), n) * w)

    out = fn(jnp.asarray(msgs), jnp.asarray(ids), n)
    return np.asarray(out), np.asarray(jax.grad(loss)(jnp.asarray(msgs)))


def _port(name, msgs, ids, n, w, device="cpu"):
    fn = getattr(port_layers, name)
    m = torch.from_numpy(msgs).to(device).requires_grad_()
    out = fn(m, torch.from_numpy(ids).to(device), n)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w).to(device)).sum(),
                               m)
    return out.detach().cpu().numpy(), g.cpu().numpy()


def _ref64(name, msgs, ids, n, w):
    """:func:`_ref` in float64: the arbiter of ``scatter_std``'s grads."""
    with jax.enable_x64(True):
        return _ref(name, msgs.astype(np.float64), ids, n,
                    w.astype(np.float64))


def _check(got, want, exact=None):
    """Values to the reference; gradients to the reference, or, given
    ``exact`` (the reference in float64), no further from its gradient
    than twice the f32 reference's distance plus the share."""
    (out, g), (rout, rg) = got, want
    assert out.shape == rout.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, rout, rtol=RTOL, atol=ATOL)
    if exact is None:
        np.testing.assert_allclose(g, rg, rtol=GRAD_RTOL,
                                   atol=GRAD_SHARE * np.abs(rg).max())
        return
    g64 = exact[1]
    bound = 2 * np.abs(rg - g64).max() + GRAD_SHARE * np.abs(g64).max()
    assert np.abs(g - g64).max() <= bound, (np.abs(g - g64).max(), bound)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", AGGS)
def test_aggregator_values_and_grads_match_jax(name, kind):
    msgs, ids, n = _case(kind)
    w = np.random.default_rng(9).standard_normal(
        (n, msgs.shape[1])).astype(np.float32)
    got, want = _port(name, msgs, ids, n, w), _ref(name, msgs, ids, n, w)
    if name == "scatter_std":
        _check(got, want, _ref64(name, msgs, ids, n, w))
    else:                                     # a pick: bit for bit
        _check(got, want)
        np.testing.assert_array_equal(got[0], want[0])


def test_empty_segments_and_dropped_ids_give_zero():
    msgs, ids, n = _case("empty_segments")
    ids[-3:] = [n, n + 7, -1]
    hit = np.zeros(n, bool)
    hit[ids[(ids >= 0) & (ids < n)]] = True
    for name in AGGS[:2]:
        out = getattr(port_layers, name)(torch.from_numpy(msgs),
                                         torch.from_numpy(ids), n)
        assert not out[torch.from_numpy(~hit)].any()
    std = port_layers.scatter_std(torch.from_numpy(msgs),
                                  torch.from_numpy(ids), n)
    np.testing.assert_allclose(std[torch.from_numpy(~hit)].numpy(),
                               np.sqrt(np.float32(1e-5)), rtol=1e-6)


def test_tied_maxima_share_the_gradient_as_jax_does():
    """The reference's own example: [1, 3, 3] -> grads [0, .5, .5]."""
    msgs = np.array([[1.0], [3.0], [3.0], [2.0]], np.float32)
    ids = np.array([0, 0, 0, 1], np.int32)
    w = np.ones((2, 1), np.float32)
    out, g = _port("scatter_max", msgs, ids, 2, w)
    np.testing.assert_array_equal(out, [[3.0], [2.0]])
    np.testing.assert_array_equal(g[:, 0], [0.0, 0.5, 0.5, 1.0])
    np.testing.assert_array_equal(g, _ref("scatter_max", msgs, ids, 2, w)[1])
    _, g = _port("scatter_min", -msgs, ids, 2, w)
    np.testing.assert_array_equal(g[:, 0], [0.0, 0.5, 0.5, 1.0])


def test_std_at_zero_variance_matches_jax():
    """One-message and equal-message segments have E[m^2] - E[m]^2 == 0
    exactly (the maximum's tie)."""
    msgs = np.array([[2.0], [1.0], [3.0], [4.0], [4.0]], np.float32)
    ids = np.array([0, 1, 1, 2, 2], np.int32)
    w = np.ones((3, 1), np.float32)
    got, want = (_port("scatter_std", msgs, ids, 3, w),
                 _ref("scatter_std", msgs, ids, 3, w))
    np.testing.assert_array_equal(got[1], want[1])
    _check(got, want)


def test_std_grads_on_a_rounded_tie_are_held_to_float64():
    """Seven equal messages whose mean rounds: the exact gradient is 0,
    and both packages' f32 gradients are rounding apart from it (the
    reference's +1.5e-5 where the port's is -1.5e-5 on this case)."""
    msgs, ids, n = _case("planted_ties")
    w = np.random.default_rng(9).standard_normal(
        (n, msgs.shape[1])).astype(np.float32)
    got, want = (_port("scatter_std", msgs, ids, n, w),
                 _ref("scatter_std", msgs, ids, n, w))
    exact = _ref64("scatter_std", msgs, ids, n, w)
    tied = ids == 3
    assert np.abs(exact[1][tied]).max() < 1e-12
    assert np.abs(want[1][tied]).max() > 1e-6     # the reference's rounding
    _check(got, want, exact)


def test_std_sums_go_through_the_segment_sum(monkeypatch):
    msgs, ids, n = _case("padding")
    calls = []

    def counting(m, i, nn):
        calls.append(tuple(m.shape))
        return segment_sum(m, i, nn)

    monkeypatch.setattr(port_layers, "segment_sum", counting)
    port_layers.scatter_std(torch.from_numpy(msgs), torch.from_numpy(ids), n)
    port_layers.scatter_max(torch.from_numpy(msgs), torch.from_numpy(ids), n)
    # two means, each a sum and a degree; the max adds none
    assert calls == [msgs.shape, (msgs.shape[0], 1)] * 2


def test_zero_segments_and_zero_edges():
    for name in AGGS:
        fn = getattr(port_layers, name)
        out = fn(torch.ones(4, 3), torch.zeros(4, dtype=torch.int32), 0)
        assert tuple(out.shape) == (0, 3)
        out = fn(torch.ones(0, 3), torch.zeros(0, dtype=torch.int32), 5)
        assert tuple(out.shape) == (5, 3)
        want = np.sqrt(np.float32(1e-5)) if name == "scatter_std" else 0.0
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


GATHER_KINDS = ("padding", "ids_at_or_above_n", "hubs", "no_edges",
                "one_node")


def _gather_ids(kind: str, ids_dtype):
    """(ids[E], n) for one gather case."""
    rng = np.random.default_rng(GATHER_KINDS.index(kind))
    n, e = 12, 300
    ids = rng.integers(0, n, e)
    if kind == "padding":
        ids[rng.random(e) < 0.3] = -1
    elif kind == "ids_at_or_above_n":       # their rows go to row n - 1
        ids[::3] = n + rng.integers(0, 5, ids[::3].size)
        ids[1::7] = -1
    elif kind == "hubs":                    # one id thousands of times
        ids = np.concatenate([np.full(5000, 4), ids, np.full(3000, n - 1)])
        rng.shuffle(ids)
    elif kind == "no_edges":
        ids = ids[:0]
    elif kind == "one_node":
        n, ids = 1, np.where(rng.random(e) < 0.2, -1, rng.integers(0, 3, e))
    return torch.from_numpy(ids).to(ids_dtype), n


@pytest.mark.parametrize("through_cat", [False, True])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", GATHER_KINDS)
def test_gather_function_matches_the_plain_gather(kind, ids_dtype,
                                                  through_cat):
    """``_Gather`` called directly on CPU tensors (its backward then takes
    K2's plain version) against autograd of the plain gather, both bit for
    bit on integer-valued inputs: the forward, and the gradient, also of
    the two halves of a ``torch.cat`` (strided ``grad_out``, as PNA's
    message input hands them over)."""
    ids, n = _gather_ids(kind, ids_dtype)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-4, 5, (n, 6)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (ids.numel(),
                                              12 if through_cat else 6)
                                      ).astype(np.float32))
    flipped = ids.flip(0)

    def grad(fn):
        xg = x.clone().requires_grad_()
        out = fn(xg, ids)
        if through_cat:
            out = torch.cat([out, fn(xg, flipped)], dim=-1)
        (g,) = torch.autograd.grad((out * w).sum(), xg)
        return out.detach(), g

    before = port_layers.gather.grad_launches
    out, g = grad(port_layers._Gather.apply)
    want_out, want_g = grad(port_layers.gather_plain)
    assert port_layers.gather.grad_launches == before     # nothing on the CPU
    assert out.dtype == g.dtype == torch.float32
    assert torch.equal(out, want_out) and torch.equal(g, want_g)
    # the forward is the gather as it was: clamped read, -1 rows zeroed
    clamped = x[ids.clamp(0, n - 1)]
    assert torch.equal(out[:, :6], torch.where((ids >= 0)[:, None],
                                               clamped, 0))
    if kind == "ids_at_or_above_n":
        assert g[-1].abs().sum() > 0


@pytest.mark.parametrize("how", ["cpu", "no_grad", "needs_no_grad"])
def test_public_gather_takes_the_plain_path_off_a_training_step(how):
    """The public ``gather`` engages ``_Gather`` only on a CUDA tensor
    that requires grad under grad mode: on the CPU, under ``no_grad`` and
    for a tensor that needs no gradient it is the plain gather."""
    ids, n = _gather_ids("padding", torch.int32)
    x = torch.randn(n, 4, requires_grad=how != "needs_no_grad")
    if how == "no_grad":
        with torch.no_grad():
            out = port_layers.gather(x, ids)
        assert out.grad_fn is None
    else:
        out = port_layers.gather(x, ids)
        assert type(out.grad_fn).__name__ == (
            "WhereBackward0" if how == "cpu" else "NoneType")
    assert torch.equal(out, port_layers.gather_plain(x, ids))


def test_gather_backward_counts_and_names_only_launches():
    """``gather.grad_launches`` counts K2 launches alone: a backward on
    the CPU, with edges or none, adds nothing; the backward's sum runs in
    the ``gnn.gather.backward`` range, and none opens for no edge."""
    x = torch.randn(5, 3, requires_grad=True)
    before = port_layers.gather.grad_launches
    for ids in (torch.tensor([0, 4, -1, 9, 4]), torch.zeros(0, dtype=int)):
        with torch.profiler.profile() as prof:
            out = port_layers._Gather.apply(x, ids)
            (g,) = torch.autograd.grad(out.sum(), x)
        assert g.shape == x.shape
        ranges = [e.name for e in prof.events()
                  if e.name == "gnn.gather.backward"]
        assert ranges == (["gnn.gather.backward"] if ids.numel() else [])
    assert port_layers.gather.grad_launches == before


# The fused gather, scale and sum (``weighted_scatter_sum``): on the CPU
# always the unfused expression, bit for bit; on the card the fused
# kernel only where no gradient is needed.
FUSED_KINDS = ("padding", "ids_at_or_above_n", "negative_dst", "hubs",
               "no_edges", "one_column", "no_segments", "no_rows")


def _fused_case(kind: str, ids_dtype):
    """(x f32[NX, D], src, w f32[E], dst, n) for one case: random
    floats, so the bits of every product and sum show."""
    rng = np.random.default_rng(40 + FUSED_KINDS.index(kind))
    nx, e, d, n = 12, 300, 5, 12
    src, dst = rng.integers(0, nx, e), rng.integers(0, n, e)
    if kind == "padding":
        src[rng.random(e) < 0.3] = -1
        dst[rng.random(e) < 0.2] = -1
    elif kind == "ids_at_or_above_n":       # src reads row NX - 1, dst drops
        src[::3] = nx + rng.integers(0, 5, src[::3].size)
        dst[1::4] = n + rng.integers(0, 5, dst[1::4].size)
    elif kind == "negative_dst":
        drop = rng.random(e) < 0.4
        dst[drop] = -rng.integers(1, 4, int(drop.sum()))
        src[::7] = -2
    elif kind == "hubs":
        src[rng.random(e) < 0.5], dst[rng.random(e) < 0.5] = 3, n - 1
    elif kind == "no_edges":
        src, dst = src[:0], dst[:0]
    elif kind == "one_column":
        d = 1
    elif kind == "no_segments":             # every dst dropped
        n = 0
    elif kind == "no_rows":
        nx, src, dst = 0, src[:0], dst[:0]
    x = torch.from_numpy(rng.standard_normal((nx, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(src.size).astype(np.float32))
    return (x, torch.from_numpy(src).to(ids_dtype), w,
            torch.from_numpy(dst).to(ids_dtype), n)


def _unfused(x, src, w, dst, n):
    """GCN's aggregation as the model wrote it before the seam."""
    return port_layers.scatter_sum(port_layers.gather_plain(x, src)
                                   * w[:, None], dst, n)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", FUSED_KINDS)
def test_weighted_scatter_sum_is_the_unfused_expression(kind, ids_dtype):
    """On the CPU the seam, the op and its plain version all give the
    unfused chain's bits: -1 and other negative src send nothing, src at
    or above NX read row NX - 1, dst outside [0, N) are dropped; no
    edge, one column, no segment and no row of x give the right
    shape; nothing counts as a launch."""
    from repro_torch.kernels.segment_sum import (gather_scale_sum,
                                                 gather_scale_sum_ref)

    x, src, w, dst, n = _fused_case(kind, ids_dtype)
    want = _unfused(x, src, w, dst, n)
    before = segment_sum.launches, segment_sum.gather_launches
    got = port_layers.weighted_scatter_sum(x, src, w, dst, n)
    assert (segment_sum.launches, segment_sum.gather_launches) == before
    assert got.dtype == torch.float32 and got.shape == (n, x.shape[1])
    assert torch.equal(got, want)
    assert torch.equal(gather_scale_sum(x, src, w, dst, n), want)
    assert torch.equal(gather_scale_sum_ref(x, src, w, dst, n), want)
    if kind == "ids_at_or_above_n":        # the clamped reads land
        assert want.abs().sum() > 0


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: the seam's choice of
    path, seen without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("how,fused", [
    ("no_grad_needed", True), ("x_needs_grad", False), ("w_needs_grad", False),
    ("no_grad_mode", True), ("float64", False), ("plan_rows", False),
    ("mixed_id_dtypes", False), ("cpu", False)])
def test_weighted_scatter_sum_takes_the_fused_op_only_without_grad(
        monkeypatch, how, fused):
    """On the card the seam takes K2's fused forward for float32 inputs
    that need no gradient under grad mode (also tensors that do, under
    ``no_grad``) where ``plan`` picks ``atomic``; a gradient, float64,
    src and dst of two id dtypes or a ``rows`` plan (wide rows, few
    edges) keep the unfused expression, and so does every CPU tensor."""
    calls = []
    monkeypatch.setattr(port_layers, "gather_scale_sum",
                        lambda *a: calls.append("fused") or "fused")
    monkeypatch.setattr(port_layers, "scatter_sum",
                        lambda *a: calls.append("plain") or "plain")
    d = 1433 if how == "plan_rows" else 16
    dtype = torch.float64 if how == "float64" else torch.float32
    x = torch.randn(10, d, dtype=dtype)
    w = torch.randn(30, dtype=dtype)
    if how != "cpu":
        x, w = x.as_subclass(_OnCard), w.as_subclass(_OnCard)
    if how in ("x_needs_grad", "no_grad_mode"):
        x.requires_grad_()
    if how == "w_needs_grad":
        w.requires_grad_()
    ids = torch.randint(0, 10, (30,))
    dst = ids.int() if how == "mixed_id_dtypes" else ids
    with torch.set_grad_enabled(how != "no_grad_mode"):
        out = port_layers.weighted_scatter_sum(x, ids, w, dst, 10)
    assert calls == [out] == ["fused" if fused else "plain"]


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", ["padding", "ids_at_or_above_n", "hubs"])
def test_weighted_scatter_sum_gradients_are_the_unfused_ones(kind,
                                                             ids_dtype):
    """Gradients of x and w through the seam on the CPU equal autograd of
    the unfused expression bit for bit."""
    x, src, w, dst, n = _fused_case(kind, ids_dtype)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n, x.shape[1])).astype(np.float32))

    def grads(fn):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        return torch.autograd.grad((fn(xg, src, wg, dst, n) * g).sum(),
                                   (xg, wg))

    for got, want in zip(grads(port_layers.weighted_scatter_sum),
                         grads(_unfused)):
        assert torch.equal(got, want)


def _gcn_forward_unfused(params, batch, cfg):
    """``gcn.forward`` with each layer's aggregation written as the
    gather, the product and the sum, as the model had it before the
    fused seam."""
    from repro_torch.models.gnn import layers as L

    x = batch["x"].to(cfg.dtype)
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = x.shape[0]
    deg = L.degree(dst, n) + 1.0
    dn = torch.rsqrt(deg)
    w_edge = (L.gather(dn[:, None], src)[:, 0]
              * L.gather(dn[:, None], dst)[:, 0])
    self_w = 1.0 / deg
    for i in range(cfg.n_layers):
        if cfg.transform_first and params[f"w{i}"].shape[1] < x.shape[1]:
            x = x @ params[f"w{i}"]
            msgs = L.gather(x, src) * w_edge[:, None]
            x = (L.scatter_sum(msgs, dst, n) + x * self_w[:, None]
                 + params[f"b{i}"])
        else:
            msgs = L.gather(x, src) * w_edge[:, None]
            agg = L.scatter_sum(msgs, dst, n) + x * self_w[:, None]
            x = agg @ params[f"w{i}"] + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


@pytest.mark.parametrize("transform_first", [False, True])
def test_gcn_forward_and_gradients_are_unchanged_on_the_cpu(transform_first):
    """GCN's logits and every parameter's gradient on the CPU, through
    the fused seam, equal the unfused forward's bit for bit (padding and
    ids at or above N in the edge list)."""
    import dataclasses

    from repro_torch.models.gnn import gcn

    rng = np.random.default_rng(11)
    n, e = 40, 400
    cfg = dataclasses.replace(gcn.GCNConfig(d_in=24, n_classes=5),
                              transform_first=transform_first)
    src, dst = rng.integers(-1, n + 2, e), rng.integers(-1, n + 2, e)
    batch = {"x": torch.from_numpy(rng.standard_normal(
                 (n, cfg.d_in)).astype(np.float32)),
             "edge_src": torch.from_numpy(src).to(torch.int32),
             "edge_dst": torch.from_numpy(dst).to(torch.int32)}
    params = gcn.init_params(cfg, torch.Generator().manual_seed(3))
    for k in params:                        # biases off zero
        params[k] = params[k] + 0.1 * torch.randn(
            params[k].shape, generator=torch.Generator().manual_seed(4))

    def run(fwd):
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits = fwd(p, batch, cfg)
        g = torch.autograd.grad((logits * logits).sum(), list(p.values()))
        return logits.detach(), g

    logits, grads = run(gcn.forward)
    want_logits, want_grads = run(_gcn_forward_unfused)
    assert torch.equal(logits, want_logits)
    for got, want in zip(grads, want_grads):
        assert torch.equal(got, want)
