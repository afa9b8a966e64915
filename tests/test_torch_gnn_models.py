"""PNA, MeshGraphNet and DimeNet in the port against the JAX package, on
the CPU, on the same numpy inputs and the JAX package's own weights
(carried over by ``convert.gnn_params_from_numpy``).

Forward: f32 rtol/atol 1e-5.  Loss: rtol 1e-5.  Gradients: rtol 1e-4 /
atol 1e-6 x max|g| for MeshGraphNet and DimeNet.  PNA's gradients pass
through ``scatter_std``, whose E[m^2] - E[m]^2 cancels: either
package's f32 gradient carries ~1e-5 x max|g| of rounding (the JAX
package's own f32 run is 1.2e-6 off its float64 run in ``msg_w0``, of
a max|g| of 0.098, on this file's block), so they are held to the JAX
package's float64 run: within (2 x s + 1e-6) x max|g| of it, s being
the f32 reference's worst distance from it over all parameters, each
relative to its max|g| (``chip_smoke.py::exact_close`` on the card).  Batches (edge index, triplets, features,
targets): equal array for array.  Training: 10 steps of the CLI's paths
from the JAX weights, losses within rtol 1e-5 of the reference's."""

import _torch_env  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro import checkpoint as ref_ck
from repro.configs import get_arch as ref_get_arch
from repro.graph import NeighborSampler as RefSampler
from repro.graph import rmat as ref_rmat
from repro.launch import data_gnn as ref_data_gnn
from repro.launch.serve import make_gnn_server as ref_make_gnn_server
from repro.launch.steps import _GNN_MODULES as REF_MODULES
from repro.launch.steps import _gnn_config as ref_gnn_config
from repro.configs.shapes import GNN_SHAPES as REF_GNN_SHAPES
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro_torch import checkpoint as ck
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import GNN_SHAPES
from repro_torch.convert import csr_from_numpy, gnn_params_from_numpy
from repro_torch.graph import NeighborSampler as PortSampler
from repro_torch.launch import data_gnn, train
from repro_torch.launch import serve as port_serve
from repro_torch.launch.steps import _GNN_MODULES, _gnn_config
from repro_torch.optim.adamw import tree_leaves, tree_map

ARCHS = ("pna", "meshgraphnet", "dimenet")
RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-6
CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree) -> list:
    """Leaves of a JAX params tree in the port's order (sorted keys)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _cfgs(arch, full=False):
    make = "make_config" if full else "make_reduced"
    return getattr(get_arch(arch), make)(), getattr(ref_get_arch(arch), make)()


@pytest.fixture(scope="module")
def graph():
    return ref_rmat(9, 8, seed=3)


def _block_pair(graph, seed=1, n_seeds=16):
    seeds = np.random.default_rng(seed).integers(0, graph.n_vertices,
                                                 n_seeds)
    rb = RefSampler(graph, (5, 5), seed=0).sample(seeds)
    pb = PortSampler(csr_from_numpy(graph.offsets, graph.neighbors), (5, 5),
                     seed=0).sample(seeds)
    return rb, pb


def _batches(arch, cfg, rcfg, graph, seed=2):
    """The same minibatch from both packages' ``block_to_batch``."""
    rb, pb = _block_pair(graph)
    want = ref_data_gnn.block_to_batch(arch, rcfg, rb,
                                       np.random.default_rng(seed))
    got = data_gnn.block_to_batch(arch, cfg, pb, np.random.default_rng(seed),
                                  device=CPU)
    return got, want


def _assert_batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "n_graphs":
            assert got[k] == v and type(got[k]) is int
            continue
        assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


def _loss_grads(mod, params, batch, cfg):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = mod.loss_fn(p, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return float(loss.detach()), [g.numpy() for g in grads]


def _ref64_grads(arch, rparams, rbatch, rcfg):
    """The JAX package's gradients in float64 (its loss casts the logits
    to f32 for the cross entropy; the aggregations run in float64)."""
    with jax.enable_x64(True):
        cfg64 = dataclasses.replace(rcfg, dtype=jnp.float64)
        p64 = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64), rparams)
        b64 = {k: (jnp.asarray(v, jnp.float64)
                   if np.asarray(v).dtype == np.float32 else v)
               for k, v in rbatch.items()}
        g = jax.grad(lambda p: REF_MODULES[arch].loss_fn(p, b64, cfg64))(p64)
        return _leaves(g)


def _check_grads(arch, got, want, exact=None):
    if arch == "pna":       # the f32 reference's worst relative distance
        scale = max(np.abs(rg - g64).max() / np.abs(g64).max()
                    for rg, g64 in zip(want, exact))
    for g, rg, g64 in zip(got, want, exact or [None] * len(want)):
        assert g.shape == rg.shape
        if arch != "pna":
            np.testing.assert_allclose(g, rg, rtol=GRAD_RTOL,
                                       atol=GRAD_SHARE * np.abs(rg).max())
            continue
        bound = (2 * scale + GRAD_SHARE) * np.abs(g64).max()
        assert np.abs(g - g64).max() <= bound, (np.abs(g - g64).max(), bound)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_params_mirror_the_reference(arch):
    spec, ref_spec = get_arch(arch), ref_get_arch(arch)
    assert (spec.arch_id, spec.family, spec.citation) == \
        (ref_spec.arch_id, ref_spec.family, ref_spec.citation)
    for full in (True, False):
        cfg, rcfg = _cfgs(arch, full)
        for f in dataclasses.fields(rcfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
        assert cfg.dtype == torch.float32
        p = _GNN_MODULES[arch].init_params(cfg,
                                           torch.Generator().manual_seed(0))
        r = REF_MODULES[arch].init_params(rcfg, jax.random.key(0))
        flat = jax.tree_util.tree_flatten_with_path(r)[0]
        assert len(tree_leaves(p)) == len(flat)
        for (path, leaf), mine in zip(flat, tree_leaves(p)):
            assert tuple(mine.shape) == leaf.shape, path
            assert mine.dtype == torch.float32
            if jax.tree_util.keystr(path).endswith("_b']"):
                assert not mine.any()           # zero biases, as there
    for shape_id, shape in GNN_SHAPES.items():
        a = _gnn_config(arch, shape)
        b = ref_gnn_config(arch, REF_GNN_SHAPES[shape_id])
        assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)
                if f.name != "dtype"} == \
            {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
             if f.name != "dtype"}


def test_mlp_matches_the_reference():
    from repro.models.common import init_mlp as ref_init_mlp
    from repro.models.common import mlp as ref_mlp
    from repro_torch.models.common import init_mlp, mlp
    names = ["l0", "l1", "l2"]
    rp = ref_init_mlp(jax.random.key(3), [5, 7, 7, 2], names)
    p = init_mlp(torch.Generator().manual_seed(3), [5, 7, 7, 2], names)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in rp.items()}
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    pp = gnn_params_from_numpy(_np_tree(rp), CPU)
    for final in (None, "tanh"):
        got = mlp(pp, torch.from_numpy(x), names,
                  final_act=final and torch.tanh)
        want = ref_mlp(rp, jnp.asarray(x), names,
                       final_act=final and jnp.tanh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    with pytest.raises(ValueError, match="sizes"):
        init_mlp(torch.Generator(), [3, 4], names)


# ---------------------------------------------------------------------------
# forward, loss and gradients on the reference's weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(graph, arch, full):
    cfg, rcfg = _cfgs(arch, full)
    got_b, want_b = _batches(arch, cfg, rcfg, graph)
    rparams = REF_MODULES[arch].init_params(rcfg, jax.random.key(0))
    params = gnn_params_from_numpy(_np_tree(rparams), CPU)
    want = np.asarray(REF_MODULES[arch].forward(rparams, want_b, rcfg))
    with torch.inference_mode():
        got = _GNN_MODULES[arch].forward(params, got_b, cfg).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(graph, arch):
    cfg, rcfg = _cfgs(arch)
    got_b, want_b = _batches(arch, cfg, rcfg, graph)
    rparams = REF_MODULES[arch].init_params(rcfg, jax.random.key(0))
    params = gnn_params_from_numpy(_np_tree(rparams), CPU)
    rloss, rgrads = jax.value_and_grad(
        lambda p: REF_MODULES[arch].loss_fn(p, want_b, rcfg))(rparams)
    loss, grads = _loss_grads(_GNN_MODULES[arch], params, got_b, cfg)
    np.testing.assert_allclose(loss, float(rloss), rtol=RTOL)
    exact = _ref64_grads(arch, rparams, want_b, rcfg) if arch == "pna" \
        else None
    _check_grads(arch, grads, _leaves(rgrads), exact)
    assert all(np.isfinite(g).all() for g in grads)


def test_pna_grads_need_the_float64_arbiter(graph):
    """The measurement behind PNA's gradient tolerance: on this block
    the JAX package's own f32 gradients lie 1e-6 x max|g| or more from
    its float64 ones, where MeshGraphNet's and DimeNet's do not."""
    cfg, rcfg = _cfgs("pna")
    _, want_b = _batches("pna", cfg, rcfg, graph)
    rparams = REF_MODULES["pna"].init_params(rcfg, jax.random.key(0))
    g32 = _leaves(jax.grad(lambda p: REF_MODULES["pna"].loss_fn(
        p, want_b, rcfg))(rparams))
    g64 = _ref64_grads("pna", rparams, want_b, rcfg)
    share = max(np.abs(a - b).max() / np.abs(b).max()
                for a, b in zip(g32, g64))
    assert 1e-6 < share < 1e-4, share


# ---------------------------------------------------------------------------
# the reference's own invariance tests, on the port
# ---------------------------------------------------------------------------

def test_dimenet_rotation_invariance():
    from repro_torch.models.gnn import dimenet
    cfg = dimenet.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=4,
                                n_spherical=3, n_radial=3, d_in=4)
    p = dimenet.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    N, E, T = 12, 40, 60
    t = torch.from_numpy
    batch = dict(
        x=t(rng.standard_normal((N, 4)).astype(np.float32)),
        pos=t(rng.standard_normal((N, 3)).astype(np.float32)),
        edge_src=t(rng.integers(0, N, E)), edge_dst=t(rng.integers(0, N, E)),
        triplet_kj=t(rng.integers(0, E, T)),
        triplet_ji=t(rng.integers(0, E, T)),
        graph_id=t(np.zeros(N, np.int32)), n_graphs=1)
    out1 = dimenet.forward(p, batch, cfg)
    A = t(np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32))
    out2 = dimenet.forward(p, dict(batch, pos=batch["pos"] @ A), cfg)
    assert out1.shape == (1, 1)
    np.testing.assert_allclose(out2.detach().numpy(), out1.detach().numpy(),
                               rtol=1e-3, atol=1e-4)


def test_meshgraphnet_residual_identity_at_zero():
    from repro_torch.models.gnn import meshgraphnet as mgn
    cfg = mgn.MeshGraphNetConfig(n_layers=2, d_hidden=8, d_node_in=4,
                                 d_edge_in=4, d_out=2)
    p = mgn.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {"x": torch.zeros(5, 4), "edge_attr": torch.zeros(6, 4),
             "edge_src": torch.tensor([0, 1, 2, 3, 4, 0]),
             "edge_dst": torch.tensor([1, 2, 3, 4, 0, 2])}
    out = mgn.forward(p, batch, cfg)
    np.testing.assert_allclose(out.detach().numpy(), 0.0, atol=1e-6)


def test_pna_scalers_change_output():
    from repro_torch.models.gnn import pna
    rng = np.random.default_rng(0)
    cfg1 = pna.PNAConfig(n_layers=1, d_hidden=8, d_in=4, n_classes=2,
                         avg_log_degree=1.0)
    cfg2 = dataclasses.replace(cfg1, avg_log_degree=4.0)
    p = pna.init_params(cfg1, torch.Generator().manual_seed(0))
    batch = {"x": torch.from_numpy(
        rng.standard_normal((10, 4)).astype(np.float32)),
        "edge_src": torch.from_numpy(rng.integers(0, 10, 30)),
        "edge_dst": torch.from_numpy(rng.integers(0, 10, 30))}
    o1 = pna.forward(p, batch, cfg1)
    o2 = pna.forward(p, batch, cfg2)
    assert not torch.allclose(o1, o2)


# ---------------------------------------------------------------------------
# batches: equal array for array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_block_to_batch_equals_the_reference(graph, arch):
    cfg, rcfg = _cfgs(arch)
    got, want = _batches(arch, cfg, rcfg, graph)
    _assert_batch_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_graph_batch_equals_the_reference(arch):
    cfg, rcfg = _cfgs(arch)
    g = ref_rmat(8, 8, seed=5)
    want = ref_data_gnn.full_graph_batch(arch, rcfg, g,
                                         np.random.default_rng(3),
                                         n_classes=getattr(rcfg, "n_classes",
                                                           7))
    got = data_gnn.full_graph_batch(
        arch, cfg, csr_from_numpy(g.offsets, g.neighbors),
        np.random.default_rng(3), n_classes=getattr(cfg, "n_classes", 7),
        device=CPU)
    _assert_batch_equal(got, want)


def test_device_batch_passes_python_values_through():
    out = data_gnn.device_batch({"a": np.arange(3), "n_graphs": 1}, CPU)
    assert out["n_graphs"] == 1 and isinstance(out["a"], torch.Tensor)


# ---------------------------------------------------------------------------
# the CLI's training paths: 10 steps from the JAX weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gnn_models"))


def _ref_step(arch, rcfg, opt):
    """The reference CLI's step, with DimeNet's ``n_graphs`` kept out of
    the traced batch: the CLI's own ``jax.jit(step)`` traces it and
    DimeNet's ``int(batch["n_graphs"])`` then raises
    (:func:`test_reference_cli_cannot_train_dimenet`)."""
    _, rstep = ref_train._make_step(arch, rcfg, opt, "gnn", False)
    if arch != "dimenet":
        return rstep
    mod = REF_MODULES[arch]

    def step(state, batch, n_graphs):
        batch = {**batch, "n_graphs": n_graphs}
        loss, g = jax.value_and_grad(
            lambda p: mod.loss_fn(p, batch, rcfg))(state["params"])
        params, o, met = ref_adamw_update(state["params"], g, state["opt"],
                                          opt)
        return {"params": params, "opt": o}, {**met, "loss": loss}

    jitted = jax.jit(step, static_argnums=2)
    return lambda st, b: jitted(
        st, {k: v for k, v in b.items() if k != "n_graphs"}, b["n_graphs"])


def test_reference_cli_cannot_train_dimenet(workdir):
    """A reference fault the port does not mirror: ``repro.launch.train``
    jits its step over the whole batch, so DimeNet's static ``n_graphs``
    arrives traced and ``forward`` raises; the port's eager step trains
    (:func:`test_cli_training_matches_the_reference`)."""
    cfg, rcfg = _cfgs("dimenet")
    opt = RefAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1)
    rinit, rstep = ref_train._make_step("dimenet", rcfg, opt, "gnn", False)
    rparams = rinit(jax.random.key(0))
    batch = next(ref_train._gnn_batches("dimenet", rcfg, workdir, True))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        rstep({"params": rparams, "opt": ref_adamw_init(rparams, opt)},
              batch)


def _ref_losses(arch, rcfg, workdir, mode, rparams, steps=10):
    opt = RefAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                         master_f32=True)
    rstep = _ref_step(arch, rcfg, opt)
    if mode == "full_graph":
        batches = ref_train._gnn_full_graph_batches(arch, rcfg, workdir,
                                                    True, 2)
    elif mode == "sampled":
        batches = ref_train._gnn_sampled_batches(arch, rcfg, workdir, True)
    else:
        batches = ref_train._gnn_batches(arch, rcfg, workdir, True)
    state = {"params": rparams, "opt": ref_adamw_init(rparams, opt)}
    losses = []
    for _ in range(steps):
        state, met = rstep(state, next(batches))
        losses.append(float(met["loss"]))
    return losses


@pytest.mark.parametrize("arch,mode", [
    ("pna", "default"), ("pna", "sampled"), ("pna", "full_graph"),
    ("meshgraphnet", "default"), ("dimenet", "default")])
def test_cli_training_matches_the_reference(workdir, tmp_path, monkeypatch,
                                            arch, mode):
    """``train.train`` (what ``main`` runs) for 10 steps at ``--reduced
    --device cpu`` from the JAX package's initial weights, against the
    reference CLI's step on its own batches."""
    cfg, rcfg = _cfgs(arch)
    rparams = REF_MODULES[arch].init_params(rcfg, jax.random.key(0))
    mod = _GNN_MODULES[arch]
    monkeypatch.setattr(mod, "init_params", lambda c, gen, device=None:
                        gnn_params_from_numpy(_np_tree(rparams), device))
    out = train.train(arch, steps=10, reduced=True, device=CPU,
                      full_graph=mode == "full_graph",
                      sampled=mode == "sampled", hosts=2, workdir=workdir,
                      ckpt_dir=str(tmp_path / "ck"))
    want = _ref_losses(arch, rcfg, workdir, mode, rparams)
    assert len(out["losses"]) == 10 and np.isfinite(out["losses"]).all()
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("decode", ["host", "device"])
def test_pna_served_logits_match_the_jax_server(tmp_path, decode):
    cfg, rcfg = _cfgs("pna")
    rparams = REF_MODULES["pna"].init_params(rcfg, jax.random.key(0))
    r_answer, r_engine, r_close = ref_make_gnn_server(
        "pna", rcfg, str(tmp_path / "ref"), fanouts=(3, 2), seed=11,
        decode=decode)
    p_answer, p_engine, p_close = port_serve.make_gnn_server(
        "pna", cfg, str(tmp_path / "port"), fanouts=(3, 2), seed=11,
        decode=decode, device=CPU,
        params=gnn_params_from_numpy(_np_tree(rparams), CPU))
    try:
        rng = np.random.default_rng(5)
        for _ in range(2):
            seeds = rng.integers(0, r_engine.n_vertices, 12)
            want, got = r_answer(seeds), p_answer(seeds)
            assert got.shape == want.shape == (12, cfg.n_classes)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    finally:
        r_close()
        p_close()


# ---------------------------------------------------------------------------
# checkpoints of nested params, both directions, bit for bit
# ---------------------------------------------------------------------------

def _mgn_state():
    cfg, rcfg = _cfgs("meshgraphnet")
    rp = REF_MODULES["meshgraphnet"].init_params(rcfg, jax.random.key(2))
    opt = RefAdamWConfig()
    return {"params": rp, "opt": ref_adamw_init(rp, opt)}


def _bits_equal(a, b):
    la = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
          for x in tree_leaves(a)]
    lb = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
          for x in tree_leaves(b)]
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _as_port(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x))
    return conv(tree)


def test_meshgraphnet_checkpoint_restores_across_packages(tmp_path):
    state = _np_tree(_mgn_state())
    assert "l0_w" in state["params"]["edge_mlp1"]          # nested
    ref_ck.save(str(tmp_path / "a"), 4, jax.tree_util.tree_map(
        jnp.asarray, state))
    step, got = ck.restore_latest(str(tmp_path / "a"), _as_port(state))
    assert step == 4
    _bits_equal(got, state)
    ck.save(str(tmp_path / "b"), 6, _as_port(state))
    step, back = ref_ck.restore_latest(
        str(tmp_path / "b"), jax.tree_util.tree_map(jnp.asarray, state))
    assert step == 6
    _bits_equal(_np_tree(back), state)
