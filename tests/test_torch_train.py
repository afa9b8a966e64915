"""The port's training entry point (``repro_torch.launch.train``) against
the JAX package's (``repro.launch.train``) on the same assets, on the
CPU.

Batches (edge index, labels, masks, feature rows): equal tensor for
tensor.  Steps: the port's eager step and the reference's jitted step
from the same weights and optimizer state, losses within rtol 1e-5 step
by step for 15 steps, params within rtol 1e-4 / atol 1e-6 at the end
(f32 both sides, sums in another order).  Restart: an injected failure
plus restore ends bit-equal to an uninjected run (CPU, deterministic)."""

import logging

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.configs import get_arch as ref_get_arch
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_arch
from repro_torch.convert import (adamw_state_from_numpy,
                                 gcn_params_from_numpy)
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig

CPU = "cpu"
ARCH = "gcn-cora"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_batch_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), k)


@pytest.fixture(scope="module")
def cfgs():
    return (get_arch(ARCH).make_reduced(), ref_get_arch(ARCH).make_reduced())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One asset triplet (rmat(10, 8), the training CLI's default) for the
    whole module."""
    return str(tmp_path_factory.mktemp("train"))


def test_full_graph_batch_equals_the_reference(workdir, cfgs):
    cfg, rcfg = cfgs
    got = train._gnn_full_graph_batches(ARCH, cfg, workdir, True, 2,
                                        device=CPU)
    want = ref_train._gnn_full_graph_batches(ARCH, rcfg, workdir, True, 2)
    assert len(got.results) == 2
    _assert_batch_equal(next(got), next(want))
    assert next(got) is got.batch


def test_sampled_batches_equal_the_reference(workdir, cfgs):
    cfg, rcfg = cfgs
    got = train._gnn_sampled_batches(ARCH, cfg, workdir, True, device=CPU)
    want = ref_train._gnn_sampled_batches(ARCH, rcfg, workdir, True)
    try:
        for _ in range(4):
            _assert_batch_equal(next(got), next(want))
        assert got.engine.stats.batches > 0
    finally:
        got.close()


def test_minibatches_equal_the_reference(workdir, cfgs):
    cfg, rcfg = cfgs
    got = train._gnn_batches(ARCH, cfg, workdir, True, device=CPU)
    want = ref_train._gnn_batches(ARCH, rcfg, workdir, True)
    try:
        for _ in range(3):
            _assert_batch_equal(next(got), next(want))
    finally:
        got.close()


def _ref_state(rcfg, opt_kw):
    """The JAX package's initial train state, and the port's copy of it."""
    rinit, rstep = ref_train._make_step(ARCH, rcfg, RefAdamWConfig(**opt_kw),
                                        "gnn", False)
    rparams = rinit(jax.random.key(0))
    rstate = {"params": rparams,
              "opt": ref_adamw_init(rparams, RefAdamWConfig(**opt_kw))}
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = {"params": gcn_params_from_numpy(tonp(rparams), device=CPU),
             "opt": adamw_state_from_numpy(tonp(rstate["opt"]), device=CPU)}
    return rstate, rstep, state


@pytest.mark.parametrize("mode", ["full_graph", "sampled"])
def test_steps_match_the_reference(workdir, cfgs, mode):
    """15 steps of the CLI's step on the CLI's batches, from the JAX
    package's weights and optimizer state."""
    cfg, rcfg = cfgs
    opt_kw = dict(lr=1e-3, warmup_steps=10, total_steps=15, master_f32=True)
    rstate, rstep, state = _ref_state(rcfg, opt_kw)
    _, step = train._make_step(ARCH, cfg, AdamWConfig(**opt_kw), "gnn",
                               device=CPU)
    if mode == "full_graph":
        got = train._gnn_full_graph_batches(ARCH, cfg, workdir, True, 2,
                                            device=CPU)
        want = ref_train._gnn_full_graph_batches(ARCH, rcfg, workdir, True,
                                                 2)
    else:
        got = train._gnn_sampled_batches(ARCH, cfg, workdir, True,
                                         device=CPU)
        want = ref_train._gnn_sampled_batches(ARCH, rcfg, workdir, True)
    losses, ref_losses = [], []
    try:
        for _ in range(15):
            state, met = step(state, next(got))
            rstate, rmet = rstep(rstate, next(want))
            losses.append(float(met["loss"]))
            ref_losses.append(float(rmet["loss"]))
            np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                                       rtol=1e-6)
    finally:
        got.close()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert int(state["opt"]["step"]) == 15
    for k, v in state["params"].items():
        np.testing.assert_allclose(_np(v), np.asarray(rstate["params"][k]),
                                   rtol=1e-4, atol=1e-6)
    if mode == "full_graph":
        assert losses[-1] < losses[0], losses


@pytest.fixture
def one_thread():
    """One intra-op thread: a CPU GEMM's sum order then no longer depends
    on how many threads the BLAS picks under load, so two runs of the
    same steps agree bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_cli_trains_full_graph_on_two_hosts_and_restarts(tmp_path, workdir,
                                                          caplog, one_thread):
    """``--full-graph --hosts 2`` ends with the reference's ``done:``
    line and a falling loss; an injected failure restored from a
    checkpoint ends bit-equal to the uninjected run."""
    caplog.set_level(logging.INFO, logger="repro_torch.train")
    argv = ["--arch", ARCH, "--reduced", "--device", CPU, "--full-graph",
            "--hosts", "2", "--steps", "12", "--workdir", workdir,
            "--ckpt-every", "4"]
    train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done: first-10 mean loss")]
    assert len(done) == 1 and " -> last-10 mean loss " in done[0]
    kw = dict(steps=12, reduced=True, device=CPU, full_graph=True, hosts=2,
              ckpt_every=4, workdir=workdir)
    clean = train.train(ARCH, ckpt_dir=str(tmp_path / "b"), **kw)
    hurt = train.train(ARCH, ckpt_dir=str(tmp_path / "c"),
                       inject_failure_at=6, **kw)
    assert clean["losses"][-1] < clean["losses"][0]
    assert len(hurt["losses"]) == 12 + 2          # steps 4, 5 re-run
    assert hurt["losses"][4:6] == clean["losses"][4:6]
    for k, v in clean["state"]["params"].items():
        assert torch.equal(hurt["state"]["params"][k], v), k
    assert torch.equal(hurt["state"]["opt"]["step"],
                       clean["state"]["opt"]["step"])


def test_cli_sampled_and_minibatch_modes_run(tmp_path, workdir):
    for extra in (["--sampled"], []):
        out = train.train(ARCH, steps=3, reduced=True, device=CPU,
                          sampled=bool(extra), workdir=workdir,
                          ckpt_dir=str(tmp_path / f"ck{len(extra)}"))
        assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("argv,match", [
    (["--arch", "smollm-360m", "--compress-grads"],
     "--compress-grads is not ported yet"),
    (["--arch", "gcn-cora", "--compress-grads"],
     "--compress-grads is not ported yet"),
    (["--arch", "din"], "not ported yet"),
    (["--arch", "gcn-cora", "--full-graph", "--sampled"],
     "mutually exclusive"),
])
def test_unported_paths_exit_saying_so(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", CPU, "--reduced", "--workdir",
                           str(tmp_path)])


def test_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", ARCH, "--reduced", "--steps", "1",
                    "--workdir", str(tmp_path)])
