"""The port's copies of the four examples (``examples/*_torch.py``) held
to the JAX package's on the CPU, and ``chip_smoke.py``'s ``[examples]``
phase on the CPU with a fault planted in each of its checks.

The JAX examples run as they are, in subprocesses started together
(``tests/_jax_example.py`` records what they print rounded: the per-step
losses of their jitted steps, the params those start from, the stream
and engine stats, the packed bytes); the port's run in this process on
``device="cpu"`` from the JAX example's own initial weights, carried
over by ``repro_torch/convert.py``.  Integers (stats, counters, wire
bytes, file bytes, printed lines that carry no time or loss) are equal;
GCN and LM losses step by step within rtol 1e-5; DIN scores within 1e-5.
"""

from _torch_env import load_chip_smoke  # first: one torch thread
import dataclasses
import filecmp
import functools
import importlib.util
import math
import os
import pathlib
import pickle
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.convert import (din_params_from_numpy,
                                 gcn_params_from_numpy,
                                 transformer_params_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

#: the JAX examples' runs: (file, command line; ``--workdir`` added)
JAX_RUNS = {
    "quickstart": ("quickstart.py", ["--scale", "10"]),
    "gnn": ("train_gnn_from_compbin.py", ["--steps", "10"]),
    "gnn_sampled": ("train_gnn_from_compbin.py",
                    ["--steps", "10", "--sampled"]),
    "din": ("serve_din_requests.py",
            ["--requests", "4", "--batch", "8", "--items", "1000"]),
    "lm": ("train_lm_packed_tokens.py", ["--tiny", "--steps", "10"]),
    "lm_wide": ("train_lm_packed_tokens.py",
                ["--steps", "5", "--batch", "1", "--seq", "256"]),
}
#: runs cut in depth (``tests/_jax_example.py --layers``): lm-100m at its
#: full width (d 640, 10 / 5 heads, 32k vocab, 128-token attention
#: chunks, two of them a 256-token sequence) on 2 of its 12 layers
JAX_LAYERS = {"lm_wide": 2}
#: ``[examples]`` on the CPU: each run of ``chip_smoke.EXAMPLE_RUNS`` at
#: a small size (the tiny LM from its true fan-in long enough for its
#: loss to fall below ln(vocab))
CPU_ARGV = {
    "quickstart": ("--scale", "10"),
    "gnn": ("--steps", "20"),
    "gnn_sampled": ("--sampled", "--steps", "20"),
    "din": ("--items", "1000", "--requests", "4", "--batch", "8"),
    "lm": ("--tiny", "--steps", "20", "--batch", "4", "--seq", "64"),
    "lm_fan_in": ("--tiny", "--steps", "60", "--batch", "4", "--seq", "64"),
}
#: printed lines left out of the line-by-line comparison: times, rates,
#: losses (compared as numbers) and the access policy's reason (worded
#: for the GPU in the port)
TIMED = re.compile(r"ms\b|/s\b|speedup|loss|regime:")


def _with_workdir(name: str, argv: list, workdir) -> list:
    return argv if name == "din" else [*argv, "--workdir", str(workdir)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Every JAX example of ``JAX_RUNS`` run once, all at the same time:
    ``name -> {"stdout", "rec", "workdir"}``."""
    base = tmp_path_factory.mktemp("jax_examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    procs = {}
    for name, (example, argv) in JAX_RUNS.items():
        out = base / f"{name}.pkl"
        depth = (["--layers", str(JAX_LAYERS[name])] if name in JAX_LAYERS
                 else [])
        procs[name] = (out, base / name, subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_example.py"),
             str(out), *depth, str(EXAMPLES / example),
             *_with_workdir(name, argv, base / name)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    runs = {}
    for name, (out, workdir, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        with open(out, "rb") as f:
            runs[name] = {"stdout": stdout, "rec": pickle.load(f),
                          "workdir": workdir}
    return runs


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_port(name: str, argv: list, capsys, params_fn=None,
              layers=None) -> tuple:
    """The port's example ``name`` on the CPU: ``(result, stdout)``;
    ``params_fn(mod, args)`` gives its params; ``layers`` cuts its LM's
    depth."""
    mod = _example(name)
    if layers is not None:
        real_cfg = mod.model_config
        mod.model_config = lambda args: dataclasses.replace(
            real_cfg(args), n_layers=layers)
    args = mod.build_parser().parse_args([*argv, "--device", "cpu"])
    kw = {} if params_fn is None else {"params": params_fn(mod, args)}
    capsys.readouterr()
    r = mod.run(args, device="cpu", **kw)
    return r, capsys.readouterr().out


def _untimed(stdout: str) -> list:
    return [line for line in stdout.splitlines() if not TIMED.search(line)]


def _ints(pattern: str, text: str) -> list:
    return [[int(g.replace(",", "")) for g in m.groups()]
            for m in re.finditer(pattern, text)]


def test_quickstart_matches_the_reference(jax_runs, tmp_path, capsys):
    ref = jax_runs["quickstart"]
    r, out = _run_port("quickstart_torch",
                       _with_workdir("quickstart", JAX_RUNS["quickstart"][1],
                                     tmp_path), capsys)
    assert _untimed(out) == _untimed(ref["stdout"])
    assert [[r["vertices"], r["edges"]]] == _ints(
        r"\|V\|=([\d,]+) \|E\|=([\d,]+)", ref["stdout"])
    fuse = _ints(r"PG-Fuse loaded\+verified in .* underlying_reads=(\d+) "
                 r"hits=(\d+)", ref["stdout"])
    assert [[f["pgfuse"]["underlying_reads"], f["pgfuse"]["hits"]]
            for f in r["formats"].values()] == fuse
    for fmt, f in r["formats"].items():
        jax_file = ref["workdir"] / f"g.{fmt}"
        assert f["bytes_written"] == os.path.getsize(jax_file)
        assert filecmp.cmp(tmp_path / f"g.{fmt}", jax_file, shallow=False)
    assert [[r["async"]["partitions"], r["async"]["edges"]]] == _ints(
        r"async load: (\d+) partitions, ([\d,]+) edges", ref["stdout"])
    (want,) = ref["rec"]["streams"]
    assert {k: r["stream"][k] for k in want} == want
    assert want["partitions"] > 0 and want["host_decode_bytes"] == 0


@pytest.mark.parametrize("name", ["gnn", "gnn_sampled"])
def test_gnn_example_matches_the_reference(jax_runs, tmp_path, capsys, name):
    """10 steps from the JAX example's weights: the losses step by step,
    the host stream stats or the query engine's counters, the graph,
    feature and label files byte for byte."""
    ref = jax_runs[name]
    params = ref["rec"]["first_params"]
    r, out = _run_port(
        "train_gnn_from_compbin_torch",
        _with_workdir(name, JAX_RUNS[name][1], tmp_path), capsys,
        lambda mod, args: gcn_params_from_numpy(params, device="cpu"))
    assert _untimed(out) == _untimed(ref["stdout"])
    want = [float(v) for v in ref["rec"]["outputs"]]
    assert len(want) == 10
    np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
    if name == "gnn":
        assert r["hosts"] == ref["rec"]["hosts"] and len(r["hosts"]) == 2
    else:
        (engine,) = ref["rec"]["engines"]
        assert r["engine"] == engine and engine["batches"] > 0
    for f in ("graph.cbin", "graph_d32.fst", "graph_labels.lbl"):
        assert filecmp.cmp(tmp_path / f, ref["workdir"] / f, shallow=False)


def test_din_example_matches_the_reference(jax_runs, capsys):
    """4 requests of 8 from the JAX example's weights: every request's
    scores within 1e-5, the wire bytes equal."""
    ref = jax_runs["din"]
    params = ref["rec"]["first_params"]
    r, out = _run_port(
        "serve_din_requests_torch", JAX_RUNS["din"][1], capsys,
        lambda mod, args: din_params_from_numpy(params, device="cpu"))
    assert _untimed(out) == _untimed(ref["stdout"])
    want = ref["rec"]["outputs"]
    assert len(r["scores"]) == len(want) == 4
    for got, w in zip(r["scores"], want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
    assert r["wire_bytes"] == ref["rec"]["encoded_bytes"] == 4 * 8 * 101 * 2


@pytest.mark.parametrize("name", ["lm", "lm_wide"])
def test_lm_example_matches_the_reference(jax_runs, tmp_path, capsys, name):
    """From the JAX example's weights: the losses step by step, the token
    shard byte for byte, the PG-Fuse counters.  ``lm``: 10 steps of the
    tiny LM; ``lm_wide``: lm-100m at its full width on 2 of its layers
    (as the JAX package draws it, its attention saturated from the first
    step), 5 steps of one 256-token sequence through two 128-token
    attention chunks."""
    ref = jax_runs[name]
    params = ref["rec"]["first_params"]
    argv = JAX_RUNS[name][1]
    r, out = _run_port(
        "train_lm_packed_tokens_torch", _with_workdir(name, argv, tmp_path),
        capsys, lambda mod, args: transformer_params_from_numpy(
            params, mod.model_config(args), device="cpu"),
        layers=JAX_LAYERS.get(name))
    assert _untimed(out) == _untimed(ref["stdout"])
    want = [float(v) for v in ref["rec"]["outputs"]]
    assert len(want) == int(argv[argv.index("--steps") + 1])
    np.testing.assert_allclose(r["losses"], want, rtol=1e-5)
    shard = f"corpus_{r['vocab']}.ctok"
    assert filecmp.cmp(tmp_path / shard, ref["workdir"] / shard,
                       shallow=False)
    assert [[r["pgfuse"]["underlying_reads"], r["pgfuse"]["cache_hits"]]] \
        == _ints(r"PG-Fuse: (\d+) underlying reads / ([\d,]+) hits",
                 ref["stdout"])


@pytest.mark.parametrize("name", ["quickstart", "train_gnn_from_compbin",
                                  "serve_din_requests",
                                  "train_lm_packed_tokens"])
def test_examples_take_the_reference_flags_and_the_device(name, tmp_path):
    """The JAX example's flags and ``--device``, no other; without a card
    ``main`` raises before any work unless the CPU is asked for."""
    mod = _example(f"{name}_torch")
    ours = {s for s in mod.build_parser()._option_string_actions
            if s not in ("-h", "--help")}
    theirs = set(re.findall(r"add_argument\(\"(--[\w-]+)\"",
                            (EXAMPLES / f"{name}.py").read_text()))
    assert theirs and ours == theirs | {"--device"}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--workdir", str(tmp_path / "never")]
                 if "--workdir" in ours else [])
    assert not (tmp_path / "never").exists()


# ---------------------------------------------------------------------------
# chip_smoke.py's [examples] on the CPU, and its checks with faults planted
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    return load_chip_smoke()


def _runs(smoke, *labels) -> tuple:
    """``chip_smoke.EXAMPLE_RUNS`` at ``CPU_ARGV``'s sizes (``labels``
    only, if given)."""
    return tuple(run._replace(argv=CPU_ARGV[run.label])
                 for run in smoke.EXAMPLE_RUNS if run.label in CPU_ARGV
                 and (not labels or run.label in labels))


def _phase(smoke, tmp_path, *labels):
    runs = _runs(smoke, *labels)
    return smoke.phase_examples("cpu", str(tmp_path), runs=runs)


def test_examples_phase_on_cpu(smoke, tmp_path):
    """Every run, no kernel launched on the CPU, the checks' numbers."""
    r = _phase(smoke, tmp_path)
    runs = r["runs"]
    assert list(runs) == [run.label for run in _runs(smoke)]
    assert r["main_launches"] == {"k1": 0, "k2": 0, "k2_grad": 0, "k3": 0}
    assert runs["quickstart"]["stream"]["partitions"] > 0
    for label in ("gnn", "gnn_sampled"):
        c = runs[label]["checks"]
        assert c["parity"]["loss_rel_err"] == 0.0
        assert c["parity"]["printed_loss_rel_err"] == 0.0
        assert c["last_mean"] < c["first_mean"]
        ids, n, d = c["k2_case"]
        assert ids.dtype == torch.int32 and d == 32 and n > 0
    assert runs["din"]["checks"] == {"max_abs_err": 0.0, "rows_checked": 8}
    for label in ("lm", "lm_fan_in"):
        c = runs[label]["checks"]
        assert c["f64"]["printed_loss_rel_err"] <= smoke.TRAIN_LOSS_RTOL
        assert max(c["f64"]["grad_share"].values()) \
            <= smoke.LM_F64_GRAD_SHARE
        assert len(c["attention"]["score_std"]) == 2
        assert runs[label]["workdir_bytes"] > 0
    fan_in = runs["lm_fan_in"]["checks"]
    assert fan_in["last_mean"] < fan_in["ln_vocab"]
    assert fan_in["last_mean"] < fan_in["first_mean"]
    # the example's own draw starts its attention several times as
    # saturated as the true fan-in does
    assert min(runs["lm"]["checks"]["attention"]["score_std"]) > \
        2 * max(fan_in["attention"]["score_std"])
    for run in _runs(smoke):
        x = dict(runs[run.label], checks={
            k: v for k, v in runs[run.label]["checks"].items()
            if k != "k2_case"})
        smoke.log_example(run, x)


def test_attention_saturation_reads_the_scores(smoke):
    """The score std and top weight by layer, against the scores worked
    out by hand on one layer; the true fan-in's scores near unit std."""
    from repro_torch.models import transformer as tf

    cfg = tf.TransformerConfig(
        name="t", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, vocab=256, dtype=torch.float32,
        tie_embeddings=True, rope_pct=0.0)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (2, 32)))
    got = smoke.attention_saturation(params, tokens, cfg)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = params["embed"][tokens]
    h = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
        * lp["attn_norm_scale"]
    q = torch.einsum("bsd,dhk->bshk", h, lp["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, lp["wk"]).repeat_interleave(2, 2)
    s = torch.einsum("bshk,bthk->bhst", q, k) / 4
    mask = torch.ones(32, 32, dtype=torch.bool).tril()
    np.testing.assert_allclose(got["score_std"], [float(s[..., mask].std())],
                               rtol=1e-5)
    top = s.masked_fill(~mask, -math.inf).softmax(-1).amax(-1).mean()
    np.testing.assert_allclose(got["max_weight"], [float(top)], rtol=1e-5)
    args = types.SimpleNamespace(tiny=True)
    mod = types.SimpleNamespace(model_config=lambda a: cfg, tf=tf)
    fan = smoke.attention_saturation(
        smoke.fan_in_params(mod, args, "cpu"), tokens, cfg)
    assert 0.5 < fan["score_std"][0] < 2 < got["score_std"][0]


def test_streamed_csr_check_detects_a_dropped_edge(smoke, tmp_path,
                                                   monkeypatch):
    """The quickstart's own check: its streamed CSR with one edge lost."""
    import repro_torch.data
    from repro_torch.convert import csr_from_numpy

    real = repro_torch.data.assemble_csr

    def dropping(shards):
        csr = real(shards)
        offsets = csr.offsets.copy()
        offsets[-1] -= 1
        return csr_from_numpy(offsets, csr.neighbors[:-1])

    monkeypatch.setattr(repro_torch.data, "assemble_csr", dropping)
    with pytest.raises(AssertionError, match="streamed graph differs"):
        _phase(smoke, tmp_path, "quickstart")


def _run_of(smoke, label):
    (run,) = [r for r in smoke.EXAMPLE_RUNS if r.label == label]
    return run


def test_launch_check_detects_a_missing_launch(smoke, monkeypatch):
    """K1 once a streamed partition on the card, K2 and its backward as
    the run's requests ask (here those of one step of the GNN example's
    model, counted on CPU tensors with the device check made true): a
    run a launch short fails."""
    from repro_torch.graph import rmat
    from repro_torch.launch.data_gnn import full_graph_batch
    from repro_torch.models.gnn import gcn

    none = smoke.KernelRequests()
    qs_run = _run_of(smoke, "quickstart_compbin")
    qs = {"stream": {"partitions": 9}}
    want = smoke.example_launches(qs_run, None, qs, {}, True, none)
    assert want == {"k1": 9, "k2": 0, "k2_grad": 0, "k3": 0}
    assert smoke.example_launches(qs_run, None, qs, {}, False,
                                  none)["k1"] == 0
    smoke.check_example_launches("quickstart", dict(want), want)
    with pytest.raises(AssertionError, match="kernel launches"):
        smoke.check_example_launches("quickstart", dict(want, k1=8), want)
    cfg = _example("train_gnn_from_compbin_torch").CONFIG
    batch = full_graph_batch("gcn-cora", cfg, rmat(6, 4, seed=1),
                             np.random.default_rng(0), device="cpu")
    params = gcn.init_params(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(smoke, "_on_card", lambda t: True)
    with smoke.kernel_requests() as asked:
        smoke.loss_and_grads(lambda p: gcn.loss_fn(p, batch, cfg), params)
    args = types.SimpleNamespace(steps=60, sampled=False)
    r = {"hosts": [{"partitions": 9}, {"partitions": 8}]}
    want = smoke.example_launches(_run_of(smoke, "gnn"), args, r, {}, True,
                                  asked)
    assert want == {"k1": 17, **asked.launches(), "k3": 0}
    assert want["k2"] > 0 and want["k2_grad"] > 0
    with pytest.raises(AssertionError, match="kernel launches"):
        smoke.check_example_launches("gnn", dict(want, k2_grad=0), want)
    for label in ("din", "lm", "lm_fan_in"):
        assert smoke.example_launches(_run_of(smoke, label), None, {}, {},
                                      True, none) == dict(
            want, k1=0, k2=0, k2_grad=0)


def test_gnn_parity_check_detects_a_dropped_edge(smoke, tmp_path,
                                                 monkeypatch):
    """The kernel path losing one edge (the plain path keeps it) must fail
    the first-step comparison."""
    from repro_torch.kernels.segment_sum import segment_sum_ref
    from repro_torch.models.gnn import layers

    def dropping(msgs, ids, n):
        ids = ids.clone()
        ids[-1] = -1
        return segment_sum_ref(msgs, ids, n)

    monkeypatch.setattr(layers, "segment_sum", dropping)
    with pytest.raises(AssertionError, match="first-step"):
        _phase(smoke, tmp_path, "gnn")


def test_loss_checks_detect_losses_that_do_not_fall(smoke):
    falling = [2.0 - 0.01 * i for i in range(30)]
    assert smoke.check_losses_fall("gnn", falling, 10)["last_mean"] < 2
    with pytest.raises(AssertionError, match="does not fall"):
        smoke.check_losses_fall("gnn", [2.0] * 30, 10)
    with pytest.raises(AssertionError, match="not all finite"):
        smoke.check_losses_fall("gnn", falling[:-1] + [float("nan")], 10)
    vocab = 2048                                   # ln 2048 = 7.62
    smoke.check_lm_learns([8.0 - 0.1 * i for i in range(40)], vocab, 20)
    with pytest.raises(AssertionError, match="not below ln"):
        smoke.check_lm_learns([8.0 - 0.01 * i for i in range(40)], vocab, 20)


def _faulty_run(smoke, monkeypatch, name, change):
    """``[examples]`` loading example ``name`` with ``change`` applied to
    what its ``run`` returns."""
    real = smoke.load_example

    def load(n):
        mod = real(n)
        if n == name:
            mod.run = lambda *a, _run=mod.run, **kw: change(_run(*a, **kw))
        return mod

    monkeypatch.setattr(smoke, "load_example", load)


def _shift(key, index, by, r):
    r[key][index] = r[key][index] + by
    return r


def test_first_loss_check_detects_a_planted_fault(smoke, tmp_path,
                                                  monkeypatch):
    """The LM example's printed first loss 1e-4 of itself off float64's
    (the run from its true fan-in, where the check is asserted)."""
    _faulty_run(smoke, monkeypatch, "train_lm_packed_tokens_torch.py",
                lambda r: _shift("losses", 0, r["losses"][0] * 1e-4, r))
    with pytest.raises(AssertionError, match="first-step loss"):
        _phase(smoke, tmp_path, "lm_fan_in")
    with pytest.raises(AssertionError, match="first-step loss"):
        smoke.check_first_loss("gnn", 2.0794 * (1 + 2e-5), 2.0794)


def test_lm_parity_check_detects_a_planted_fault(smoke, tmp_path,
                                                monkeypatch):
    """A gradient fault in f32 only that leaves every loss as it was:
    1e-3 added to each element of wq's gradient; the first step's
    gradients against float64 fail."""
    from repro_torch.models import transformer as tf
    real = tf.loss_fn

    def off(p, tokens, labels, cfg):
        loss = real(p, tokens, labels, cfg)
        if cfg.dtype != torch.float32:
            return loss
        wq = p["layers"]["wq"]
        return loss + 1e-3 * (wq - wq.detach()).sum()

    monkeypatch.setattr(tf, "loss_fn", off)
    with pytest.raises(AssertionError, match="first-step grad layers/wq"):
        _phase(smoke, tmp_path, "lm_fan_in")


def test_lm_finite_check_detects_a_planted_fault(smoke, tmp_path,
                                                 monkeypatch):
    """A NaN among the LM example's losses fails its run, where the claim
    is only reported too."""
    _faulty_run(smoke, monkeypatch, "train_lm_packed_tokens_torch.py",
                lambda r: _shift("losses", -1, float("nan"), r))
    with pytest.raises(AssertionError, match="non-finite loss"):
        _phase(smoke, tmp_path, "lm")


def test_lm_learning_check_detects_a_planted_fault(smoke, tmp_path,
                                                   monkeypatch):
    """The LM from its true fan-in with its last losses put back at its
    first: the printed claim fails."""
    def flat(r):
        r["losses"][-20:] = r["losses"][:20]
        return r

    _faulty_run(smoke, monkeypatch, "train_lm_packed_tokens_torch.py", flat)
    with pytest.raises(AssertionError, match="does not fall"):
        _phase(smoke, tmp_path, "lm_fan_in")


def test_din_scores_check_detects_a_planted_fault(smoke, tmp_path,
                                                  monkeypatch):
    """The first request's scores 1e-3 off the plain CPU path's."""
    _faulty_run(smoke, monkeypatch, "serve_din_requests_torch.py",
                functools.partial(_shift, "scores", 0, 1e-3))
    with pytest.raises(AssertionError, match="request 0: max abs err"):
        _phase(smoke, tmp_path, "din")
