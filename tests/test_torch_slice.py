"""The slice as a whole at small size: the load, serve and LogCSR phases
of ``chip_smoke.py`` run here with ``device="cpu"`` at scale 10, so what
the GPU run drives is what these tests ran.  Each phase checks the loaded
CSR and every query answer against the generated graph bit for bit
(tolerance ZERO) and raises on any difference."""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    path_before = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path_before
    return mod


@pytest.fixture(scope="module")
def small(smoke, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("slice"))
    csr, path, _, _ = smoke.make_graph(10, workdir)
    return csr, path, workdir


def test_load_phase_on_cpu(smoke, small):
    csr, path, _ = small
    out = smoke.phase_load(csr, path, "cpu")
    assert out["edges"] == csr.n_edges and out["vertices"] == csr.n_vertices
    assert out["partitions"] > 1 and out["bytes_h2d"] > 0
    assert out["launches"] == 0          # a CPU tensor never launches
    assert out["b"] == 2 and out["max_partition_ids"] >= 1024


def test_serve_phase_on_cpu(smoke, small):
    csr, path, _ = small
    out = smoke.phase_serve(csr, path, "cpu", n_batches=4, batch=256)
    assert out["device_batches"] == out["batches"] >= 5
    assert out["bytes_h2d"] > 0 and out["ids_checked"] > 0
    assert out["auto_batches"] == 4 and out["launches"] == 0
    assert out["p50_s"] <= out["p99_s"]


def test_logcsr_phase_on_cpu(smoke, small):
    _, _, workdir = small
    out = smoke.phase_logcsr("cpu", 10, workdir, n_batches=2, batch=128)
    assert out["load"]["edges"] > 0 and out["serve"]["ids_checked"] > 0


def test_load_phase_detects_a_wrong_graph(smoke, small):
    csr, path, _ = small
    wrong = type(csr)(offsets=csr.offsets.copy(),
                      neighbors=csr.neighbors.copy())
    wrong.neighbors[7] ^= 1
    with pytest.raises(AssertionError, match="neighbors differ"):
        smoke.phase_load(wrong, path, "cpu")
    with pytest.raises(AssertionError):
        smoke.phase_serve(wrong, path, "cpu", n_batches=8, batch=1024,
                          n_async=0, n_auto=0)


def test_bound_and_library_yardsticks(smoke):
    ms, by = smoke.bound_ms(1 << 28, 3)
    assert by == "bytes"
    assert ms == pytest.approx((1 << 28) * 7 / 3.35e12 * 1e3)
    assert smoke.library_call(3) is None and smoke.library_call(2) is None
    p = torch.arange(16, dtype=torch.uint8)
    np.testing.assert_array_equal(
        smoke.library_call(4)(p).numpy(),
        smoke.compbin_decode_ref(p, 4).numpy())
    np.testing.assert_array_equal(
        smoke.library_call(1)(p).numpy(),
        smoke.compbin_decode_ref(p, 1).numpy())


def test_main_refuses_to_run_without_a_gpu(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal path is not "
                    "reachable")
    assert smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
