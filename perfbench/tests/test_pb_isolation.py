"""What a run may load, and where it refuses to run."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"

_IMPORT_ALL = """
import importlib, json, sys, pathlib
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import run, control
run._setup_paths()
bench = run.load_benchmark()
for w in bench["workloads"]:
    _, _, traffic = run.cell_files(bench, w["name"])
    importlib.import_module("perfbench.drivers." + traffic["driver"])
for m in bench["per_layer"]:
    run.reader(m["name"])
import repro_torch.core.paragrapher, repro_torch.data, repro_torch.query
import repro_torch.launch.steps, repro_torch.launch.mesh
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_nothing_the_run_imports_is_jax_or_the_jax_package():
    mods = _modules(_IMPORT_ALL.format(root=str(ROOT), src=str(ROOT / "src")))
    top = {m.split(".")[0] for m in mods}
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, \
        sorted(top & {"jax", "jaxlib", "flax", "repro"})


def test_the_reference_imports_nothing_of_the_program():
    code = ("import json, sys; sys.path[:0] = [%r]\n"
            "import perfbench.reference.csr, perfbench.reference.gcn\n"
            "print(json.dumps(sorted(sys.modules)))" % str(ROOT))
    top = {m.split(".")[0] for m in _modules(code)}
    assert not top & {"repro_torch", "repro", "jax"}
    for f in (PB / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math",
                                           "statistics", "types",
                                           "__future__"}, (f.name, n)


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "load.g500-24",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(ROOT)
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA device" in r.stderr


def test_a_run_with_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_the_benchmark_file_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
