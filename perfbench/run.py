"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m perfbench.run ...``) from the root of a checkout.  The
cell names a configuration (``perfbench/configs/<config>.json``) and a
traffic mix (``perfbench/traffic/<mix>.json``, whose ``driver`` names
the module under ``perfbench/drivers/`` that runs it); each per-layer
metric is read by ``perfbench/metrics/<metric>.py``.  Adding a cell,
configuration or metric adds files and entries and edits none.

A run sets up (draws its inputs on the card from ``--seed``, warms up
every shape the cell uses, builds the kernels into ``build/`` inside
the checkout on the first run there), measures for ``--seconds``, then
holds what the window produced to the plain reference.  Its last line
on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: every compared number beside its limit, which are
also the last lines on standard error).  With ``--trace 0`` the metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of the window.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; it exits 3 if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    """The checkout's root (this package) and ``src`` (the program) on
    ``sys.path``; every build and kernel cache at a fixed path in the
    checkout."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    caches = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(bench: dict, workload: str, root: Path = ROOT,
               updates: dict | None = None) -> tuple:
    """(workload entry, configuration, traffic mix) of ``workload``;
    ``updates`` (``{"config": {...}, "traffic": {...}}``) replaces keys
    of either, for a rehearsal at a small size."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(root / conf["file"]) as f:
        cfg = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    updates = updates or {}
    cfg.update(updates.get("config", {}))
    traffic.update(updates.get("traffic", {}))
    return wl, cfg, traffic


def _applies(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports ``metric``: every cell, unless the
    metric lists its cells (a reader that finds nothing returns None)."""
    return workload in metric.get("workloads", [workload])


def reader(name: str, root: Path = ROOT):
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def _number(v):
    v = float(v)
    return v if math.isfinite(v) else None


def _passes(value, limit, op="<=") -> bool:
    return value <= limit if op == "<=" else value >= limit


def correct(checks: dict) -> bool:
    """Whether every compared number of ``checks`` (``{name: (value,
    limit[, op])}``, as a cell's ``check`` gives them) is within its
    limit."""
    return all(_passes(*c) for c in checks.values())


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device, *, t_start: float | None = None,
            root: Path = ROOT, updates: dict | None = None) -> dict:
    """One run of ``workload`` on ``device``: set-up, the window, the
    check.  Returns the result object (no check for a card here)."""
    import torch

    from perfbench.gen import devtrace

    wl, cfg, traffic = cell_files(bench, workload, root, updates)
    on_gpu = torch.device(device).type == "cuda"
    t_start = _T_START if t_start is None else t_start
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, seed, device, trace)
    try:
        if on_gpu:
            torch.cuda.synchronize(device)
            # the peak of the window: the inputs' generation is not the
            # deployment's footprint
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        print(f"setup {setup_s:.3f} s", file=sys.stderr)
        if trace:
            e2e, tr = devtrace.profile_window(lambda: cell.run(seconds))
        else:
            e2e, tr = cell.run(seconds), None
        peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
        ctx = SimpleNamespace(trace=tr, counters=cell.context()
                              if trace else {})
        cell.release()
        checks = cell.check()
    finally:
        cell.close()

    e2e = dict(e2e, setup_s=setup_s)
    reported = [m["name"] for m in bench["end_to_end"]
                if _applies(m, workload)]
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": _number(e2e[m["name"]]),
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if _applies(m, workload):
                v = reader(m["name"], root)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": _number(v),
                                          "unit": m["unit"]}
    dev = {"platform": "gpu" if on_gpu else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct(checks),
           "attempted": int(cell.attempted), "failed": int(cell.failed),
           "metrics": metrics, "device": dev}
    if on_gpu:
        dev["power_limit"] = _power_limit()
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": _number(c[0]), "limit": c[1],
                         **({"at_least": True} if c[2:] == (">=",) else {})}
                     for k, c in checks.items()}
    return out


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()
    bench = load_benchmark()
    wl = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    print(f"setup: imports and CUDA context in "
          f"{time.perf_counter() - _T_START:.3f} s", file=sys.stderr)
    out = execute(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace), device)
    banned = banned_modules()
    if banned:
        print(f"loaded in this run: {', '.join(banned)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {k}: {c['value']!r} {rel} {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
