"""Dry run: build and abstractly trace every (arch x shape x mesh) cell.

The JAX package lowers and compiles each cell for a TPU pod on 512
placeholder host devices.  The port has no placeholder devices and no
SPMD partitioner; per mesh:

  * ``card`` (the default): the 1x1 mesh of one H100.  The cell's step is
    traced under fake tensors (:func:`repro_torch.launch.steps._abstract`)
    with a :class:`~repro_torch.launch.hlo_analysis.CostMode` -- the
    counterpart of ``lower().compile()`` with ``cost_analysis()`` and
    ``memory_analysis()`` -- and the record gets the counted FLOPs,
    bytes, peak-memory estimate and :func:`roofline` terms on the card's
    peaks.  Serving cells are traced a second time with the attention
    holding only what the flash-attention kernel holds, for the card
    path's peak (``memory.card_peak_est_bytes``);
  * ``single`` / ``multi``: the 16x16 / 2x16x16 production meshes.  The
    record checks that every sharded argument dim divides its axes (the
    rule ``jit`` enforces on arguments) and gives the per-device
    argument bytes from the local shapes; ``cost`` is null, with the
    reason: the pod program exists only in the JAX package.

Usage:
    python -m repro_torch.launch.dryrun --arch gcn-cora --shape full_graph_sm
    python -m repro_torch.launch.dryrun --all --mesh card --out results/dryrun.json

A cell whose trace raises is ``FAIL``, one still tracing after
``--timeout`` seconds ``TIMEOUT``; the five ``long_500k`` cells are
``SKIP`` with the JAX package's reason.  ``--all`` traces the cells with
:func:`run_cells` (``--jobs`` spawned processes, or this one) and merges
each record into ``--out`` as it arrives.  The JAX package starts a
subprocess a cell, for its 512 placeholder devices and XLA's compiles; a
fake trace runs Python only.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import traceback

from repro_torch.launch.hlo_analysis import _nbytes

MESH_TAGS = {"card": "1x1", "single": "16x16", "multi": "2x16x16"}
POD_COST_REASON = ("the pod program exists only in the JAX package: the "
                   "port has no SPMD partitioner, so only the arguments' "
                   "divisibility and local shapes are checked on this mesh")


def _mesh(mesh_name: str):
    from repro_torch.launch.mesh import card_mesh, make_production_mesh
    if mesh_name == "card":
        return card_mesh()
    return make_production_mesh(multi_pod=mesh_name == "multi")


def _placement_leaves(tree) -> list:
    """Placement tuples of a ``named`` tree, in sorted-key order."""
    from torch.distributed.tensor.placement_types import Placement
    if isinstance(tree, tuple) and tree and \
            all(isinstance(p, Placement) for p in tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _placement_leaves(t)]
    return [tree]


def leaf_shapes(tree) -> list:
    """``[[shape...], dtype]`` of every tensor of ``tree``, in sorted-key
    order: what a record keeps of a trace's outputs."""
    import torch

    from repro_torch.optim.adamw import tree_leaves
    return [[list(t.shape), str(t.dtype).split(".")[-1]]
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def shard_check(cell, mesh) -> dict:
    """Every argument dim sharded by ``cell.in_shardings`` divides the
    product of its mesh axes; the per-device argument bytes from the
    local shapes."""
    import torch
    from torch.distributed.tensor.placement_types import Shard

    from repro_torch.optim.adamw import tree_leaves
    args = [t for t in tree_leaves(cell.args) if isinstance(t, torch.Tensor)]
    places = _placement_leaves(cell.in_shardings)
    if len(args) != len(places):
        raise ValueError(f"{len(args)} arguments vs {len(places)} "
                         f"placements")
    bad, local_bytes, sharded = [], 0, 0
    for i, (t, pl) in enumerate(zip(args, places)):
        split = [1] * t.ndim
        for j, p in enumerate(pl):
            if isinstance(p, Shard):
                split[p.dim] *= mesh.axis_sizes[j]
        local = 1
        for d, (n, k) in enumerate(zip(t.shape, split)):
            if k > 1:
                sharded += 1
                if n % k:
                    bad.append({"arg": i, "dim": d, "size": int(n),
                                "shards": k})
            local *= -(-n // k)
        local_bytes += local * t.element_size()
    return {"args": len(args), "sharded_dims": sharded, "indivisible": bad,
            "argument_bytes": sum(map(_nbytes, args)),
            "per_device_argument_bytes": local_bytes}


def trace_cell(cell, *, card: bool = False) -> dict:
    """``cell.fn`` traced on its abstract args under a ``CostMode``:
    ``{"out": fake outputs, "cost": CostMode, "argument_bytes",
    "output_bytes", "trace_s"}``."""
    import torch

    from repro_torch.launch.hlo_analysis import CostMode
    from repro_torch.launch.steps import _abstract, _attention_footprint
    from repro_torch.optim.adamw import tree_leaves

    cm = CostMode()
    t0 = time.perf_counter()
    out = _abstract(cell.fn, *cell.args, mode=cm,
                    **({"attend": _attention_footprint} if card else {}))
    dt = time.perf_counter() - t0
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    args = [t for t in tree_leaves(cell.args) if isinstance(t, torch.Tensor)]
    return {"out": out, "cost": cm, "trace_s": dt,
            "argument_bytes": sum(map(_nbytes, args)),
            "output_bytes": sum(map(_nbytes, outs))}


def run_cell(arch: str, shape: str, mesh_name: str = "card",
             variant: str = "baseline", build_kw: dict | None = None) -> dict:
    """The dry-run record of one cell on ``mesh_name`` (``card``,
    ``single`` or ``multi``), built with ``build_kw`` over the variant's
    arguments."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.hlo_analysis import (CollectiveStats,
                                                 roofline)
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.variants import apply_variant

    mesh = _mesh(mesh_name)
    rec = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": mesh.tag, "n_devices": int(mesh.size),
        "family": get_arch(arch).family,
    }
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, unroll=mesh_name != "multi",
                      **{**apply_variant(arch, shape, variant),
                         **(build_kw or {})})
    build_s = time.perf_counter() - t0
    if cell.skip_reason:
        rec.update(status="SKIP", skip_reason=cell.skip_reason)
        return rec
    rec.update(kind=cell.kind, build_s=build_s,
               model_flops=cell.model_flops)
    if mesh_name != "card":
        chk = shard_check(cell, mesh)
        rec.update(trace_s=build_s, sharding=chk, cost=None,
                   cost_reason=POD_COST_REASON, roofline=None, memory={
                       "argument_bytes": chk["argument_bytes"],
                       "per_device_argument_bytes":
                           chk["per_device_argument_bytes"]})
        if chk["indivisible"]:
            rec.update(status="FAIL", error=(
                f"argument dims do not divide their mesh axes: "
                f"{chk['indivisible']}"))
        else:
            rec["status"] = "OK"
        return rec

    tr = trace_cell(cell)
    cm = tr["cost"]
    peak = tr["argument_bytes"] + cm.peak_live
    card_peak = peak
    if cell.kind in ("prefill", "decode"):
        card_peak = tr["argument_bytes"] + trace_cell(
            cell, card=True)["cost"].peak_live
    coll = CollectiveStats(ops={}, logical_bytes={}, wire_bytes=0.0)
    rl = roofline(cm.cost(), coll, mesh.size, cell.model_flops,
                  cell.compute_dtype)
    rec.update(
        status="OK", trace_s=tr["trace_s"], kernels_counted_as="plain",
        memory={
            "argument_bytes": tr["argument_bytes"],
            "output_bytes": tr["output_bytes"],
            "temp_bytes": max(0, cm.peak_live - tr["output_bytes"]),
            "alias_bytes": None,
            "peak_est_bytes": peak,
            "card_peak_est_bytes": card_peak,
        },
        cost={"flops": cm.flops, "bytes_accessed": cm.bytes_accessed,
              "transcendentals": cm.transcendentals,
              "matmul_flops": cm.matmul_flops,
              "elementwise_flops": cm.elementwise_flops},
        collectives={"ops": coll.ops, "logical_bytes": coll.logical_bytes,
                     "wire_bytes": coll.wire_bytes},
        roofline=rl.as_dict(),
        outputs=leaf_shapes(tr["out"]),
    )
    return rec


class _CellTimeout(BaseException):
    """A trace past its time (a ``BaseException``, so no ``except
    Exception`` in the traced code swallows it)."""


def _run_one(job: tuple) -> dict:
    arch, shape, mesh_name, variant, build_kw, timeout = job
    base = {"arch": arch, "shape": shape, "variant": variant,
            "mesh": MESH_TAGS[mesh_name]}

    def expire(signum, frame):
        raise _CellTimeout

    # SIGALRM reaches only the main thread, where a pool runs its tasks
    armed = bool(timeout) and \
        threading.current_thread() is threading.main_thread()
    if armed:
        previous = signal.signal(signal.SIGALRM, expire)
        signal.alarm(timeout)
    try:
        return run_cell(arch, shape, mesh_name, variant, build_kw=build_kw)
    except _CellTimeout:
        return dict(base, status="TIMEOUT",
                    error=f"still tracing after {timeout} s")
    except Exception:
        return dict(base, status="FAIL",
                    error=traceback.format_exc()[-2000:])
    finally:
        if armed:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, previous)


def run_cells(cells, mesh_name: str = "card", jobs: int = 1,
              timeout: int | None = None, on_record=None) -> list:
    """:func:`run_cell` for each ``(arch, shape, variant[, build_kw])``
    of ``cells``, in this process (``jobs`` 1) or in a pool of ``jobs``
    spawned processes (the traces run on fake CPU tensors and touch no
    card).  A cell whose build or trace raises is a ``FAIL`` record, one
    still tracing after ``timeout`` seconds a ``TIMEOUT`` record.
    ``on_record`` sees each record as it arrives; the records come back
    in ``cells``' order.  The pool spawns its processes, which import
    the caller's main module again: a script calling this with ``jobs``
    > 1 keeps its work under ``if __name__ == "__main__":``."""
    work = [(c[0], c[1], mesh_name, c[2], c[3] if len(c) > 3 else None,
             timeout) for c in cells]
    if jobs <= 1 or len(work) <= 1:
        out = []
        for w in work:
            out.append(_run_one(w))
            if on_record is not None:
                on_record(out[-1])
        return out
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(min(jobs, len(work)),
                                mp_context=mp.get_context("spawn")) as ex:
        futures = [ex.submit(_run_one, w) for w in work]
        if on_record is not None:
            for f in cf.as_completed(futures):
                on_record(f.result())
        return [f.result() for f in futures]


def record_key(rec: dict) -> str:
    return (f"{rec['arch']}|{rec['shape']}|{rec['mesh']}|"
            f"{rec.get('variant', 'baseline')}")


def _merge_out(out_path: str, rec: dict) -> None:
    data = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            data = json.load(f)
    data[record_key(rec)] = rec
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, out_path)


def _run_all(meshes: list[str], out_path: str, variant: str,
             only_missing: bool, timeout: int, jobs: int = 1,
             cells=None) -> int:
    """Every cell of ``cells`` (default: all 40) on each mesh through
    :func:`run_cells`, each record merged into ``out_path`` as it
    arrives; the number that did not end ``OK`` or ``SKIP``."""
    from repro_torch.configs import all_cells
    existing = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            existing = json.load(f)

    def merged(rec):
        _merge_out(out_path, rec)
        line = f"[dryrun] {record_key(rec)} {rec['status']}"
        if rec["status"] in ("OK", "SKIP"):
            print(line + f" ({rec.get('trace_s', 0.0):.1f} s)", flush=True)
        else:
            print(line + ":\n    " + "\n    ".join(
                rec.get("error", "").strip().splitlines()[-12:]), flush=True)

    failures = 0
    for mesh_name in meshes:
        todo = [(arch, shape, variant) for arch, shape in (cells or all_cells())
                if not (only_missing and existing.get(
                    f"{arch}|{shape}|{MESH_TAGS[mesh_name]}|{variant}",
                    {}).get("status") in ("OK", "SKIP"))]
        recs = run_cells(todo, mesh_name, jobs, timeout, on_record=merged)
        failures += sum(r["status"] not in ("OK", "SKIP") for r in recs)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    meshes = {"card": ["card"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.all:
        sys.exit(1 if _run_all(meshes, args.out, args.variant,
                               args.only_missing, args.timeout,
                               args.jobs) else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape required without --all")
    for mesh_name in meshes:
        try:
            rec = run_cell(args.arch, args.shape, mesh_name, args.variant)
        except Exception:
            traceback.print_exc()
            rec = {"arch": args.arch, "shape": args.shape,
                   "variant": args.variant, "mesh": MESH_TAGS[mesh_name],
                   "status": "FAIL", "error": traceback.format_exc()[-2000:]}
        _merge_out(args.out, rec)
        print(json.dumps({k: v for k, v in rec.items()
                          if k in ("arch", "shape", "mesh", "status",
                                   "trace_s", "skip_reason", "error")}))
        if rec.get("status") == "FAIL":
            sys.exit(1)


if __name__ == "__main__":
    main()
