"""The LM example's loss curve in the JAX package and in the port, from
the same weights, at the example's full width cut in depth::

    PYTHONPATH=src python tests/_lm_example_curves.py --layers 2 \
        --steps 300 --workdir DIR [--threads 4]

The JAX example (``examples/train_lm_packed_tokens.py``) runs as it is
through ``tests/_jax_example.py --layers N`` in a subprocess; the port's
(``examples/train_lm_packed_tokens_torch.py``) then runs on the CPU from
the weights the JAX example started from, carried over by
``repro_torch/convert.py``.  Prints one JSON object: both curves, the
means of their first and last 20 losses, ln(vocab), and the relative
difference between the two curves step by step.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import torch

from repro_torch.convert import transformer_params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    work = pathlib.Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    argv = ["--steps", str(args.steps)]
    record = work / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=true "
               "intra_op_parallelism_threads=%d" % args.threads)
    subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_jax_example.py"), str(record),
         "--layers", str(args.layers),
         str(ROOT / "examples" / "train_lm_packed_tokens.py"), *argv,
         "--workdir", str(work / "jax")],
        env=env, check=True, stdout=sys.stderr)
    with open(record, "rb") as f:
        rec = pickle.load(f)

    torch.set_num_threads(args.threads)
    spec = importlib.util.spec_from_file_location(
        "lm_example", ROOT / "examples" / "train_lm_packed_tokens_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    full = mod.model_config
    mod.model_config = lambda a: dataclasses.replace(full(a),
                                                     n_layers=args.layers)
    ex_args = mod.build_parser().parse_args(
        [*argv, "--workdir", str(work / "port"), "--device", "cpu"])
    cfg = mod.model_config(ex_args)
    params = transformer_params_from_numpy(rec["first_params"], cfg,
                                           device="cpu")
    stdout, sys.stdout = sys.stdout, sys.stderr
    try:
        port = mod.run(ex_args, device="cpu", params=params)["losses"]
    finally:
        sys.stdout = stdout
    ref = [float(v) for v in rec["outputs"]]
    rel = (np.abs(np.subtract(port, ref)) / np.abs(ref)).tolist()
    print(json.dumps({
        "config": {"name": cfg.name, "n_layers": cfg.n_layers,
                   "d_model": cfg.d_model, "vocab": cfg.vocab,
                   "steps": args.steps},
        "ln_vocab": float(np.log(cfg.vocab)),
        "jax": {"first20": float(np.mean(ref[:20])),
                "last20": float(np.mean(ref[-20:])), "losses": ref},
        "port": {"first20": float(np.mean(port[:20])),
                 "last20": float(np.mean(port[-20:])), "losses": port},
        "rel_diff": {"max": max(rel), "first_step_over_1e-5": next(
            (i + 1 for i, r in enumerate(rel) if r > 1e-5), None),
            "by_step": rel}}))


if __name__ == "__main__":
    main()
