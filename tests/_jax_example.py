"""Run one of the JAX package's examples as it is and record what it
computed, for ``tests/test_torch_examples.py`` to hold the port's copy
against::

    python tests/_jax_example.py OUT.pkl [--layers N] examples/NAME.py [ARGS...]

The example runs unchanged (its ``main()`` with ``ARGS`` as its command
line, its stdout where it prints it), but for ``--layers N``: every
``TransformerConfig`` it builds then has ``N`` layers (an LM example at
its full width, cut in depth).  What it prints rounded is
recorded exactly on the side, through wrappers around the names it
calls:

* every ``jax.jit`` function the example defines itself: the first
  call's first argument (the params it starts from) and each call's
  last output (a step's loss, a forward's scores);
* ``simulate_hosts``' per-host stream stats and the query engine's
  stats (``train_gnn_from_compbin.py``);
* ``stream_partitions``' stream stats (``quickstart.py``);
* the bytes ``compbin.encode_ids`` packs (``serve_din_requests.py``).

OUT.pkl gets a dict with those records, numpy arrays and plain ints.
"""

import dataclasses
import importlib.util
import os
import pickle
import sys
import types

import numpy as np

from repro_torch.convert import stats_ints


def main() -> None:
    out_path, *argv = sys.argv[1:]
    layers = None
    if argv[0] == "--layers":
        layers, argv = int(argv[1]), argv[2:]
    example, *argv = argv
    example = os.path.abspath(example)
    spec = importlib.util.spec_from_file_location("jax_example", example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if layers is not None:
        real_cfg = mod.tf.TransformerConfig
        mod.tf = types.SimpleNamespace(**{
            **vars(mod.tf), "TransformerConfig": lambda **kw:
            dataclasses.replace(real_cfg(**kw), n_layers=layers)})

    import jax
    import repro.core.compbin
    import repro.data

    rec = {"first_params": None, "outputs": [], "hosts": [], "engines": [],
           "streams": [], "encoded_bytes": 0}
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    real_jit = jax.jit

    def jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        code = getattr(fn, "__code__", None)
        if code is None or os.path.abspath(code.co_filename) != example:
            return jitted

        def call(*a):
            out = jitted(*a)
            if rec["first_params"] is None:
                rec["first_params"] = to_np(a[0])
            rec["outputs"].append(to_np(out[-1] if isinstance(out, tuple)
                                        else out))
            return out

        return call

    jax.jit = jit
    if hasattr(mod, "simulate_hosts"):
        real_hosts = mod.simulate_hosts

        def simulate_hosts(*a, **kw):
            results = real_hosts(*a, **kw)
            rec["hosts"].extend(results)
            return results

        mod.simulate_hosts = simulate_hosts
    if hasattr(mod, "NeighborQueryEngine"):
        real_engine = mod.NeighborQueryEngine

        def engine(*a, **kw):
            e = real_engine(*a, **kw)
            rec["engines"].append(e)
            return e

        mod.NeighborQueryEngine = engine
    real_stream = repro.data.stream_partitions

    def stream_partitions(*a, **kw):
        s = real_stream(*a, **kw)
        rec["streams"].append(s)
        return s

    repro.data.stream_partitions = stream_partitions
    real_encode = repro.core.compbin.encode_ids

    def encode_ids(*a, **kw):
        packed = real_encode(*a, **kw)
        rec["encoded_bytes"] += int(packed.nbytes)
        return packed

    repro.core.compbin.encode_ids = encode_ids

    sys.argv = [example, *argv]
    mod.main()
    rec["hosts"] = [stats_ints(r.stats) for r in rec["hosts"]]
    rec["engines"] = [stats_ints(e.stats) for e in rec["engines"]]
    rec["streams"] = [stats_ints(s.stats) for s in rec["streams"]]
    with open(out_path, "wb") as f:
        pickle.dump(rec, f)


if __name__ == "__main__":
    main()
