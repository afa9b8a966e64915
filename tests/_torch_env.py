"""The process set-up of every ``test_torch_*`` file, which imports this
module before anything else, and the one loader of ``chip_smoke.py``.

On import: one intra-op thread for torch in this process, and
``OMP_NUM_THREADS=1`` (unless already set) for the subprocesses the port's
tests start.  The suite's parallel workers share the machine's cores, so
a thread per core in each worker only makes them wait on one another;
and with one thread a CPU sum's order no longer depends on how many
threads the BLAS picks under load, so two runs of the same steps agree
bit for bit, which the restart and parity checks of the slices
assert.

No JAX here: ``tests/test_torch_gpu.py`` imports this module on the card's
machine, which has none.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import pathlib
import sys

import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.cache
def load_chip_smoke():
    """``chip_smoke.py`` at the repository's root as the module
    ``chip_smoke``, loaded once a process (its dataclasses look their
    module up in ``sys.modules``), with ``sys.path`` as it was before
    (the module puts ``src`` on it)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    path_before = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path_before
    return mod
