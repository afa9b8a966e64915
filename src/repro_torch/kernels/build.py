"""Build-at-first-use for the CUDA sources under ``repro_torch/csrc``.

Each ``<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>_<hash>.so``
(next to the ``src/`` directory; the hash is of the source, so an edited
kernel never reuses a stale library) and loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds.  A missing
compiler or a failed build RAISES: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: seconds each library took to compile in this process (0.0 = reused)
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else the toolkit's usual place.  Raises when there is none."""
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in cands:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def _start(name: str, extra_flags: Iterable[str] = ()):
    """Start one nvcc for ``name``; returns (process, tmp, out, t0) or
    None when the library is already built."""
    src, out = _target(name)
    if out.is_file():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> str:
    """Wait for ``name``'s compiler; returns its output, raises on failure."""
    if started is None:
        build_seconds.setdefault(name, 0.0)
        return ""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    return log


def build_all(names: Optional[Iterable[str]] = None,
              extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compile several kernels at once, one ``nvcc`` process per source,
    all started together.  ``names`` defaults to every ``*.cu`` under
    ``csrc/``.  Returns each compiler's output by kernel name."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with _lock:
        started = {}
        try:
            for n in names:
                started[n] = _start(n, extra_flags)
            return {n: _finish(n, s) for n, s in started.items()}
        finally:
            # a failed build must not leave its siblings running
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return lib
