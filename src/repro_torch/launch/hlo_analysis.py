"""Cost readout of a traced step: FLOPs, bytes, peak memory, collective
bytes and roofline terms -- the counterpart of the JAX package's
``launch/hlo_analysis.py``, read from a torch trace, not from HLO text.

:class:`CostMode` (a ``TorchDispatchMode``) stands in for XLA's
``cost_analysis()`` and ``memory_analysis()``: run a step under it (on
fake tensors, :func:`repro_torch.launch.steps._abstract`) and it counts

  * FLOPs: matrix products, convolutions and attention by
    ``torch.utils.flop_counter``'s formulas (``matmul_flops``), plus one
    per element of elementwise and reduction work, as XLA's
    ``cost_analysis()`` counts it: each pointwise op's and each dtype
    convert's output elements,
    each reduction's (and softmax's) input elements, each scatter-add's
    source elements (``elementwise_flops``);
  * bytes accessed: every ATen op's input plus output bytes, views
    excluded;
  * transcendentals: output elements of exp / log / sin / cos / tanh /
    sigmoid / silu / rsqrt / sqrt / erf;
  * the largest live total of the storages the step allocates (a
    storage is live from the op that allocates it to the death of the
    last tensor on it: views and in-place results share it), from which
    the dry run states a peak estimate.

The kernels are counted as their plain versions compute them (on fake
CPU tensors every kernel wrapper takes its plain version): the plain
chunked attention computes every tile that touches the causal diagonal,
and K2's plain version is an ``index_add_``.  Records say so as
``"kernels_counted_as": "plain"``.

:func:`collectives_from_profile` replaces ``parse_collectives``: it reads
the ``gloo:`` / ``nccl:`` (else ``c10d::``) events of a
``torch.profiler`` trace recorded with ``record_shapes=True`` and prices
them with the JAX package's ring model (on-wire bytes per device, group
size n):

    all-reduce          2 (n-1)/n x bytes
    all-gather          (n-1)/n x result_bytes
    reduce-scatter      (n-1)   x result_bytes   (= (n-1)/n x operand)
    all-to-all          (n-1)/n x bytes
    collective-permute  1       x bytes

Hardware model: one NVIDIA H100 SXM (``NVIDIA H100 80GB HBM3, 700.00 W``
as ``nvidia-smi`` names it), data-sheet peaks: 989 TFLOP/s bf16 dense,
67 TFLOP/s IEEE f32 (TF32 off), 3.35 TB/s HBM3, 450 GB/s per direction
on NVLink 4.  The compute peak is picked by the cell's compute dtype: a
TPU v5e runs f32 through bf16 passes, an H100's f32 is 15x slower than
its bf16.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: the card the peaks below are for
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12     # dense bf16 tensor cores
PEAK_FLOPS_F32 = 67e12       # IEEE f32 CUDA cores
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "sin",
                   "cos", "tanh", "sigmoid", "silu", "rsqrt", "sqrt",
                   "erf", "erfinv", "acos", "pow", "_softmax",
                   "_log_softmax", "logsumexp"}


#: ops whose work is one FLOP per element of their (largest) input
_INPUT_WISE = {"_softmax", "_log_softmax", "_softmax_backward_data",
               "_log_softmax_backward_data", "cumsum", "logcumsumexp"}
#: scatter-adds: one add per source element (the last tensor argument)
_SCATTER_ADD = {"index_add", "scatter_add", "index_put", "scatter_reduce",
                "index_reduce", "_index_put_impl"}


def _elementwise(func, ins: list, outs: list) -> float:
    """One FLOP per element of ``func``'s elementwise or reduction work
    (0 for data movement: copies, casts, gathers, views)."""
    name = func._overloadpacket.__name__.rstrip("_")
    tags = func.tags
    if torch.Tag.pointwise in tags:
        return float(sum(t.numel() for t in outs))
    if name == "_to_copy" and ins and outs and ins[0].dtype != outs[0].dtype:
        return float(outs[0].numel())           # a convert
    if torch.Tag.reduction in tags or name in _INPUT_WISE:
        return float(max((t.numel() for t in ins), default=0))
    if name in _SCATTER_ADD and ins:
        return float(ins[-1].numel())
    return 0.0


def peak_flops(dtype: torch.dtype) -> float:
    """The card's compute peak for products in ``dtype``: bf16 / f16 on
    the tensor cores, anything else at the f32 rate."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_FLOPS_BF16
    return PEAK_FLOPS_F32


def _composite(func) -> bool:
    return func.namespace == "aten" and \
        torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes accessed, transcendentals and the live bytes
    of what the step allocates (see the module docstring); read
    ``flops``, ``bytes_accessed``, ``transcendentals``, ``peak_live``
    and ``live`` after the run, or :meth:`cost`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.matmul_flops = 0.0
        self.elementwise_flops = 0.0
        self.bytes_accessed = 0.0
        self.transcendentals = 0.0
        self.ops = 0
        self.live = 0
        self.peak_live = 0
        self._storages: dict = {}      # storage key -> (tensors, bytes)
        self._external: set = set()

    def external(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors (the step's arguments)
        as not the step's allocations."""
        for t in _tensors(tree):
            self._external.add(t.untyped_storage()._cdata)

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.elementwise_flops

    def _drop(self, key: int) -> None:
        n, nbytes = self._storages[key]
        if n > 1:
            self._storages[key] = (n - 1, nbytes)
            return
        del self._storages[key]
        self.live -= nbytes

    def _track(self, func, out) -> None:
        """Count each output's storage: one the step allocated is live
        from its first tensor to the death of its last (a view or an
        in-place result refers to the same storage); a storage first
        seen through an aliasing op is an argument's and not counted."""
        aliasing = func.is_view or any(
            r.alias_info is not None for r in func._schema.returns)
        seen = set()
        for t in _tensors(out):
            if id(t) in seen:
                continue
            seen.add(id(t))
            key = t.untyped_storage()._cdata
            if key in self._storages:
                n, nbytes = self._storages[key]
                self._storages[key] = (n + 1, nbytes)
            elif aliasing or key in self._external:
                self._external.add(key)
                continue
            else:
                nbytes = t.untyped_storage().nbytes()
                self._storages[key] = (1, nbytes)
                self.live += nbytes
            weakref.finalize(t, self._drop, key)
        self.peak_live = max(self.peak_live, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in self._flop_registry and \
                _composite(func):
            # inference mode hands over composite ops (matmul, linear)
            # whole: count their parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func is torch.ops.aten._local_scalar_dense.default:
            return out
        self._track(func, out)
        if func.is_view:
            return out
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.matmul_flops += float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        else:
            self.elementwise_flops += _elementwise(func, ins, outs)
        if packet.__name__.rstrip("_") in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out

    def cost(self) -> dict:
        """The JAX package's ``cost_analysis()`` keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals,
                "matmul_flops": self.matmul_flops,
                "elementwise_flops": self.elementwise_flops}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollectiveStats:
    ops: dict                    # kind -> count
    logical_bytes: dict          # kind -> summed operand/result bytes
    wire_bytes: float            # ring-model on-wire bytes (per device)

    def total_logical(self) -> float:
        return float(sum(self.logical_bytes.values()))


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """On-wire bytes per device of one collective of ``kind`` whose
    result is ``result_bytes``, in a ring of ``n`` (at least 2)."""
    n = max(2, n)
    if kind == "all-reduce":
        return 2 * (n - 1) / n * result_bytes
    if kind == "all-gather":
        return (n - 1) / n * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes
    if kind == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)


_KINDS = (("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
          ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"))


def _collective_kind(name: str) -> str:
    op = name.split(":")[-1].lower()
    for key, kind in _KINDS:
        if key in op:
            return kind
    return "collective-permute"


def collectives_from_profile(prof, group_sizes) -> CollectiveStats:
    """Collective ops of a ``torch.profiler`` trace (``record_shapes=
    True``), priced by :func:`ring_wire_bytes`.  ``group_sizes`` is the
    group size of every collective (an int) or a ``{kind: size}`` map.

    Each backend event (``gloo:all_reduce``, ``nccl:all_reduce``, ...)
    is one op; where a trace has none, the ``c10d::`` op events are
    read instead.  Bytes come from the event's input shapes, by the
    dtypes the profiler records where it does (f32 otherwise); an
    all-gather's result is ``n`` inputs, a reduce-scatter's one n-th of
    its input."""
    events = list(prof.events())
    backend = [e for e in events if e.name.startswith(("gloo:", "nccl:"))]
    chosen = backend or [e for e in events if e.name.startswith("c10d::")]
    ops: dict = {}
    logical: dict = {}
    wire = 0.0
    for ev in chosen:
        kind = _collective_kind(ev.name)
        n = group_sizes if isinstance(group_sizes, int) else \
            group_sizes.get(kind, 1)
        dtypes = getattr(ev, "input_dtypes", None) or []
        in_bytes = 0
        for i, shape in enumerate(ev.input_shapes or []):
            if not isinstance(shape, (list, tuple)) or not shape:
                continue
            if not all(isinstance(x, int) for x in shape):
                continue
            numel = 1
            for x in shape:
                numel *= x
            dt = dtypes[i] if i < len(dtypes) else ""
            in_bytes += numel * _dtype_bytes(dt)
        if kind == "all-gather":
            result = in_bytes * max(1, n)
        elif kind == "reduce-scatter":
            result = in_bytes / max(1, n)
        else:
            result = in_bytes
        ops[kind] = ops.get(kind, 0) + 1
        logical[kind] = logical.get(kind, 0) + result
        wire += ring_wire_bytes(kind, result, n)
    return CollectiveStats(ops=ops, logical_bytes=logical, wire_bytes=wire)


def _dtype_bytes(name: str) -> int:
    name = str(name).lower()
    for key, size in (("double", 8), ("long", 8), ("int64", 8),
                      ("float64", 8), ("half", 2), ("bfloat16", 2),
                      ("float16", 2), ("short", 2), ("int16", 2),
                      ("byte", 1), ("char", 1), ("bool", 1), ("int8", 1),
                      ("uint8", 1)):
        if key in name:
            return size
    return 4


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_wire_bytes: float
    n_devices: int
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None  # MODEL_FLOPS / (FLOPs x devices)
    compute_dtype: str = "bfloat16"
    peak_flops: float = PEAK_FLOPS_BF16
    card: str = CARD

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(cost, coll: CollectiveStats, n_devices: int,
             model_flops: Optional[float] = None,
             compute_dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """Roofline terms of one device's program: ``cost`` (a
    :meth:`CostMode.cost` dict, or a one-element list of one) over the
    card's peaks, the compute peak by ``compute_dtype``
    (:func:`peak_flops`), the collectives over NVLink."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    mem = float(cost.get("bytes accessed", 0.0))
    peak = peak_flops(compute_dtype)
    t_c = flops / peak
    t_m = mem / HBM_BW
    t_x = coll.wire_bytes / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dom = max(terms, key=terms.get)
    useful = None
    if model_flops:
        useful = model_flops / max(flops * n_devices, 1.0)
    return Roofline(flops_per_device=flops, bytes_per_device=mem,
                    coll_wire_bytes=coll.wire_bytes, n_devices=n_devices,
                    t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    dominant=dom, model_flops=model_flops,
                    useful_ratio=useful,
                    compute_dtype=str(compute_dtype).split(".")[-1],
                    peak_flops=peak)
