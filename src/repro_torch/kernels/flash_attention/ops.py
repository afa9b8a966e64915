"""Public wrappers for the flash-attention kernel (blocked causal GQA
attention).

Two entry points over one kernel: :func:`flash_attention` keeps the JAX
package's ``[B, H, S, Dh]`` layout; :func:`attention_bshd` takes
``[B, S, H, Dh]`` views (any strides, the last dimension contiguous) with
an explicit ``offset`` and ``kv_len``, so the transformer hands it its
projections and the live part of a KV cache with no transpose copy.
On the card, :func:`plan` picks one of the kernel's three designs per
call (``csrc/flash_attention.cu`` describes them).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.utils import ceil_div

_launch_lock = threading.Lock()

#: head sizes the CUDA kernel is built for
KERNEL_HEAD_DIMS = (64, 128)
#: the kernel's designs, by the code its launcher takes
DESIGNS = {"tc_prefill": 0, "fma": 1, "split_decode": 2}
#: most query rows per KV head (Sq * Hq / Hkv) the split design takes
SPLIT_MAX_ROWS = 32
#: fewest keys per split, and the keys a split aims at
SPLIT_MIN_KEYS = 64
SPLIT_KEYS = 128
#: most key ranges (bounds the workspace and the combine's serial merge)
SPLIT_MAX = 64
#: the split design's grid covers the card's SMs at least this often
SPLIT_SM_COVER = 2
#: SMs of an H100, for a plan made without a card at hand
H100_SMS = 132


def plan(dtype: torch.dtype, rows: int, kv_len: int, dh: int, pairs: int,
         n_sm: int = H100_SMS) -> tuple[str, int]:
    """The design and split count of one CUDA call: ``rows`` query rows
    per KV head (``Sq * Hq / Hkv``), ``kv_len`` keys, ``pairs`` =
    batch x KV heads, on a card with ``n_sm`` SMs.

    At most ``SPLIT_MAX_ROWS`` rows (decode, short chunks) go to
    ``split_decode``, with the keys cut into ``nsplit`` ranges: about
    ``SPLIT_KEYS`` keys each, more ranges where the grid would not cover
    the SMs ``SPLIT_SM_COVER`` times, never fewer than ``SPLIT_MIN_KEYS``
    keys a range, nor more than ``SPLIT_MAX`` ranges.  More rows go to
    ``tc_prefill`` in bf16 (tensor cores) and to ``fma`` in f32 (the
    JAX package's f32 tolerance rules out TF32 products).  The CUDA
    launcher takes whatever this picks: these limits live here alone."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes Dh in {KERNEL_HEAD_DIMS}, "
                         f"got {dh}")
    if rows <= SPLIT_MAX_ROWS:
        nsplit = max(ceil_div(kv_len, SPLIT_KEYS),
                     ceil_div(SPLIT_SM_COVER * n_sm, max(pairs, 1)))
        nsplit = min(nsplit, kv_len // SPLIT_MIN_KEYS, SPLIT_MAX)
        return "split_decode", max(1, nsplit)
    return ("tc_prefill" if dtype == torch.bfloat16 else "fma"), 1


_sm_counts: dict = {}


def _sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _check(q, k, v, seq_axis: int, offset, kv_len):
    """Shapes as (B, Hq, Hkv, Sq, Skv, Dh), offset and kv_len resolved;
    raises on what neither version takes."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be 4-D")
    head_axis = 3 - seq_axis
    b, hq, sq, dh = (q.shape[0], q.shape[head_axis], q.shape[seq_axis],
                     q.shape[3])
    hkv, skv = k.shape[head_axis], k.shape[seq_axis]
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head size")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not (q.is_floating_point() and k.is_floating_point()
            and v.is_floating_point()):
        raise TypeError("q, k and v must be floating point")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward (neither has the JAX "
            "package's kernel): it takes no tensor that requires grad "
            "(run under torch.no_grad() or torch.inference_mode())")
    offset = skv - sq if offset is None else int(offset)
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"kv_len={kv_len} outside [0, Skv={skv}]")
    return (b, hq, hkv, sq, skv, dh), offset, kv_len


def _check_cuda(tensors) -> None:
    dtype = tensors[0].dtype
    if any(t.dtype != dtype for t in tensors):
        raise TypeError("q, k and v must have one dtype on the GPU")
    vec = 16 // tensors[0].element_size()
    for t in tensors:
        if t.stride(3) != 1:
            raise ValueError("the last dimension must be contiguous")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"strides {t.stride()} and base address must "
                             f"be 16-byte aligned")


def _attend(q, k, v, seq_axis: int, causal: bool, scale, offset, kv_len):
    (b, hq, hkv, sq, skv, dh), offset, kv_len = _check(q, k, v, seq_axis,
                                                       offset, kv_len)
    scale = dh ** -0.5 if scale is None else float(scale)
    if not q.is_cuda:
        if seq_axis == 2:
            out = attention_ref(q, k, v, causal=causal, scale=scale,
                                offset=offset, kv_len=kv_len)
            return out.to(q.dtype)
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale,
                            offset=offset, kv_len=kv_len)
        return out.transpose(1, 2).to(q.dtype).contiguous()
    rows = hq // hkv * sq
    design, nsplit = plan(q.dtype, rows, kv_len, dh, b * hkv,
                          _sm_count(q.device))
    _check_cuda((q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = ()
    for t in (q, k, v, out):
        st = t.stride()
        strides += (st[0], st[3 - seq_axis], st[seq_axis])
    if b and sq:
        ws = None
        if nsplit > 1:
            ws = torch.empty(b * hkv * nsplit * rows * (dh + 2),
                             dtype=torch.float32, device=q.device)
        flash_attention_cuda(q, k, v, out, strides, batch=b, hq=hq, hkv=hkv,
                             sq=sq, dh=dh, offset=offset, kv_len=kv_len,
                             causal=causal, scale=scale,
                             design=DESIGNS[design], nsplit=nsplit,
                             workspace=ws)
        with _launch_lock:
            flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked causal GQA attention in the JAX package's layout.

    q: [B, Hq, Sq, Dh]; k, v: [B, Hkv, Skv, Dh].  Returns [B, Hq, Sq, Dh]
    with q's dtype; query head h reads KV head ``h // (Hq // Hkv)``, the
    causal mask uses the decode convention (the last query sees the whole
    KV) and a row that sees no key is 0.  A CUDA tensor goes through the
    hand-written kernel (f32 or bf16, Dh 64 or 128; f32 sums in IEEE
    f32, no TF32; the design :func:`plan` picks) or raises; a CPU tensor
    takes the plain version.  There is no backward: a tensor that
    requires grad raises.  ``flash_attention.launches`` counts calls that
    launched the kernel (one per call, whatever CUDA kernels the design
    runs: the split design adds its combine when it splits) and nothing
    else.
    """
    return _attend(q, k, v, 2, causal, scale, None, None)


flash_attention.launches = 0


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, scale: float | None = None,
                   offset: int | None = None,
                   kv_len: int | None = None) -> torch.Tensor:
    """The same attention on ``[B, S, H, Dh]`` views, which may be
    strided (a slice of a ``[B, Smax, Hkv, Dh]`` cache is passed as it
    lies).  Query row i sees key j when ``j < kv_len`` and, if causal,
    ``j <= i + offset`` (defaults ``Skv - Sq`` and ``Skv``).  Returns a
    contiguous [B, Sq, Hq, Dh] tensor with q's dtype; launches count on
    ``flash_attention.launches``."""
    return _attend(q, k, v, 1, causal, scale, offset, kv_len)
