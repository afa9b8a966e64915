// Segment sum (GNN message aggregation) for Hopper (sm_90a):
//
//     out[ids[e], d] += msg[e, d]     for 0 <= ids[e] < N, else dropped
//
// Replaces the TPU kernel src/repro/kernels/segment_sum/kernel.py::
// segment_sum_blocked (body _segsum_kernel).  The TPU has no atomics in
// HBM, so that kernel builds a (block_e, N) one-hot of the ids and
// multiplies it into the message tile on the MXU, carrying the (N,
// block_d) output tile across a sequential grid; it only fits for
// N <= 8192.  The card has atomics in L2, so the one-hot (N times the
// work) goes: every message element is added straight into its row.
//
// Bound: memory.  The function reads E*D f32 messages and E int32 ids and
// writes N*D f32 sums, one add per message element, so the least time the
// card can take is (4*E*D + 4*E + 4*N*D) / HBM bandwidth.
//
// What the design does about it (a simple kernel that is right first):
//   * one thread per element of the flattened E x D message matrix, so
//     neighbouring threads read neighbouring addresses whatever D is --
//     D = 1433 (Cora's width) leaves rows off any 16-byte grid, which
//     rules out per-row vector loads but not this layout;
//   * the add is a float atomicAdd whose result is unused, which the
//     compiler issues as a fire-and-forget reduction in L2; the wrapper
//     zero-fills `out` on the same stream first;
//   * ids outside [0, N) are dropped by a bounds check: the TPU one-hot
//     never matches them and neither does XLA's segment sum;
//   * all indexing is 64-bit: E*D passes 2^31 at the widths served.
// The order of the atomic adds varies from run to run, so f32 sums agree
// with a sequential sum to rounding, not bit for bit.  Sorted-segment
// reduction, warp pre-combining of equal-id runs and vector loads are
// left for later.
//
// Plain C interface (loaded with ctypes): the launcher enqueues on the
// stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 30;   // grid-stride beyond this

__global__ void __launch_bounds__(kThreads)
segment_sum_atomic(const float* __restrict__ msgs,
                   const int32_t* __restrict__ ids,
                   float* __restrict__ out,
                   long long total, long long d, long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < total; i += stride) {
        const long long e = i / d;
        const long long col = i - e * d;
        const long long seg = __ldg(ids + e);
        if (seg >= 0 && seg < n)
            atomicAdd(out + seg * d + col, __ldg(msgs + i));
    }
}

}  // namespace

// Sum `msgs` (device pointer, f32[e, d] row-major) into `out` (device
// pointer, f32[n, d], zero-filled by the caller) by `ids` (device
// pointer, int32[e]) on `stream`.  Returns 0 on success, a cudaError_t
// otherwise (cudaErrorInvalidValue for a negative size).
extern "C" int segment_sum_launch(const void* msgs, const void* ids,
                                  void* out, long long e, long long d,
                                  long long n, void* stream) {
    if (e < 0 || d < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long total = e * d;
    if (total == 0 || n == 0) return 0;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    segment_sum_atomic<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msgs), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), total, d, n);
    return static_cast<int>(cudaGetLastError());
}

// Text of a cudaError_t, for the wrapper's exception message.
extern "C" const char* segment_sum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
