// Segment sum (GNN message aggregation) for Hopper (sm_90a):
//
//     out[ids[e], d] += msg[e, d]     for 0 <= ids[e] < N, else dropped
//
// Replaces the TPU kernel src/repro/kernels/segment_sum/kernel.py::
// segment_sum_blocked (body _segsum_kernel).  The TPU has no atomics in
// HBM, so that kernel builds a (block_e, N) one-hot of the ids and
// multiplies it into the message tile on the MXU, carrying the (N,
// block_d) output tile across a sequential grid; it only fits for
// N <= 8192.  The card needs neither the one-hot (N times the work) nor
// the cliff.
//
// Bound: memory.  The function must read the valid rows of f32 messages
// and the E ids and write the N*D f32 sums once, one add per valid message
// element, so the least time the card can take is
// (4*E_valid*D + 4*E + 4*N*D) / HBM bandwidth.
//
// Ids are read in their own width (int32 or int64) and compared with N in
// 64 bits, so an int64 id outside [0, N) -- 2^32 among them -- is dropped,
// never wrapped into a real segment, and no narrowing pass runs first.
//
// Two designs; the wrapper's `plan` (kernels/segment_sum/ops.py) picks one
// per call, and this file holds no limit of its own:
//
//   atomic (design 0): one thread per element of the flattened E x D
//     message matrix, so neighbouring threads read neighbouring addresses
//     whatever D is (D = 1433, Cora's width, leaves rows off any 16-byte
//     grid).  Each element is a float atomicAdd whose result is unused,
//     which the compiler issues as a fire-and-forget reduction in L2, into
//     an output the wrapper zero-fills first.  One launch; the order of
//     the adds, and so the f32 rounding, varies from run to run.
//
//   rows (design 1): three launches on the caller's stream, no host sync,
//     scratch in a caller-owned int32 workspace of 2E+2 entries.
//     k2_index (one block) compacts the valid edges in edge order into
//       vedge[k] (the edge) and vid[k] (its id), counts them (nvalid) and
//       flags `unsorted` if vid ever decreases.  It reads only the E ids:
//       each warp a contiguous slice, 32 coalesced ids a step, positions
//       by ballot, so the one block's loads and stores stay coalesced.
//     k2_rows gives each block a run of output rows: one binary search a
//       row bound (in parallel, into shared memory), then each row's
//       edges summed in edge order into a register, several message loads
//       in flight, and the row stored ONCE -- 0 where it has no edge; a
//       block whose rows have no edge at all stores its zeros 16 bytes a
//       thread.  So on sorted ids (the served block's layout) there is no
//       atomic, no separate fill, and the same bits on every run: the sum
//       is a sequential f32 sum from +0.0 in edge order, as the CPU's
//       index_add_ takes it.  If `unsorted` is set it stores zeros.
//     k2_scatter, on unsorted ids only, adds the compacted valid edges with
//       atomics into those zeros; on sorted ids it returns at once, from a
//       grid capped at one wave so the early exit costs little.
//
// All indexing of messages and output is 64-bit: vedge[k]*D passes 2^31 at
// the widths served on larger graphs.
//
// The backward (segment_sum_grad_launch, kernel k2_grad) is a gather:
//
//     grad_msg[e, d] = grad_out[ids[e], d]   for 0 <= ids[e] < N, else 0
//
// The JAX package has no backward kernel (it trains through XLA's own
// segment_sum), so this one replaces nothing on the TPU side; it keeps
// the card's one segment sum, the kernel above, on the training path.
//
// Bound: memory.  The function must read each of the R distinct rows of
// f32 grad_out that a valid id names once, write the E x D f32 gradient
// once and read the E ids once: (4*R*D + 4*E*D + E*id_bytes) bytes over
// HBM bandwidth.  At GCN's full-graph shape (D = 16, E = 3.94 M, R =
// 148,526) that is 252 MB of writes against 17 MB of rows, so the rows
// stay in the 50 MB L2 and the write stream sets the pace.  There is no
// arithmetic, so neither wgmma nor TMA applies: TMA copies tiles by
// coordinate and has no row gather.  What the design does instead:
//   - Vector width VEC (4, 2 or 1 floats: 16, 8 or 4 bytes), picked per
//     call by the wrapper (ops.py::grad_vector_width) as the widest that
//     D and both pointers allow; the launcher refuses any other.  D = 16
//     moves a row in four 16-byte vectors.
//   - No division per element: a row is covered by `lpr` lanes (the
//     smallest power of two >= D/VEC, at most 32), a warp holds 32/lpr
//     rows side by side, and a lane loops over columns where D/VEC > 32
//     (D = 1433 takes 45 columns a lane).  Rows come from the warp and
//     lane index, with a grid-stride loop over steps on a grid of a few
//     waves; 64-bit products appear only in the id*D and row*D offsets.
//   - Loads in flight: each thread holds kGradRows rows at once, first
//     their ids (one load a row, not one an element), then their grad_out
//     vectors (__ldg), then the stores.
//   - Stores evict-first (__stcs), so the gradient streamed out does not
//     push the grad_out rows that many ids name again out of L2.
// Each id is read in its own width and compared with N in 64 bits, as
// the forward does, so an int64 id of 2^32 gives a zero row.  One launch,
// no host sync, nothing allocated; the result is the plain version's bit
// for bit.
//
// Plain C interface (loaded with ctypes): the launcher enqueues on the
// stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAtomic = 0;
constexpr int kRows = 1;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 30;   // grid-stride beyond this
// grid of k2_scatter: one wave's worth, so its early exit on sorted ids is
// cheap; on unsorted ids it strides over the messages
constexpr long long kScatterBlocks = 2048;

// k2_index: one block of 32 warps; each warp loads kIndexBatch steps of 32
// ids before it works on them, so that many coalesced loads are in flight
constexpr int kIndexThreads = 1024;
constexpr int kIndexBatch = 16;

// k2_rows: kThreads threads a block, a group of `tpr` (32..256) threads a
// row, each group kRowsPerGroup consecutive rows; each thread kCols
// columns of kLoads edges at a time, so kCols * kLoads message loads in
// flight
constexpr int kRowsPerGroup = 2;
constexpr int kMaxRowsPerBlock = (kThreads / 32) * kRowsPerGroup;
constexpr int kCols = 2;
constexpr int kLoads = 4;

constexpr unsigned kAll = 0xffffffffu;

// k2_grad: rows a thread holds at once (their loads all in flight before
// the first store), and the grid's cap in waves of resident blocks
constexpr int kGradRows = 4;
constexpr int kGradWaves = 4;

template <typename Id>
__global__ void __launch_bounds__(kThreads)
k2_atomic(const float* __restrict__ msgs, const Id* __restrict__ ids,
          float* __restrict__ out, long long total, long long d, long long n) {
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

// The vector k2_grad moves: VEC floats in one 16-, 8- or 4-byte access.
template <int VEC> struct GradVec;
template <> struct GradVec<4> { using T = float4; };
template <> struct GradVec<2> { using T = float2; };
template <> struct GradVec<1> { using T = float; };

// Backward gather, rows of dv = D/VEC vectors: out[r] = grad[ids[r]] where
// ids[r] lies in [0, n), else a zero row.  Lane `lane` of a warp covers
// row slot lane >> lpr_shift, columns (lane & (lpr-1)) + k*lpr; a warp
// step takes kGradRows groups of 32 >> lpr_shift consecutive rows.
template <typename Id, int VEC>
__global__ void __launch_bounds__(kThreads)
k2_grad(const float* __restrict__ grad, const Id* __restrict__ ids,
        float* __restrict__ out, long long e, long long dv, long long n,
        int lpr_shift) {
    using V = typename GradVec<VEC>::T;
    const V* __restrict__ g = reinterpret_cast<const V*>(grad);
    V* __restrict__ o = reinterpret_cast<V*>(out);
    const int lane = threadIdx.x & 31;
    const int lpr = 1 << lpr_shift;
    const int slots = 32 >> lpr_shift;           // rows side by side
    const int slot = lane >> lpr_shift;
    const int col0 = lane & (lpr - 1);
    const long long step = static_cast<long long>(slots) * kGradRows;
    const long long warps =
        static_cast<long long>(gridDim.x) * (kThreads / 32);
    for (long long base = (static_cast<long long>(blockIdx.x) * kThreads
                           + threadIdx.x) / 32 * step;
         base < e; base += warps * step) {
        long long row[kGradRows], src[kGradRows];
#pragma unroll
        for (int j = 0; j < kGradRows; ++j) {
            row[j] = base + j * slots + slot;
            const long long id =
                row[j] < e ? static_cast<long long>(__ldg(ids + row[j])) : -1;
            src[j] = id >= 0 && id < n ? id * dv : -1;
        }
        for (long long c = col0; c < dv; c += lpr) {
            V x[kGradRows];
#pragma unroll
            for (int j = 0; j < kGradRows; ++j)
                x[j] = src[j] >= 0 ? __ldg(g + src[j] + c) : V{};
#pragma unroll
            for (int j = 0; j < kGradRows; ++j)
                if (row[j] < e) __stcs(o + row[j] * dv + c, x[j]);
        }
    }
}

// Inclusive max over the lanes of a warp.
__device__ __forceinline__ int warp_max(int x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x = max(x, y);
    }
    return x;
}

// Inclusive sum over the lanes of a warp.
__device__ __forceinline__ int warp_sum(int x, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// The id of edge i as the index takes it: -1 where i is past `end` or the
// id lies outside [0, n).
template <typename Id>
__device__ __forceinline__ int valid_id(const Id* __restrict__ ids,
                                        long long i, long long end,
                                        long long n) {
    const long long v = i < end ? static_cast<long long>(__ldg(ids + i)) : -1;
    return v >= 0 && v < n ? static_cast<int>(v) : -1;
}

// One block; meta[0] = nvalid, meta[1] = unsorted.  Warp w takes the ids
// [w*span, (w+1)*span), 32 at a step, kIndexBatch steps a batch.  Pass 1
// counts each warp's valid ids (ballot); warp 0 turns the counts into
// offsets.  Pass 2 reads the slice again (now in cache), writes each
// valid edge at its offset plus the valid lanes below it, so consecutive
// lanes store to consecutive entries, and checks the order: each valid id
// against the valid id just before it, then (warp 0) each warp's first
// valid id against the largest last one of the warps before -- a warp in
// order ends on its largest.
template <typename Id>
__global__ void __launch_bounds__(kIndexThreads)
k2_index(const Id* __restrict__ ids, long long e, long long n,
         int32_t* __restrict__ vedge, int32_t* __restrict__ vid,
         int32_t* __restrict__ meta) {
    constexpr int kWarps = kIndexThreads / 32;
    static_assert(kWarps == 32, "warp 0 scans one total a warp");
    __shared__ int w_count[kWarps], w_first[kWarps], w_last[kWarps],
        w_bad[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long span = (e + 32LL * kWarps - 1) / (32LL * kWarps) * 32;
    const long long lo = warp * span;
    const long long hi = lo + span < e ? lo + span : e;
    const unsigned below = (1u << lane) - 1;

    int count = 0;
    for (long long b = lo; b < hi; b += 32 * kIndexBatch) {
        int x[kIndexBatch];          // all loads of a batch in flight first
#pragma unroll
        for (int u = 0; u < kIndexBatch; ++u)
            x[u] = valid_id(ids, b + 32 * u + lane, hi, n);
#pragma unroll
        for (int u = 0; u < kIndexBatch; ++u)
            count += __popc(__ballot_sync(kAll, x[u] >= 0));
    }
    if (lane == 0) w_count[warp] = count;
    __syncthreads();
    if (warp == 0) {
        const int c = w_count[lane];
        const int s = warp_sum(c, lane);
        w_count[lane] = s - c;
        if (lane == 31) meta[0] = s;
    }
    __syncthreads();
    int pos = w_count[warp], last = -1, first = -1, bad = 0;
    for (long long b = lo; b < hi; b += 32 * kIndexBatch) {
        int x[kIndexBatch];
#pragma unroll
        for (int u = 0; u < kIndexBatch; ++u)
            x[u] = valid_id(ids, b + 32 * u + lane, hi, n);
#pragma unroll
        for (int u = 0; u < kIndexBatch; ++u) {
            const unsigned mask = __ballot_sync(kAll, x[u] >= 0);
            if (mask == 0) continue;
            const unsigned lower = mask & below;
            if (x[u] >= 0) {
                const int p = pos + __popc(lower);
                vedge[p] = static_cast<int32_t>(b + 32 * u + lane);
                vid[p] = x[u];
            }
            // each valid id against the valid id just before it: the
            // nearest valid lane below, else the last valid id before
            const int near =
                __shfl_sync(kAll, x[u], lower ? 31 - __clz(lower) : 0);
            bad |= x[u] >= 0 && x[u] < (lower ? near : last);
            if (first < 0) first = __shfl_sync(kAll, x[u], __ffs(mask) - 1);
            last = __shfl_sync(kAll, x[u], 31 - __clz(mask));
            pos += __popc(mask);
        }
    }
    bad = __any_sync(kAll, bad);
    if (lane == 0) {
        w_first[warp] = first;
        w_last[warp] = last;
        w_bad[warp] = bad;
    }
    __syncthreads();
    if (warp == 0) {
        const int f = w_first[lane];
        const int prev = __shfl_up_sync(kAll, warp_max(w_last[lane], lane), 1);
        const int any_bad =
            __any_sync(kAll, w_bad[lane] | (f >= 0 && lane && f < prev));
        if (lane == 31) meta[1] = any_bad;
    }
}

// The rows design's arm for unsorted ids: the compacted valid edges added
// with atomics into the zeros k2_rows stored.  Returns at once on sorted
// ids.
__global__ void __launch_bounds__(kThreads)
k2_scatter(const float* __restrict__ msgs, const int32_t* __restrict__ vedge,
           const int32_t* __restrict__ vid, const int32_t* __restrict__ meta,
           float* __restrict__ out, long long d) {
    if (__ldg(meta + 1) == 0) return;
    const long long total = static_cast<long long>(__ldg(meta)) * d;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < total; i += stride) {
        const long long k = i / d;
        const long long col = i - k * d;
        atomicAdd(out + static_cast<long long>(__ldg(vid + k)) * d + col,
                  __ldg(msgs + static_cast<long long>(__ldg(vedge + k)) * d
                        + col));
    }
}

// First k in [0, count) with v[k] >= key, else count.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ v,
                                           int count, long long key) {
    int lo = 0, hi = count;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(v + mid) < key) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Zeros over out[0, len), 16 bytes a thread where the address allows.
__device__ __forceinline__ void zero_fill(float* __restrict__ out,
                                          long long len) {
    long long head = (16 - (reinterpret_cast<uintptr_t>(out) & 15)) / 4 & 3;
    if (head > len) head = len;
    const long long quads = (len - head) / 4;
    for (long long i = threadIdx.x; i < head; i += kThreads) out[i] = 0.0f;
    float4* v = reinterpret_cast<float4*>(out + head);
    for (long long i = threadIdx.x; i < quads; i += kThreads)
        v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long i = head + 4 * quads + threadIdx.x; i < len; i += kThreads)
        out[i] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
k2_rows(const float* __restrict__ msgs, const int32_t* __restrict__ vedge,
        const int32_t* __restrict__ vid, const int32_t* __restrict__ meta,
        float* __restrict__ out, long long d, long long n, int tpr) {
    __shared__ int bounds[kMaxRowsPerBlock + 1];
    const int rows_per_block = kThreads / tpr * kRowsPerGroup;
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long rows = n - r0 < rows_per_block ? n - r0 : rows_per_block;
    const bool sorted = __ldg(meta + 1) == 0;
    if (sorted) {
        const int nvalid = __ldg(meta);
        for (int j = threadIdx.x; j <= rows_per_block; j += kThreads)
            bounds[j] = lower_bound(vid, nvalid, r0 + j);
    }
    __syncthreads();
    if (!sorted || bounds[0] == bounds[rows_per_block]) {
        zero_fill(out + r0 * d, rows * d);     // no edge in these rows
        return;
    }
    const int group = threadIdx.x / tpr, lane = threadIdx.x % tpr;
    for (int i = 0; i < kRowsPerGroup; ++i) {
        const int j = group * kRowsPerGroup + i;
        if (j >= rows) break;
        const int lo = bounds[j], hi = bounds[j + 1];
        float* __restrict__ row = out + (r0 + j) * d;
        for (long long c0 = lane; c0 < d; c0 += tpr * kCols) {
            float acc[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
            for (int k = lo; k < hi; k += kLoads) {
                float x[kCols][kLoads];
#pragma unroll
                for (int u = 0; u < kLoads; ++u) {
                    const bool edge = k + u < hi;
                    const long long src =
                        edge ? static_cast<long long>(__ldg(vedge + k + u)) * d
                             : 0;
#pragma unroll
                    for (int c = 0; c < kCols; ++c) {
                        const long long col = c0 + c * tpr;
                        x[c][u] = edge && col < d ? __ldg(msgs + src + col)
                                                  : 0.0f;
                    }
                }
                // in edge order; a pad adds +0.0, which leaves acc as it
                // is (acc starts at +0.0 and so is never -0.0)
#pragma unroll
                for (int c = 0; c < kCols; ++c)
#pragma unroll
                    for (int u = 0; u < kLoads; ++u) acc[c] += x[c][u];
            }
#pragma unroll
            for (int c = 0; c < kCols; ++c)
                if (c0 + c * tpr < d) row[c0 + c * tpr] = acc[c];
        }
    }
}

template <typename Id>
int launch(const float* msgs, const Id* ids, float* out, long long e,
           long long d, long long n, int design, int32_t* workspace,
           cudaStream_t st) {
    const long long total = e * d;
    if (design == kAtomic) {
        if (total == 0 || n == 0) return 0;
        long long blocks = (total + kThreads - 1) / kThreads;
        if (blocks > kMaxBlocks) blocks = kMaxBlocks;
        k2_atomic<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
            msgs, ids, out, total, d, n);
        return static_cast<int>(cudaGetLastError());
    }
    if (design != kRows || workspace == nullptr || e >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n * d == 0) return 0;
    int32_t* vedge = workspace;
    int32_t* vid = vedge + e;
    int32_t* meta = vid + e;
    k2_index<<<1, kIndexThreads, 0, st>>>(ids, e, n, vedge, vid, meta);
    int tpr = 32;
    while (tpr < d && tpr < kThreads) tpr *= 2;
    const long long rows_per_block = kThreads / tpr * kRowsPerGroup;
    const long long blocks = (n + rows_per_block - 1) / rows_per_block;
    k2_rows<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        msgs, vedge, vid, meta, out, d, n, tpr);
    if (total > 0) {
        long long grid = (total + kThreads - 1) / kThreads;
        if (grid > kScatterBlocks) grid = kScatterBlocks;
        k2_scatter<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
            msgs, vedge, vid, meta, out, d);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename Id, int VEC>
int launch_grad_vec(const float* grad, const Id* ids, float* out,
                    long long e, long long d, long long n, cudaStream_t st) {
    const long long dv = d / VEC;
    int shift = 0;
    while (shift < 5 && (1LL << shift) < dv) ++shift;
    const long long rows_per_block =
        static_cast<long long>(kThreads / 32) * (32 >> shift) * kGradRows;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap =
        static_cast<long long>(sms) * (2048 / kThreads) * kGradWaves;
    long long blocks = (e + rows_per_block - 1) / rows_per_block;
    if (blocks > cap) blocks = cap;
    k2_grad<Id, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        grad, ids, out, e, dv, n, shift);
    return static_cast<int>(cudaGetLastError());
}

template <typename Id>
int launch_grad(const float* grad, const Id* ids, float* out, long long e,
                long long d, long long n, int vec, cudaStream_t st) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(grad)
                           | reinterpret_cast<uintptr_t>(out);
    if ((vec != 1 && vec != 2 && vec != 4) || d % vec != 0
        || ptrs % (4 * vec) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (e * d == 0) return 0;
    if (vec == 4) return launch_grad_vec<Id, 4>(grad, ids, out, e, d, n, st);
    if (vec == 2) return launch_grad_vec<Id, 2>(grad, ids, out, e, d, n, st);
    return launch_grad_vec<Id, 1>(grad, ids, out, e, d, n, st);
}

}  // namespace

// Sum `msgs` (device pointer, f32[e, d] row-major) into `out` (device
// pointer, f32[n, d]) by `ids` (device pointer, e ids: int64 if `ids_64`,
// else int32) on `stream` with `design`.  kAtomic takes `out` zero-filled
// by the caller and no workspace; kRows takes `out` as it is (every
// element is written) and an int32 workspace of 2e+2 entries.  Returns 0
// on success, a cudaError_t otherwise (cudaErrorInvalidValue for a
// negative size, n >= 2^31, an unknown design, or under kRows a missing
// workspace or e >= 2^31).
extern "C" int segment_sum_launch(const void* msgs, const void* ids,
                                  int ids_64, void* out, long long e,
                                  long long d, long long n, int design,
                                  void* workspace, void* stream) {
    if (e < 0 || d < 0 || n < 0 || n >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* m = static_cast<const float*>(msgs);
    auto* o = static_cast<float*>(out);
    auto* ws = static_cast<int32_t*>(workspace);
    const auto st = static_cast<cudaStream_t>(stream);
    if (ids_64)
        return launch(m, static_cast<const int64_t*>(ids), o, e, d, n, design,
                      ws, st);
    return launch(m, static_cast<const int32_t*>(ids), o, e, d, n, design, ws,
                  st);
}

// The backward: gather `grad` (device pointer, f32[n, d] row-major) by
// `ids` (device pointer, e ids: int64 if `ids_64`, else int32) into
// `grad_msgs` (device pointer, f32[e, d]), zero rows where an id lies
// outside [0, n), on `stream`, in vectors of `vec` floats.  Every element
// of `grad_msgs` is written.  Returns 0 on success, a cudaError_t
// otherwise (cudaErrorInvalidValue for a negative size, n >= 2^31, or a
// `vec` other than 1, 2 or 4, one that does not divide d, or one whose
// 4*vec bytes either pointer is not aligned to).
extern "C" int segment_sum_grad_launch(const void* grad, const void* ids,
                                       int ids_64, void* grad_msgs,
                                       long long e, long long d, long long n,
                                       int vec, void* stream) {
    if (e < 0 || d < 0 || n < 0 || n >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* g = static_cast<const float*>(grad);
    auto* o = static_cast<float*>(grad_msgs);
    const auto st = static_cast<cudaStream_t>(stream);
    if (ids_64)
        return launch_grad(g, static_cast<const int64_t*>(ids), o, e, d, n,
                           vec, st);
    return launch_grad(g, static_cast<const int32_t*>(ids), o, e, d, n, vec,
                       st);
}

// Text of a cudaError_t, for the wrapper's exception message.
extern "C" const char* segment_sum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
