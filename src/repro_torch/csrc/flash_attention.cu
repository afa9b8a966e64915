// Blocked causal GQA attention with online softmax, for Hopper (sm_90a):
//
//     o[b, h, i, :] = softmax_j( scale * q[b, h, i, :] . k[b, h/g, j, :] ) v[b, h/g, j, :]
//
// over the keys j < kv_len with (if causal) j <= i + offset, g = Hq / Hkv.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_blocked (body _flash_kernel).  That kernel walks a
// sequential KV grid axis and carries the running max m, denominator l and
// accumulator acc in VMEM scratch from one grid step to the next; on the
// card blocks run in no order, so one block keeps (m, l, acc) in registers
// and walks the KV tiles in a loop of its own.  The same contract holds:
// query head h reads KV head h / g with no repeat of K/V in memory, the
// causal mask uses the decode convention (row i sees keys <= i + offset),
// keys at or beyond kv_len are masked, a row that sees no key is written
// as 0, sums are f32 and the output has the input's type.  Unlike the TPU
// kernel, the masked score is -inf rather than -1e30, so a fully masked
// row really gets l == 0 and is written as 0 (with -1e30, exp(s - m) is 1
// for every masked key and such a row gets the mean of its padded V).
//
// Bound.  Prefill (Sq = Skv = S) does 4 * B * Hq * Dh * S(S+1)/2 flops
// against 2 bytes per element of q, k, v and o: 1.6e10 flops for 42 MB at
// smollm-360m's served shape, so the tensor cores' bf16 rate (989 TFLOP/s)
// bounds it at 0.016 ms.  Decode (Sq = 1) reads the live K/V once (11 MB
// at 1087 positions) and does 300x fewer flops: HBM bandwidth bounds it at
// about 3.3 us, less than a launch.
//
// What this first design does (simple and right first: CUDA cores, no
// tensor cores, no TMA):
//   * a block serves one (batch, KV head) and a run of query rows of the
//     group's heads, rows ordered position-major (row r = position r / g,
//     head r % g), so one K/V tile in shared memory feeds every head of
//     the group and the rows of a block share nearly one causal extent;
//     key tiles past the block's last visible key are never loaded;
//   * K/V tiles are converted to f32 once, on the way into shared memory;
//   * a row belongs to Dh/16 neighbouring threads, each holding 16 of its
//     q and acc elements in registers as four float4 chunks interleaved
//     so the group's shared-memory reads hit distinct banks; a score is a
//     partial dot product summed by an xor butterfly (all lanes end with
//     bit-identical sums), and the online-softmax update runs once per
//     16 keys;
//   * decode (few rows): the block's row slots are split into nsplit
//     groups that take disjoint slices of each KV tile (a split inside the
//     block, not across blocks), merged through shared memory at the end,
//     so Sq = 1 does not pad Q to a 64-row tile;
//   * every operand is addressed by explicit element strides (batch,
//     head, sequence), the last dimension contiguous, so the caller can
//     pass [B, S, H, Dh] views and a strided view of a KV cache with no
//     transpose copy.
// Tensor-core products (mma.sync / wgmma), TMA and a split of decode
// across blocks are left for later.
//
// Plain C interface (loaded with ctypes): the launcher enqueues on the
// stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;     // keys per online-softmax update

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
    int hq, hkv, sq, offset, kv_len, causal, nsplit;
    float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
}

// 16 bytes of T (4 floats or 8 bf16) as f32, written to dst.
__device__ __forceinline__ void unpack_store(float* dst, uint4 u, float) {
    store4(dst, make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                            __uint_as_float(u.z), __uint_as_float(u.w)));
}

__device__ __forceinline__ void unpack_store(float* dst, uint4 u,
                                             __nv_bfloat16) {
    store4(dst, make_float4(__uint_as_float(u.x << 16),
                            __uint_as_float(u.x & 0xffff0000u),
                            __uint_as_float(u.y << 16),
                            __uint_as_float(u.y & 0xffff0000u)));
    store4(dst + 4, make_float4(__uint_as_float(u.z << 16),
                                __uint_as_float(u.z & 0xffff0000u),
                                __uint_as_float(u.w << 16),
                                __uint_as_float(u.w & 0xffff0000u)));
}

// Keys [j0, j0 + KT) of one (batch, KV head) into dst[KT][DH] as f32;
// keys at or beyond kend are zero-filled (they are masked anyway).
template <typename T, int DH, int KT>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long sj, int j0, int kend) {
    constexpr int kVec = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = DH / kVec;
    constexpr int kPer = KT * kPerRow / kThreads;
    constexpr int kBatch = kPer < 8 ? kPer : 8;
    static_assert(kPer % kBatch == 0, "tile does not split evenly");
#pragma unroll
    for (int b0 = 0; b0 < kPer; b0 += kBatch) {
        uint4 buf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = (b0 + u) * kThreads + threadIdx.x;
            const int j = j0 + idx / kPerRow;
            const int col = (idx % kPerRow) * kVec;
            buf[u] = j < kend
                ? __ldg(reinterpret_cast<const uint4*>(base + j * sj + col))
                : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = (b0 + u) * kThreads + threadIdx.x;
            unpack_store(dst + (idx / kPerRow) * DH + (idx % kPerRow) * kVec,
                         buf[u], T());
        }
    }
}

template <typename T, int DH, int KT>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const Params p) {
    constexpr int kNT = DH / 16;            // threads per query row
    constexpr int kC4 = 4;                  // float4 chunks per thread
    constexpr int kRS = kThreads / kNT;     // row slots per block
    extern __shared__ float4 smem4[];
    float* ks_tile = reinterpret_cast<float*>(smem4);
    float* vs_tile = ks_tile + KT * DH;
    float* merge = vs_tile + KT * DH;       // kRS x (DH + 4)

    const int group = p.hq / p.hkv;
    const int b = blockIdx.y / p.hkv;
    const int kvh = blockIdx.y % p.hkv;
    const int total_rows = group * p.sq;
    const int nsplit = p.nsplit;
    const int rpb = kRS / nsplit;           // rows per block
    const int ks = KT / nsplit;             // keys per split per tile
    // the longest causal extents first
    const int r0 = (gridDim.x - 1 - blockIdx.x) * rpb;
    const int gi = threadIdx.x / kNT;
    const int sub = threadIdx.x % kNT;
    const int split = gi / rpb;
    const int rslot = gi % rpb;
    const int r = r0 + rslot;
    const bool row_ok = r < total_rows;
    const int i = row_ok ? r / group : 0;
    const int h = kvh * group + (row_ok ? r % group : 0);
    const int qpos = i + p.offset;

    int kend = p.kv_len;
    if (p.causal) {
        const int last = min(r0 + rpb, total_rows) - 1;
        kend = min(kend, last / group + p.offset + 1);
    }

    const T* qp = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh
                  + static_cast<long long>(i) * p.qss;
    float4 qv[kC4];
#pragma unroll
    for (int c = 0; c < kC4; ++c)
        qv[c] = row_ok ? load4(qp + (c * kNT + sub) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc[kC4];
#pragma unroll
    for (int c = 0; c < kC4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = -INFINITY;
    float l = 0.f;

    const T* kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksh;
    const T* vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsh;
    for (int j0 = 0; j0 < kend; j0 += KT) {
        __syncthreads();                    // the last tile is consumed
        load_tile<T, DH, KT>(ks_tile, kb, p.kss, j0, kend);
        load_tile<T, DH, KT>(vs_tile, vb, p.vss, j0, kend);
        __syncthreads();
        for (int c0 = 0; c0 < ks; c0 += kChunk) {
            float s[kChunk];
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                const bool in_split = c0 + jj < ks;
                const int kk = in_split ? split * ks + c0 + jj : 0;
                const float* kr = ks_tile + kk * DH;
                float dot = 0.f;
#pragma unroll
                for (int c = 0; c < kC4; ++c) {
                    const float4 k4 = load4(kr + (c * kNT + sub) * 4);
                    dot = fmaf(qv[c].x, k4.x, dot);
                    dot = fmaf(qv[c].y, k4.y, dot);
                    dot = fmaf(qv[c].z, k4.z, dot);
                    dot = fmaf(qv[c].w, k4.w, dot);
                }
#pragma unroll
                for (int o = kNT / 2; o > 0; o >>= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                const int j = j0 + kk;
                const bool ok = row_ok && in_split && j < p.kv_len
                                && (!p.causal || j <= qpos);
                s[jj] = ok ? dot * p.scale : -INFINITY;
            }
            float mt = s[0];
#pragma unroll
            for (int jj = 1; jj < kChunk; ++jj) mt = fmaxf(mt, s[jj]);
            const float mn = fmaxf(m, mt);
            const float mu = mn == -INFINITY ? 0.f : mn;
            const float alpha = expf(m - mu);
            float ps = 0.f;
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                s[jj] = expf(s[jj] - mu);
                ps += s[jj];
            }
            l = fmaf(l, alpha, ps);
#pragma unroll
            for (int c = 0; c < kC4; ++c) {
                acc[c].x *= alpha; acc[c].y *= alpha;
                acc[c].z *= alpha; acc[c].w *= alpha;
            }
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                const int kk = c0 + jj < ks ? split * ks + c0 + jj : 0;
                const float* vr = vs_tile + kk * DH;
#pragma unroll
                for (int c = 0; c < kC4; ++c) {
                    const float4 v4 = load4(vr + (c * kNT + sub) * 4);
                    acc[c].x = fmaf(s[jj], v4.x, acc[c].x);
                    acc[c].y = fmaf(s[jj], v4.y, acc[c].y);
                    acc[c].z = fmaf(s[jj], v4.z, acc[c].z);
                    acc[c].w = fmaf(s[jj], v4.w, acc[c].w);
                }
            }
            m = mn;
        }
    }

    if (nsplit > 1) {                       // merge the splits' states
        float* mine = merge + gi * (DH + 4);
#pragma unroll
        for (int c = 0; c < kC4; ++c) store4(mine + (c * kNT + sub) * 4, acc[c]);
        if (sub == 0) {
            mine[DH] = m;
            mine[DH + 1] = l;
        }
        __syncthreads();
        if (split == 0) {
            float mx = -INFINITY;
            for (int s2 = 0; s2 < nsplit; ++s2)
                mx = fmaxf(mx, merge[(s2 * rpb + rslot) * (DH + 4) + DH]);
            const float mu = mx == -INFINITY ? 0.f : mx;
            l = 0.f;
#pragma unroll
            for (int c = 0; c < kC4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int s2 = 0; s2 < nsplit; ++s2) {
                const float* other = merge + (s2 * rpb + rslot) * (DH + 4);
                const float w = expf(other[DH] - mu);
                l = fmaf(other[DH + 1], w, l);
#pragma unroll
                for (int c = 0; c < kC4; ++c) {
                    const float4 a = load4(other + (c * kNT + sub) * 4);
                    acc[c].x = fmaf(w, a.x, acc[c].x);
                    acc[c].y = fmaf(w, a.y, acc[c].y);
                    acc[c].z = fmaf(w, a.z, acc[c].z);
                    acc[c].w = fmaf(w, a.w, acc[c].w);
                }
            }
        }
    }

    if (split == 0 && row_ok) {
        T* op = static_cast<T*>(p.o) + b * p.osb + h * p.osh
                + static_cast<long long>(i) * p.oss;
        const bool seen = l > 0.f;
#pragma unroll
        for (int c = 0; c < kC4; ++c) {
            const float4 a = acc[c];
            store4(op + (c * kNT + sub) * 4,
                   seen ? make_float4(a.x / l, a.y / l, a.z / l, a.w / l)
                        : make_float4(0.f, 0.f, 0.f, 0.f));
        }
    }
}

template <typename T, int DH, int KT>
int launch(const Params& p, int batch, cudaStream_t stream) {
    constexpr int kNT = DH / 16;
    constexpr int kRS = kThreads / kNT;
    const size_t smem = (2 * KT * DH + kRS * (DH + 4)) * sizeof(float);
    static bool attr_set = false;
    if (!attr_set && smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_attention_fwd<T, DH, KT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        attr_set = true;
    }
    const int rpb = kRS / p.nsplit;
    const int total_rows = (p.hq / p.hkv) * p.sq;
    const dim3 grid((total_rows + rpb - 1) / rpb, batch * p.hkv);
    flash_attention_fwd<T, DH, KT><<<grid, kThreads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dh(Params& p, int batch, cudaStream_t stream) {
    constexpr int kRS = kThreads / (DH / 16);
    const int total_rows = (p.hq / p.hkv) * p.sq;
    // few rows (decode): split each KV tile among row-slot groups
    int nsplit = 1;
    if (total_rows < kRS) {
        int rows = 1;
        while (rows < total_rows) rows <<= 1;
        nsplit = kRS / rows;
    }
    if (nsplit > 1) {
        p.nsplit = nsplit < 32 ? nsplit : 32;   // >= 4 keys per split
        return launch<T, DH, 128>(p, batch, stream);
    }
    p.nsplit = 1;
    return launch<T, DH, 64>(p, batch, stream);
}

}  // namespace

// Attention of q (device pointer, [batch, hq, sq, dh] at element strides
// qsb/qsh/qss, last dimension contiguous) over k and v ([batch, hkv, *,
// dh] at their strides) into o ([batch, hq, sq, dh] at its strides), all
// of one type: f32 (is_bf16 = 0) or bf16.  Keys j < kv_len are seen, and
// with causal != 0 only j <= i + offset for query row i.  dh must be 64 or
// 128, hq a multiple of hkv, every stride and base 16-byte aligned (the
// wrapper checks).  Returns 0 on success, a cudaError_t otherwise.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* o,
        long long qsb, long long qsh, long long qss,
        long long ksb, long long ksh, long long kss,
        long long vsb, long long vsh, long long vss,
        long long osb, long long osh, long long oss,
        int batch, int hq, int hkv, int sq, int dh, int offset, int kv_len,
        int causal, float scale, int is_bf16, void* stream) {
    if (batch < 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0
            || kv_len < 0 || (dh != 64 && dh != 128))
        return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0 || sq == 0) return 0;
    Params p{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
             osb, osh, oss, hq, hkv, sq, offset, kv_len, causal, 1, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dh == 64 ? launch_dh<__nv_bfloat16, 64>(p, batch, st)
                        : launch_dh<__nv_bfloat16, 128>(p, batch, st);
    return dh == 64 ? launch_dh<float, 64>(p, batch, st)
                    : launch_dh<float, 128>(p, batch, st);
}

// Text of a cudaError_t, for the wrapper's exception message.
extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
