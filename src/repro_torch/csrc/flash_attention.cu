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
// card blocks run in no order, so a block keeps (m, l, acc) in registers
// and walks its KV tiles in a loop of its own.  The contract is the TPU
// kernel's: query head h reads KV head h / g with no repeat of K/V in
// memory, the causal mask uses the decode convention (row i sees keys
// <= i + offset), keys at or beyond kv_len are masked, sums and running
// statistics are f32 and the output has the input's type.  A row that
// sees no key is written as 0: masked scores are -inf (not the TPU
// kernel's -1e30, which gives such a row the mean of its padded V).
// Every operand is addressed by explicit element strides (batch, head,
// sequence) with the last dimension contiguous, so the caller passes
// [B, S, H, Dh] views and a strided view of a KV cache with no copy.
//
// Three designs sit behind one launcher; the wrapper
// (kernels/flash_attention/ops.py::plan) picks one per call from the
// dtype, the query rows per KV head (Sq * g), kv_len and Dh; the row
// count that separates the split design from the other two, and the
// number of key ranges, are decided there and nowhere else.
//
// tc_prefill (bf16, more rows).  Bound: operations.  At
// smollm-360m's served prefill (q [8,15,1024,64], k/v [8,5,1024,64],
// causal) a call does 1.61e10 FLOP against 42 MB: 0.0163 ms at the
// tensor cores' 989 TFLOP/s, 0.0125 ms at 3.35 TB/s.  The design:
//   * a block of two consumer warpgroups serves one (batch, KV head) and
//     128 query rows of the group's heads, position-major (row r is
//     position r / g, head r % g): one K/V tile in shared memory feeds
//     every head of the group (GQA packing kept: K/V are read once per
//     128 rows instead of once per head), and the block's rows share
//     nearly one causal extent; the blocks with the longest extent
//     launch first;
//   * S = Q K^T and O += P V run on the tensor cores as wgmma m64nNk16,
//     bf16 operands and f32 sums: Q and K from shared memory (K-major),
//     P from registers, V from shared memory read N-major (the transpose
//     flag), every tile in wgmma's 128-byte swizzle;
//   * the online softmax runs in registers on the accumulator fragment,
//     exp2f with scale * log2(e) folded in; the causal and kv_len mask
//     only on the tiles that cross the block's diagonal or the kv_len
//     edge; P is rounded to bf16 for P V (as the plain path's attn_p_bf16
//     arm does) while l sums the f32 P;
//   * K/V tiles of 64 keys stream through a ring of 3 (Dh 64) or 2
//     (Dh 128) stages in shared memory by cp.async 16-byte copies,
//     zero-filled past the block's last visible key, so the copies of
//     the next tiles overlap the products of this one; tiles past the
//     last visible key are never loaded.
//
// split_decode (few rows: decode and short chunks).  Bound: bytes.
// At the served decode step (q [8,1,15,64] over 1087 live positions of a
// [8,1088,5,64] cache) a call reads 11.2 MB of K/V: 3.3 us at 3.35 TB/s,
// and at 40 (batch, KV head) pairs one block per pair would leave most
// of the 132 SMs idle.  So:
//   * the keys are cut into nsplit ranges (the wrapper picks nsplit so
//     the grid covers the SMs at least twice and a range keeps >= 64
//     keys), one block per (batch, KV head, range) serving all Sq * g rows
//     of its KV head, reading K/V by 16-byte cp.async copies straight from
//     the strided cache view;
//   * bf16 runs the tensor-core block above with one warpgroup, its 64
//     rows padded with zeros: the tensor cores have time to spare here,
//     and a block on the CUDA cores is bound by the latency of its chains
//     of dependent shared-memory loads, FMAs and shuffles instead; f32
//     runs the fma block below over its key range, K/V kept f32 as they
//     lie (only the f32 correctness run takes it, so it shares that body
//     rather than having one of its own);
//   * both bodies take their range from blockIdx.z under one SPLIT
//     template flag and write the same partial (m in log2 units, l,
//     acc[Dh]) in f32 to a workspace the wrapper allocates; a second
//     small kernel merges the ranges, one warp per row (a range that sees
//     no key has m = -inf, l = 0; a row none of whose ranges sees a key
//     is written as 0).  With one range the block writes the output
//     itself: one launch.
//
// fma (f32, more rows).  Bound: operations, at the CUDA cores'
// 67 TFLOP/s: the JAX package holds f32 to 2e-4, which rules out TF32
// tensor-core products.  The first port's design: K/V tiles in shared
// memory, Dh/16 threads per query row holding q and acc in registers,
// partial dots summed by an xor butterfly, the online softmax once per 16
// keys.
//
// Left for later: a producer warp with TMA loads and the softmax of one
// tile overlapped with the products of the next (FlashAttention-3's
// pipelining) in tc_prefill; one launch for split_decode (the last block
// of a pair merging the ranges); f32 on the tensor cores (3xTF32).
//
// Plain C interface (loaded with ctypes): the launcher enqueues on the
// stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
    int hq, hkv, sq, offset, kv_len, causal;
    float scale;
};

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 fma4(float s, float4 v, float4 a) {
    return make_float4(fmaf(s, v.x, a.x), fmaf(s, v.y, a.y),
                       fmaf(s, v.z, a.z), fmaf(s, v.w, a.w));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (the
// source is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Set a kernel's dynamic shared-memory limit, once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, unsigned& done) {
    if (bytes <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32 && (done >> dev & 1u)) return 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) done |= 1u << dev;
    return 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (wgmma): tc_prefill, and split_decode in bf16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory (cp.async) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their other uses across this point nor reuse them.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4)
           | static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16
           | static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32
           | 1ull << 62;
}

// Byte offset of 16-byte chunk `ch` (along Dh) of row `row` in a
// [rows x Dh] bf16 tile kept as Dh/64 panels of [rows x 64]: each row of
// a panel is 128 bytes, its eight chunks XOR-swizzled by row % 8 (the
// 128-byte swizzle wgmma reads; the tile base is 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int ch, int rows) {
    return static_cast<uint32_t>((ch >> 3) * rows * 128 + row * 128
                                 + (((ch & 7) ^ (row & 7)) << 4));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B in shared
// memory with N contiguous (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
}

namespace tc {
constexpr int kKT = 64;                 // keys per tile

// NWG consumer warpgroups of 64 query rows each; SPLIT: the block takes
// one of gridDim.z key ranges and, with more than one, writes its
// partial (m, l, acc) to the workspace instead of the output.
template <int DH, int NWG, bool SPLIT>
struct Cfg {
    static constexpr int kThreads = 128 * NWG;
    static constexpr int kBM = 64 * NWG;               // query rows
    static constexpr int kStages = SPLIT || DH == 128 ? 2 : 3;
    static constexpr int kQBytes = kBM * DH * 2;
    static constexpr int kTileBytes = kKT * DH * 2;     // K or V
    static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes + 1024;
};

// keys [j0, j0 + kKT) of one (batch, KV head) into a swizzled tile;
// keys at or beyond kend are zero-filled
template <int DH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          long long sj, int j0, int kend) {
    constexpr int kCh = DH / 8;
    constexpr int kPer = kKT * kCh / NT;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
        const int idx = u * NT + threadIdx.x;
        const int row = idx / kCh, ch = idx % kCh;
        const int j = j0 + row;
        const bool ok = j < kend;
        cp_async16(dst + sw128(row, ch, kKT),
                   base + (ok ? j * sj + ch * 8 : 0), ok);
    }
}

template <int DH, int NWG, bool SPLIT>
__global__ void __launch_bounds__(128 * NWG, DH == 64 && NWG == 2 ? 2 : 1)
k3_tc(const Params p, float* ws) {
    using C = Cfg<DH, NWG, SPLIT>;
    constexpr int kThreads = C::kThreads, kBM = C::kBM;
    constexpr int kStages = C::kStages;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t sbase = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t s_q = sbase;
    const uint32_t s_kv = sbase + C::kQBytes;   // stage s: K, then V

    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int tq = lane % 4;
    const int group = p.hq / p.hkv;
    const int bh = blockIdx.x;
    const int b = bh / p.hkv;
    const int kvh = bh % p.hkv;
    const int total_rows = group * p.sq;
    const int r0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // longest first

    // this block's keys [ks0, ks1); kend: seen by some row of the block,
    // kfull: seen by every row
    int ks0 = 0, ks1 = p.kv_len;
    if (SPLIT) {
        const int kps = (p.kv_len + gridDim.z - 1) / gridDim.z;
        ks0 = blockIdx.z * kps;
        ks1 = min(p.kv_len, ks0 + kps);
    }
    const int first_pos = r0 / group;
    const int last_pos = (min(r0 + kBM, total_rows) - 1) / group;
    int kend = ks1, kfull = ks1;
    if (p.causal) {
        kend = min(kend, last_pos + p.offset + 1);
        kfull = min(kfull, first_pos + p.offset + 1);
    }
    const int ntiles = kend > ks0 ? (kend - ks0 + kKT - 1) / kKT : 0;

    // this thread's two accumulator rows and the keys each may see
    const int rloc = wg * 64 + warp * 16 + lane / 4;
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int i = (r0 + rloc + 8 * h) / group;
        lim[h] = p.causal ? min(ks1, i + p.offset + 1) : ks1;
    }

    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qsb
                     + static_cast<long long>(kvh) * group * p.qsh;
    const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksh;
    const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsh;

    // prologue: Q with tile 0, then tiles 1 .. kStages-2
    {
        constexpr int kCh = DH / 8;
        constexpr int kPer = kBM * kCh / kThreads;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
            const int idx = u * kThreads + tid;
            const int row = idx / kCh, ch = idx % kCh;
            const int r = r0 + row;
            const bool ok = r < total_rows;
            const bf16* src = qb + (ok ? (r % group) * p.qsh
                                         + static_cast<long long>(r / group)
                                           * p.qss + ch * 8
                                       : 0);
            cp_async16(s_q + sw128(row, ch, kBM), src, ok);
        }
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < ntiles) {
            const uint32_t st = s_kv + s * 2 * C::kTileBytes;
            load_tile<DH, kThreads>(st, kb, p.kss, ks0 + s * kKT, kend);
            load_tile<DH, kThreads>(st + C::kTileBytes, vb, p.vss,
                                    ks0 + s * kKT, kend);
        }
        cp_async_commit();
    }

    const float sl2 = p.scale * kLog2e;
    float o[DH / 2];
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) o[x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    float s[32];                        // S, then P, of the current tile
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;

    for (int t = 0; t < ntiles; ++t) {
        const int tn = t + kStages - 1;
        if (tn < ntiles) {
            const uint32_t st = s_kv + (tn % kStages) * 2 * C::kTileBytes;
            load_tile<DH, kThreads>(st, kb, p.kss, ks0 + tn * kKT, kend);
            load_tile<DH, kThreads>(st + C::kTileBytes, vb, p.vss,
                                    ks0 + tn * kKT, kend);
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();       // tile t (and Q) have landed
        fence_proxy_async();
        __syncthreads();
        const uint32_t s_k = s_kv + (t % kStages) * 2 * C::kTileBytes;
        const uint32_t s_v = s_k + C::kTileBytes;

        // S = Q K^T over this warpgroup's 64 rows and the tile's 64 keys
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            const uint32_t kofs = (kk % 4) * 32;
            const uint64_t dq = sw128_desc(
                s_q + (kk / 4) * kBM * 128 + wg * 64 * 128 + kofs, 16, 1024);
            const uint64_t dk = sw128_desc(
                s_k + (kk / 4) * kKT * 128 + kofs, 16, 1024);
            wgmma_ss_n64(s, dq, dk, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // scores in log2 units; the mask only where a row may not see a key
        const int j0 = ks0 + t * kKT;
        if (j0 + kKT > kfull) {
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = j0 + 8 * c + 2 * tq + (e & 1);
                    s[4 * c + e] = col < lim[e >> 1] ? s[4 * c + e] * sl2
                                                     : -INFINITY;
                }
        } else {
#pragma unroll
            for (int x = 0; x < 32; ++x) s[x] *= sl2;
        }

        // online softmax: rows lane/4 (h = 0) and lane/4 + 8 (h = 1), each
        // spread over the 4 lanes of a quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float mn = fmaxf(m[h], mx);
            const float mu = mn == -INFINITY ? 0.f : mn;
            const float alpha = exp2f(m[h] - mu);
            float ps = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float pv = exp2f(s[4 * c + 2 * h + e] - mu);
                    s[4 * c + 2 * h + e] = pv;
                    ps += pv;
                }
            l[h] = fmaf(l[h], alpha, ps);
            m[h] = mn;
#pragma unroll
            for (int c = 0; c < DH / 8; ++c) {
                o[4 * c + 2 * h] *= alpha;
                o[4 * c + 2 * h + 1] *= alpha;
            }
        }

        // P as bf16 A fragments: the accumulator layout of S is the A
        // layout of P V, 16 keys per fragment
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

        // O += P V
        pin(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv = sw128_desc(s_v + kk * 16 * 128, kKT * 128,
                                           1024);
            if constexpr (DH == 64)
                wgmma_rs_n64(o, pa[kk], dv);
            else
                wgmma_rs_n128(o, pa[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(o);
        pin(pa);
        __syncthreads();                    // stage t % kStages is free
    }
    cp_async_wait<0>();

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float lt = l[h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int r = r0 + rloc + 8 * h;
        if (r >= total_rows) continue;
        if (SPLIT && gridDim.z > 1) {       // partial (m, l, acc), f32
            const long long row = (static_cast<long long>(bh) * gridDim.z
                                   + blockIdx.z) * total_rows + r;
            float* acc = ws + row * DH;
#pragma unroll
            for (int c = 0; c < DH / 8; ++c)
                *reinterpret_cast<float2*>(acc + 8 * c + 2 * tq) =
                    make_float2(o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
            if (tq == 0) {
                float* ml = ws + static_cast<long long>(gridDim.x) * gridDim.z
                                 * total_rows * DH;
                ml[2 * row] = m[h];
                ml[2 * row + 1] = lt;
            }
            continue;
        }
        const int i = r / group;
        bf16* op = static_cast<bf16*>(p.o) + b * p.osb
                   + static_cast<long long>(kvh * group + r % group) * p.osh
                   + static_cast<long long>(i) * p.oss;
        const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
            *reinterpret_cast<uint32_t*>(op + 8 * c + 2 * tq) =
                pack_bf16(o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
    }
}

// tc_prefill: two warpgroups, 128 rows a block, every key
template <int DH>
int launch_prefill(const Params& p, int batch, cudaStream_t stream) {
    using C = Cfg<DH, 2, false>;
    static unsigned done = 0;
    const int rc = allow_smem(k3_tc<DH, 2, false>, C::kSmem, done);
    if (rc) return rc;
    const int total_rows = (p.hq / p.hkv) * p.sq;
    const dim3 grid(batch * p.hkv, (total_rows + C::kBM - 1) / C::kBM);
    k3_tc<DH, 2, false><<<grid, C::kThreads, C::kSmem, stream>>>(p, nullptr);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace tc

// ---------------------------------------------------------------------------
// fma: f32 on the CUDA cores (namespace cc), and split_decode in f32
// ---------------------------------------------------------------------------

namespace cc {
constexpr int kThreads = 128;
constexpr int kChunk = 16;              // keys per online-softmax update
constexpr int kKT = 64;                 // keys per tile

// Keys [j0, j0 + kKT) of one (batch, KV head) into dst[kKT][DH]; keys at
// or beyond kend are zero-filled (they are masked anyway).
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long sj, int j0, int kend) {
    constexpr int kPerRow = DH / 4;
    constexpr int kPer = kKT * kPerRow / kThreads;
    constexpr int kBatch = kPer < 8 ? kPer : 8;
    static_assert(kPer % kBatch == 0, "tile does not split evenly");
#pragma unroll
    for (int b0 = 0; b0 < kPer; b0 += kBatch) {
        float4 buf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = (b0 + u) * kThreads + threadIdx.x;
            const int j = j0 + idx / kPerRow;
            buf[u] = j < kend
                ? __ldg(reinterpret_cast<const float4*>(
                      base + j * sj + (idx % kPerRow) * 4))
                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int idx = (b0 + u) * kThreads + threadIdx.x;
            store4(dst + (idx / kPerRow) * DH + (idx % kPerRow) * 4, buf[u]);
        }
    }
}

// SPLIT: the block takes one of gridDim.z key ranges and, with more than
// one, writes its partial (m, l, acc) to the workspace instead of the
// output (the layout k3_tc's SPLIT blocks write).
template <int DH, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
k3_fma(const Params p, float* ws) {
    constexpr int kNT = DH / 16;            // threads per query row
    constexpr int kC4 = 4;                  // float4 chunks per thread
    constexpr int kRS = kThreads / kNT;     // rows per block
    extern __shared__ float4 smem4[];
    float* ks_tile = reinterpret_cast<float*>(smem4);
    float* vs_tile = ks_tile + kKT * DH;

    const int group = p.hq / p.hkv;
    const int bh = blockIdx.y;
    const int b = bh / p.hkv;
    const int kvh = bh % p.hkv;
    const int total_rows = group * p.sq;
    const int r0 = (gridDim.x - 1 - blockIdx.x) * kRS;   // longest first
    const int sub = threadIdx.x % kNT;
    const int r = r0 + threadIdx.x / kNT;
    const bool row_ok = r < total_rows;
    const int i = row_ok ? r / group : 0;
    const int h = kvh * group + (row_ok ? r % group : 0);
    const int qpos = i + p.offset;

    // this block's keys [ks0, ks1); kend: seen by some row of the block
    int ks0 = 0, ks1 = p.kv_len;
    if (SPLIT) {
        const int kps = (p.kv_len + gridDim.z - 1) / gridDim.z;
        ks0 = blockIdx.z * kps;
        ks1 = min(p.kv_len, ks0 + kps);
    }
    int kend = ks1;
    if (p.causal) {
        const int last = min(r0 + kRS, total_rows) - 1;
        kend = min(kend, last / group + p.offset + 1);
    }

    // a row's q and acc elements, four float4 chunks interleaved across
    // the row's kNT threads so their shared-memory reads hit distinct banks
    const float* qp = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh
                      + static_cast<long long>(i) * p.qss;
    float4 qv[kC4];
#pragma unroll
    for (int c = 0; c < kC4; ++c)
        qv[c] = row_ok ? load4(qp + (c * kNT + sub) * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc[kC4];
#pragma unroll
    for (int c = 0; c < kC4; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    float m = -INFINITY;                    // in log2 units
    float l = 0.f;
    const float sl2 = p.scale * kLog2e;

    const float* kb = static_cast<const float*>(p.k) + b * p.ksb + kvh * p.ksh;
    const float* vb = static_cast<const float*>(p.v) + b * p.vsb + kvh * p.vsh;
    for (int j0 = ks0; j0 < kend; j0 += kKT) {
        __syncthreads();                    // the last tile is consumed
        load_tile<DH>(ks_tile, kb, p.kss, j0, kend);
        load_tile<DH>(vs_tile, vb, p.vss, j0, kend);
        __syncthreads();
        for (int c0 = 0; c0 < kKT; c0 += kChunk) {
            float s[kChunk];
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                const float* kr = ks_tile + (c0 + jj) * DH;
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
                const int j = j0 + c0 + jj;
                const bool ok = row_ok && j < ks1
                                && (!p.causal || j <= qpos);
                s[jj] = ok ? dot * sl2 : -INFINITY;
            }
            float mt = s[0];
#pragma unroll
            for (int jj = 1; jj < kChunk; ++jj) mt = fmaxf(mt, s[jj]);
            const float mn = fmaxf(m, mt);
            const float mu = mn == -INFINITY ? 0.f : mn;
            const float alpha = exp2f(m - mu);
            float ps = 0.f;
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                s[jj] = exp2f(s[jj] - mu);
                ps += s[jj];
            }
            l = fmaf(l, alpha, ps);
#pragma unroll
            for (int c = 0; c < kC4; ++c) acc[c] = scale4(acc[c], alpha);
#pragma unroll
            for (int jj = 0; jj < kChunk; ++jj) {
                const float* vr = vs_tile + (c0 + jj) * DH;
#pragma unroll
                for (int c = 0; c < kC4; ++c)
                    acc[c] = fma4(s[jj], load4(vr + (c * kNT + sub) * 4),
                                  acc[c]);
            }
            m = mn;
        }
    }

    if (!row_ok) return;
    if (SPLIT && gridDim.z > 1) {           // partial (m, l, acc)
        const long long row = (static_cast<long long>(bh) * gridDim.z
                               + blockIdx.z) * total_rows + r;
#pragma unroll
        for (int c = 0; c < kC4; ++c)
            store4(ws + row * DH + (c * kNT + sub) * 4, acc[c]);
        if (sub == 0) {
            float* ml = ws + static_cast<long long>(gridDim.y) * gridDim.z
                             * total_rows * DH;
            ml[2 * row] = m;
            ml[2 * row + 1] = l;
        }
        return;
    }
    float* op = static_cast<float*>(p.o) + b * p.osb + h * p.osh
                + static_cast<long long>(i) * p.oss;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < kC4; ++c)
        store4(op + (c * kNT + sub) * 4, scale4(acc[c], inv));
}

template <int DH>
constexpr int smem_bytes() { return 2 * kKT * DH * 4; }

// fma (SPLIT = false): every key; split_decode in f32 (SPLIT = true):
// one of nsplit key ranges a block
template <int DH, bool SPLIT>
int launch(const Params& p, int batch, int nsplit, float* ws,
           cudaStream_t stream) {
    constexpr int kRS = kThreads / (DH / 16);
    static unsigned done = 0;
    const int rc = allow_smem(k3_fma<DH, SPLIT>, smem_bytes<DH>(), done);
    if (rc) return rc;
    const int total_rows = (p.hq / p.hkv) * p.sq;
    const dim3 grid((total_rows + kRS - 1) / kRS, batch * p.hkv, nsplit);
    k3_fma<DH, SPLIT><<<grid, kThreads, smem_bytes<DH>(), stream>>>(p, ws);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace cc

// ---------------------------------------------------------------------------
// split_decode: keys split across blocks, then a combine
// ---------------------------------------------------------------------------

namespace sd {
constexpr int kThreads = 128;

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Merge the nsplit partials of one row of one (batch, KV head): one warp
// per row, DH / 32 columns a lane; m in log2 units, a range that saw no
// key has m = -inf and l = 0 and weighs 0.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
k3_split_combine(const Params p, const float* ws, int nsplit) {
    constexpr int kW = DH / 32;
    const int bh = blockIdx.x;
    const int lane = threadIdx.x % 32;
    const int b = bh / p.hkv, kvh = bh % p.hkv;
    const int group = p.hq / p.hkv;
    const int rows = group * p.sq;
    const int r = blockIdx.y * (kThreads / 32) + threadIdx.x / 32;
    if (r >= rows) return;                  // the whole warp
    const long long row0 = static_cast<long long>(bh) * nsplit * rows + r;
    const float* ml = ws + static_cast<long long>(gridDim.x) * nsplit * rows
                           * DH;
    float mx = -INFINITY;
    for (int s = lane; s < nsplit; s += 32)
        mx = fmaxf(mx, ml[2 * (row0 + static_cast<long long>(s) * rows)]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lt = 0.f;
    float a[kW];
#pragma unroll
    for (int x = 0; x < kW; ++x) a[x] = 0.f;
#pragma unroll 4
    for (int s = 0; s < nsplit; ++s) {
        const long long row = row0 + static_cast<long long>(s) * rows;
        const float w = exp2f(ml[2 * row] - mu);    // 0: no key
        lt = fmaf(w, ml[2 * row + 1], lt);
        const float* src = ws + row * DH + lane * kW;
#pragma unroll
        for (int x = 0; x < kW; ++x) a[x] = fmaf(w, src[x], a[x]);
    }
    T* op = static_cast<T*>(p.o) + b * p.osb
            + static_cast<long long>(kvh * group + r % group) * p.osh
            + static_cast<long long>(r / group) * p.oss + lane * kW;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int x = 0; x < kW; x += 2) store2(op + x, a[x] * inv, a[x + 1] * inv);
}

// split_decode: the key ranges (bf16 on the tensor cores, one warpgroup a
// block; f32 on the CUDA cores), then the combine when there are several
template <typename T, int DH>
int launch(const Params& p, int batch, int nsplit, float* ws,
           cudaStream_t stream) {
    const int rows = (p.hq / p.hkv) * p.sq;
    int rc = 0;
    if constexpr (sizeof(T) == 2) {
        using C = tc::Cfg<DH, 1, true>;
        static unsigned done = 0;
        rc = allow_smem(tc::k3_tc<DH, 1, true>, C::kSmem, done);
        if (rc) return rc;
        const dim3 grid(batch * p.hkv, (rows + C::kBM - 1) / C::kBM, nsplit);
        tc::k3_tc<DH, 1, true><<<grid, C::kThreads, C::kSmem, stream>>>(p, ws);
        rc = static_cast<int>(cudaGetLastError());
    } else {
        rc = cc::launch<DH, true>(p, batch, nsplit, ws, stream);
    }
    if (rc != 0 || nsplit == 1) return rc;
    const dim3 cgrid(batch * p.hkv, (rows + kThreads / 32 - 1) / (kThreads / 32));
    k3_split_combine<T, DH><<<cgrid, kThreads, 0, stream>>>(p, ws, nsplit);
    return static_cast<int>(cudaGetLastError());
}
}  // namespace sd

enum Design { kTcPrefill = 0, kFma = 1, kSplitDecode = 2 };

}  // namespace

// Attention of q (device pointer, [batch, hq, sq, dh] at element strides
// qsb/qsh/qss, last dimension contiguous) over k and v ([batch, hkv, *,
// dh] at their strides) into o ([batch, hq, sq, dh] at its strides), all
// of one type: f32 (is_bf16 = 0) or bf16.  Keys j < kv_len are seen, and
// with causal != 0 only j <= i + offset for query row i.  dh must be 64 or
// 128, hq a multiple of hkv, every stride and base 16-byte aligned (the
// wrapper checks).  design: 0 tc_prefill (bf16 only), 1 fma (f32 only),
// 2 split_decode over nsplit >= 1 key ranges (workspace: nsplit > 1 needs
// batch * hkv * nsplit * rows * (dh + 2) floats of device memory, rows =
// sq * hq / hkv).  Which design and how many ranges a call gets is the
// wrapper's choice alone (kernels/flash_attention/ops.py::plan): every
// design takes any row count and key count.  Returns 0 on success, a cudaError_t
// otherwise.
extern "C" int flash_attention_launch(
        const void* q, const void* k, const void* v, void* o,
        long long qsb, long long qsh, long long qss,
        long long ksb, long long ksh, long long kss,
        long long vsb, long long vsh, long long vss,
        long long osb, long long osh, long long oss,
        int batch, int hq, int hkv, int sq, int dh, int offset, int kv_len,
        int causal, float scale, int is_bf16, int design, int nsplit,
        void* workspace, void* stream) {
    if (batch < 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0
            || kv_len < 0 || (dh != 64 && dh != 128))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool ok = design == kTcPrefill ? is_bf16 != 0
        : design == kFma ? is_bf16 == 0
        : design == kSplitDecode && nsplit >= 1
          && (nsplit == 1 || workspace != nullptr);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0 || sq == 0) return 0;
    const Params p{q, k, v, o, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
                   osb, osh, oss, hq, hkv, sq, offset, kv_len, causal, scale};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* ws = static_cast<float*>(workspace);
    if (design == kTcPrefill)
        return dh == 64 ? tc::launch_prefill<64>(p, batch, st)
                        : tc::launch_prefill<128>(p, batch, st);
    if (design == kFma)
        return dh == 64 ? cc::launch<64, false>(p, batch, 1, nullptr, st)
                        : cc::launch<128, false>(p, batch, 1, nullptr, st);
    if (is_bf16)
        return dh == 64 ? sd::launch<bf16, 64>(p, batch, nsplit, ws, st)
                        : sd::launch<bf16, 128>(p, batch, nsplit, ws, st);
    return dh == 64 ? sd::launch<float, 64>(p, batch, nsplit, ws, st)
                    : sd::launch<float, 128>(p, batch, nsplit, ws, st);
}

// Dynamic shared memory (bytes) a block of `design` requests at this dh
// and type, for reports; -1 for a combination the launcher refuses.
extern "C" int flash_attention_smem_bytes(int design, int dh, int is_bf16) {
    if (dh != 64 && dh != 128) return -1;
    const bool d64 = dh == 64;
    if (design == kTcPrefill && is_bf16)
        return d64 ? tc::Cfg<64, 2, false>::kSmem : tc::Cfg<128, 2, false>::kSmem;
    if ((design == kFma || design == kSplitDecode) && !is_bf16)
        return d64 ? cc::smem_bytes<64>() : cc::smem_bytes<128>();
    if (design == kSplitDecode)
        return d64 ? tc::Cfg<64, 1, true>::kSmem : tc::Cfg<128, 1, true>::kSmem;
    return -1;
}

// Text of a cudaError_t, for the wrapper's exception message.
extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
