// CompBin vertex-id decode for Hopper (sm_90a) -- paper section IV, eq. (1):
//
//     id = OR_i  byte_i << 8i        (little-endian, b bytes per id)
//
// Replaces the TPU kernel src/repro/kernels/compbin_decode/kernel.py::
// _decode_kernel (and the planar staging transpose its wrapper needs).
//
// Bound: memory.  The function reads n*b packed bytes and writes n*4
// bytes of int32, and does one funnel shift and one mask per id, so the
// least time the card can take is  n*(b+4) / HBM bandwidth.
//
// What the design does about it:
//   * it reads the INTERLEAVED stream as it lies in the file -- no planar
//     transpose, no staging pass, no padding requirement: n and b are
//     run-time arguments and the output is int32[n];
//   * one thread decodes 4 consecutive ids: their 4*b bytes are exactly b
//     aligned 32-bit words (neighbouring threads read neighbouring
//     addresses, so a warp covers one contiguous 128*b-byte run), each id
//     is cut out of at most two of those words with a funnel shift in
//     registers, and the four results leave as ONE 16-byte store (a warp
//     writes 512 contiguous bytes);
//   * b = 3 is the unaligned case: ids straddle word boundaries, which
//     the funnel shift over (word k, word k+1) handles without a byte
//     load;
//   * the ragged tail (n % 4 ids) and a base pointer that is not aligned
//     (input to 4 bytes, output to 16) take a byte-wise path, one id per
//     thread;
//   * all indexing is 64-bit: one file of the paper's graphs holds more
//     than 2^31 edges, and 2^30 ids at b = 3 are 3 * 2^30 input bytes.
//
// Plain C interface (loaded with ctypes): the launcher enqueues on the
// stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so a refused launch surfaces in the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 30;   // grid-stride beyond this

// One id, byte by byte (tail and misaligned path).
template <int B>
__device__ __forceinline__ int32_t decode_bytes(const uint8_t* __restrict__ p) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < B; ++i) v |= static_cast<uint32_t>(p[i]) << (8 * i);
    return static_cast<int32_t>(v);
}

// Vector path: thread g decodes ids [4g, 4g+4) from words [B*g, B*g+B).
// Requires packed 4-byte aligned and out 16-byte aligned.  Ids
// [4*n_groups, n) are the tail, decoded byte-wise by the first threads
// of the grid.
template <int B>
__global__ void __launch_bounds__(kThreads)
decode_vec4(const uint8_t* __restrict__ packed, int32_t* __restrict__ out,
            long long n) {
    const long long n_groups = n >> 2;
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
    const uint32_t* __restrict__ words =
        reinterpret_cast<const uint32_t*>(packed);
    int4* __restrict__ out4 = reinterpret_cast<int4*>(out);
    constexpr uint32_t kMask = 0xFFFFFFFFu >> (32 - 8 * B);   // low B bytes

    for (long long g = tid; g < n_groups; g += stride) {
        uint32_t w[B];
#pragma unroll
        for (int k = 0; k < B; ++k) w[k] = __ldg(words + g * B + k);
        int32_t id[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            constexpr int kLast = B - 1;
            const int s = j * B;                   // first byte of id j
            const int k = s >> 2;                  // word holding it
            const uint32_t lo = w[k];
            const uint32_t hi = w[k < kLast ? k + 1 : kLast];
            id[j] = static_cast<int32_t>(
                __funnelshift_r(lo, hi, 8 * (s & 3)) & kMask);
        }
        out4[g] = make_int4(id[0], id[1], id[2], id[3]);
    }

    const long long tail0 = n_groups << 2;
    if (tid < n - tail0) {
        const long long i = tail0 + tid;
        out[i] = decode_bytes<B>(packed + i * B);
    }
}

// Byte-wise path for a misaligned base: one id per thread.
template <int B>
__global__ void __launch_bounds__(kThreads)
decode_scalar(const uint8_t* __restrict__ packed, int32_t* __restrict__ out,
              long long n) {
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
         i < n; i += stride)
        out[i] = decode_bytes<B>(packed + i * B);
}

template <int B>
cudaError_t launch(const uint8_t* packed, int32_t* out, long long n,
                   cudaStream_t stream) {
    const bool aligned =
        (reinterpret_cast<uintptr_t>(packed) & 3u) == 0 &&
        (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
    // vector path: one thread per 4 ids, and at least one block so the
    // tail (up to 3 ids) has threads to run on
    const long long items = aligned ? ((n >> 2) > 0 ? (n >> 2) : 1) : n;
    long long blocks = (items + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    const dim3 grid(static_cast<unsigned>(blocks));
    if (aligned)
        decode_vec4<B><<<grid, kThreads, 0, stream>>>(packed, out, n);
    else
        decode_scalar<B><<<grid, kThreads, 0, stream>>>(packed, out, n);
    return cudaGetLastError();
}

}  // namespace

// Decode n little-endian b-byte ids (b in 1..4) from `packed` (device
// pointer, n*b bytes) into `out` (device pointer, int32[n]) on `stream`.
// Returns 0 on success, a cudaError_t otherwise (cudaErrorInvalidValue
// for a b outside 1..4 or a negative n).
extern "C" int compbin_decode_launch(const void* packed, void* out,
                                     long long n, int b, void* stream) {
    if (n < 0 || b < 1 || b > 4) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const uint8_t* p = static_cast<const uint8_t*>(packed);
    int32_t* o = static_cast<int32_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (b) {
        case 1: return static_cast<int>(launch<1>(p, o, n, s));
        case 2: return static_cast<int>(launch<2>(p, o, n, s));
        case 3: return static_cast<int>(launch<3>(p, o, n, s));
        default: return static_cast<int>(launch<4>(p, o, n, s));
    }
}

// Text of a cudaError_t, for the wrapper's exception message.
extern "C" const char* compbin_decode_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
