// jax.random's draws on the card, bit for bit: flax's dropout and
// jax.random.uniform, for Hopper (sm_90a), bound to Python through a plain
// C interface (ops/prng.py loads it with ctypes).
//
// No Pallas kernel of page_segmentation_tpu is replaced: the JAX package
// draws these in XLA (flax nn.Dropout in models/unet.py, jax.random.uniform
// and bernoulli in data/augment_device.py).  The draws are JAX's
// threefry-2x32 (20 rounds) with jax_threefry_partitionable: element i
// hashes the 64-bit counter (i >> 32, i & 0xffffffff) under the key
// (k0, k1); its 32 random bits are the two output words XORed, and its
// float in [0, 1) is ((bits >> 9) | 0x3F800000) as float32, minus 1.  A
// float64 tensor (JAX's 64-bit mode) takes the 64 bits w0 << 32 | w1 and a
// float64 from their top 52.
//
// ps_jax_dropout: y = keep ? x / keep_prob : 0 over an NCHW tensor, with
// flax's mask drawn over the NHWC index ((n * H + h) * W + w) * C + c.  One
// pass reads x once and writes y once; the backward runs the same pass on
// dy under the same key, so no mask is stored.  The grid's y dimension walks
// the (n, c) planes and its x dimension the pixels of a plane, so a warp
// reads 32 neighbouring elements of one plane and no thread divides a 64-bit
// index.  float32, bf16 (the division in float32, rounded to nearest even,
// as XLA's CPU code computes a bf16 division) and float64.
//
// ps_jax_uniform: out[i] = max(minval, fmaf(float_i, maxval - minval,
// minval)), the product and sum rounded once as XLA's CPU code contracts
// them.
//
// What bounds it: at the UNet train step's shapes (drop4 8 x 512 x 54 x 38,
// drop5 8 x 1024 x 27 x 19: 12.6 M elements) a pass moves 8 bytes an
// element in float32, 101 MB, 0.030 ms at 3.35 TB/s; but each element also
// runs ~80 integer operations of the hash, and the integer pipes, not the
// bytes, likely set its time.  On an H100 80GB HBM3 at 700 W the step's
// four passes take 0.173 ms alone, 2.9x their byte bound (chip_smoke.py
// phase_random).  A simple kernel first: one element a thread.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr long long kMaxBlocks = 16 * 132;  // 16 waves over the 132 SMs

struct Words {
    uint32_t w0, w1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// JAX's threefry-2x32 of the 64-bit counter i under (k0, k1).
__device__ __forceinline__ Words threefry(uint32_t k0, uint32_t k1, unsigned long long i) {
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
    uint32_t x1 = static_cast<uint32_t>(i) + k1;
#define PS_ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
    PS_ROUND(13) PS_ROUND(15) PS_ROUND(26) PS_ROUND(6)
    x0 += k1; x1 += k2 + 1u;
    PS_ROUND(17) PS_ROUND(29) PS_ROUND(16) PS_ROUND(24)
    x0 += k2; x1 += k0 + 2u;
    PS_ROUND(13) PS_ROUND(15) PS_ROUND(26) PS_ROUND(6)
    x0 += k0; x1 += k1 + 3u;
    PS_ROUND(17) PS_ROUND(29) PS_ROUND(16) PS_ROUND(24)
    x0 += k1; x1 += k2 + 4u;
    PS_ROUND(13) PS_ROUND(15) PS_ROUND(26) PS_ROUND(6)
    x0 += k2; x1 += k0 + 5u;
#undef PS_ROUND
    return {x0, x1};
}

__device__ __forceinline__ float unit32(Words b) {
    return __uint_as_float(((b.w0 ^ b.w1) >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double unit64(Words b) {
    const unsigned long long mantissa =
        (static_cast<unsigned long long>(b.w0) << 20) | (b.w1 >> 12);
    return __longlong_as_double(static_cast<long long>(mantissa | 0x3FF0000000000000ull)) - 1.0;
}

// The element's kept value, or 0, in each type.
struct Keep {
    float keep32, div32;
    double keep64;
};

__device__ __forceinline__ float apply(float x, Words b, const Keep& k) {
    return unit32(b) < k.keep32 ? x / k.div32 : 0.0f;
}

__device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 x, Words b, const Keep& k) {
    return unit32(b) < k.keep32 ? __float2bfloat16_rn(__bfloat162float(x) / k.div32)
                                : __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ double apply(double x, Words b, const Keep& k) {
    return unit64(b) < k.keep64 ? x / k.keep64 : 0.0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int planes, int C, long long HW,
               uint32_t k0, uint32_t k1, Keep keep) {
    const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (p >= HW) return;
    for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
        const int n = plane / C;
        const int c = plane - n * C;
        const unsigned long long counter =
            static_cast<unsigned long long>(n * HW + p) * C + c;
        const long long at = static_cast<long long>(plane) * HW + p;
        y[at] = apply(x[at], threefry(k0, k1, counter), keep);
    }
}

__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* __restrict__ out, long long n, uint32_t k0, uint32_t k1, float lo,
               float width) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride)
        out[i] = fmaxf(lo, fmaf(unit32(threefry(k0, k1, static_cast<unsigned long long>(i))),
                                width, lo));
}

template <typename T>
void launch_dropout(const void* x, void* y, int N, int C, int H, int W, uint32_t k0, uint32_t k1,
                    Keep keep, cudaStream_t s) {
    const long long HW = static_cast<long long>(H) * W;
    const int planes = N * C;
    const dim3 grid(static_cast<unsigned>((HW + kThreads - 1) / kThreads),
                    static_cast<unsigned>(planes < kMaxGridY ? planes : kMaxGridY));
    dropout_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                planes, C, HW, k0, k1, keep);
}

}  // namespace

extern "C" {

// x, y: N x C x H x W contiguous on the card, of type `dtype` (0 float32,
// 1 bf16, 2 float64), allocated by the caller.  keep32: keep_prob rounded
// to float32 (the mask's threshold); keep64: keep_prob (float64's
// threshold and divisor); div32: keep_prob rounded to x's type (the
// float32 and bf16 divisor).  Launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success).
int ps_jax_dropout(const void* x, void* y, int dtype, int N, int C, int H, int W, uint32_t k0,
                   uint32_t k1, float keep32, double keep64, float div32, void* stream) {
    if (N <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
    if (static_cast<long long>(N) * C > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Keep keep{keep32, div32, keep64};
    switch (dtype) {
        case 0: launch_dropout<float>(x, y, N, C, H, W, k0, k1, keep, s); break;
        case 1: launch_dropout<__nv_bfloat16>(x, y, N, C, H, W, k0, k1, keep, s); break;
        case 2: launch_dropout<double>(x, y, N, C, H, W, k0, k1, keep, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// out: n float32 on the card.  lo = float32(minval), width =
// float32(maxval) - lo in float32.  One kernel on `stream`; returns
// cudaGetLastError().
int ps_jax_uniform(float* out, long long n, uint32_t k0, uint32_t k1, float lo, float width,
                   void* stream) {
    if (n <= 0) return 0;
    const long long blocks = (n + kThreads - 1) / kThreads;
    uniform_kernel<<<static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(out, n, k0, k1, lo, width);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
