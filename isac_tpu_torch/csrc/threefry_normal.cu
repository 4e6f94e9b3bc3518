// Threefry-2x32 normal draws for Hopper (sm_90a): one launch writes a whole
// complex64 noise draw, jax.random's bits and normals in native uint32.
//
// Replaces no TPU kernel. The JAX package draws its noise through
// jax.random (split, then two float32 normals), which XLA lowers itself. The
// port's plain version, isac_tpu_torch/utils/prng.py, computes the same
// function in int64 tensor passes with a mask after every add and rotation:
// ~490 launches a complex draw, and int64 temporaries of 8 bytes a word. This
// kernel computes, per output element i, what those passes compute:
//   - Threefry-2x32 (20 rounds, rotations (13, 15, 26, 6) and
//     (17, 29, 16, 24), key schedule with parity 0x1BD11BDA) of the counter
//     words (i >> 32, i & 0xffffffff) under key kr and under key ki, and
//     bits = y0 ^ y1 of each;
//   - the uniform in (nextafter(-1, 0), 1) from the top 23 bits;
//   - Giles' single-precision erf_inv with w = -log1pf(-x*x) and XLA's two
//     coefficient tables, times sqrt(2), times `scale`;
// and stores re (from kr) and im (from ki) interleaved.
//
// What bounds it: integer throughput, not bytes. A complex element takes two
// threefry blocks (~75 uint32 operations each) and two erf_inv (~40 float
// operations each with log1pf) against 8 bytes written; at the post-pass's
// 19.7M elements that is ~3 G integer operations, ~0.2 ms at Hopper's INT32
// rate, against 0.05 ms of writes at 3.35 TB/s. The design does that work in
// one pass with no traffic but the output: no temporaries, no chunks, one
// thread per element in a grid-stride loop whose grid the caller sizes from
// n (one block for a few hundred elements, a full wave of the card for the
// post-pass). Rotations are funnel shifts.
//
// Exactness: the kernel is bit-equal on the card to the plain version.
// Every float rounding sits where the plain version's tensor passes put it:
// __fmul_rn / __fadd_rn / __fsub_rn / __fsqrt_rn (never contracted into an
// FMA; the library is also built with --fmad=false), the constants are the
// float32 values torch rounds the plain version's Python scalars to (written
// in hex), and the multiplies by sqrt(2) and by `scale` stay two multiplies.
// log1pf is the toolkit's; PERF.md gives how it compares with torch's log1p
// on the card, over all 2^23 uniforms (threefry_normal_table).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define KS_PARITY 0x1BD11BDAu

// jax.random.uniform's range for normal draws, (nextafter(-1, 0), 1): the
// plain version's _LO and _SPAN in float32
#define U_LO (-0x1.fffffep-1f)
#define U_SPAN 2.0f
#define SQRT2 0x1.6a09e6p+0f

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

#define ROUND(r)   \
  x0 += x1;        \
  x1 = rotl(x1, r) ^ x0;

// The 32-bit word of jax.random.bits at counter (x0, x1): y0 ^ y1 of the
// Threefry-2x32 block under key (k0, k1).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ KS_PARITY;
  x0 += k0;
  x1 += k1;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

// The top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
// shifted, clamped at the low end (prng.uniform_from_bits).
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(__fadd_rn(__fmul_rn(f, U_SPAN), U_LO), U_LO);
}

// Giles' polynomial in XLA's form (prng.erf_inv): p = c_k + p * w, k = 1..8,
// from c_0; the small branch for w < 5 with w - 2.5, the large one with
// sqrt(w) - 3.
__device__ __forceinline__ float erf_inv(float x) {
  const float w = -log1pf(__fmul_rn(-x, x));
  const bool small = w < 5.0f;
  const float t = small ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p;
#define TERM(s, l) p = __fadd_rn(small ? (s) : (l), __fmul_rn(p, t));
  p = small ? 0x1.e2cb1p-26f : -0x1.a3e136p-13f;
  TERM(0x1.70966cp-22f, 0x1.a76ad6p-14f)
  TERM(-0x1.d8e6aep-19f, 0x1.61b8e4p-10f)
  TERM(-0x1.26b582p-18f, -0x1.e17bcep-9f)
  TERM(0x1.ca65b6p-13f, 0x1.7824f6p-8f)
  TERM(-0x1.48a81p-10f, -0x1.f38baep-8f)
  TERM(-0x1.11c9dep-8f, 0x1.354afcp-7f)
  TERM(0x1.f91ec6p-3f, 0x1.006db6p+0f)
  TERM(0x1.805c5ep+0f, 0x1.6a9efcp+1f)
#undef TERM
  return __fmul_rn(p, x);
}

__device__ __forceinline__ float normal_of(uint32_t bits) {
  return __fmul_rn(erf_inv(uniform_of(bits)), SQRT2);
}

// WHAT 0: scaled normals; 1: the 32-bit words, stored as their bit patterns
// (the checks' view of the kernel's threefry).
template <int WHAT>
__global__ void __launch_bounds__(THREADS) threefry_normal_kernel(
    float2* __restrict__ out, unsigned long long n, uint32_t kr0, uint32_t kr1,
    uint32_t ki0, uint32_t ki1, float scale) {
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  for (unsigned long long i = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride) {
    const uint32_t hi = (uint32_t)(i >> 32), lo = (uint32_t)i;
    const uint32_t br = threefry_bits(kr0, kr1, hi, lo);
    const uint32_t bi = threefry_bits(ki0, ki1, hi, lo);
    float2 v;
    if (WHAT == 0) {
      v.x = __fmul_rn(normal_of(br), scale);
      v.y = __fmul_rn(normal_of(bi), scale);
    } else {
      v.x = __uint_as_float(br);
      v.y = __uint_as_float(bi);
    }
    out[i] = v;
  }
}

// The uniform and the normal (unscaled) of each of the 2^23 words that
// differ in their top 23 bits: word j << 9 at index j.
__global__ void __launch_bounds__(THREADS) threefry_normal_table_kernel(
    float* __restrict__ uniform, float* __restrict__ normal) {
  const uint32_t j = blockIdx.x * THREADS + threadIdx.x;
  if (j < (1u << 23)) {
    uniform[j] = uniform_of(j << 9);
    normal[j] = normal_of(j << 9);
  }
}

// Plain C entry point (loaded with ctypes). out: n complex64 values
// (float2); (kr0, kr1), (ki0, ki1): the keys of the real and the imaginary
// part; what: 0 normals times `scale`, 1 words; blocks: the grid
// (the loop strides over it). Launches on `stream` without synchronising and
// returns the cudaError_t of the launch.
extern "C" int threefry_complex_normal(void* out, long long n, unsigned kr0,
                                       unsigned kr1, unsigned ki0, unsigned ki1,
                                       float scale, int what, int blocks,
                                       void* stream) {
  if (n < 0 || blocks < 1 || what < 0 || what > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  float2* o = reinterpret_cast<float2*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned long long m = (unsigned long long)n;
  if (what == 0)
    threefry_normal_kernel<0><<<blocks, THREADS, 0, s>>>(o, m, kr0, kr1, ki0, ki1, scale);
  else
    threefry_normal_kernel<1><<<blocks, THREADS, 0, s>>>(o, m, kr0, kr1, ki0, ki1, scale);
  return (int)cudaGetLastError();
}

// Plain C entry point: uniform, normal [2^23] float32 (see the kernel above).
extern "C" int threefry_normal_table(float* uniform, float* normal, void* stream) {
  threefry_normal_table_kernel<<<(1 << 23) / THREADS, THREADS, 0,
                                 (cudaStream_t)stream>>>(uniform, normal);
  return (int)cudaGetLastError();
}
