// Layered (serial-C) normalized min-sum LDPC decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel isac_tpu/ops/ldpc_layered.py:_pallas_decoder, which
// keeps the posterior and every check-to-variable message of an 8-codeword
// tile resident in VMEM for the whole decode. On the H100 one BG1 Z=384
// codeword alone needs 104 KB of posterior and 485 KB of messages, so the
// messages cannot stay on chip.
//
// What bounds it here: message traffic. Each iteration reads and writes
// every edge message once, about 2*E*Z*4 bytes per codeword (1.94 MB for BG1
// Z=384), and the rows are a serial chain (46 dependent steps per iteration
// for BG1), so the kernel is latency-bound long before it is bandwidth-bound.
//
// What this design does about it (the simple, exact first version):
//   - one CTA per codeword, one thread per lane i of Z (ceil(Z/32)*32
//     threads, the ragged edge masked);
//   - the posterior [n_cols, Z] lives in dynamic shared memory for the whole
//     decode (104 KB for BG1 Z=384, hence the opt-in attribute above 48 KB),
//     so posterior traffic never leaves the SM;
//   - edge messages [B, E, Z] live in device memory (mostly L2-resident at
//     the main path's 116 codewords, ~56 MB), each lane reading and writing
//     its own column, so every access is coalesced;
//   - per row, each thread gathers t_e = post[c_e][(i+s_e)%Z] - msg[e][i]
//     into registers (the degree loop is fully unrolled to MAX_DEG), takes a
//     running min1/min2/argmin with strict '<' (the first index wins ties,
//     like jnp.argmin in the reference) and the sign product, and writes
//     msg[e][i] = ((norm*sprod)*sgn_e)*mag_e and post[c_e][(i+s_e)%Z] =
//     t_e + msg[e][i]. Within a row, thread i reads and writes exactly the
//     posterior positions it owns (the row's columns are distinct), so one
//     __syncthreads() between rows is the only barrier needed.
// The multiply order ((norm*sprod)*sgn)*mag matches the plain PyTorch version
// and the JAX reference; build with --fmad=false so that t + new is never
// contracted into an FMA and the posterior stays bit-equal to them.
//
// Left for later: messages compressed to min1/min2/arg/sign-word per
// (row, lane), several codewords per CTA, and filling all 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

// Register slots per row for t_e: the largest row degree of BG1 (BG2's is
// 10). The caller passes the plan's own maximum degree, and the entry point
// refuses a plan that does not fit.
#define MAX_DEG 19

__global__ void __launch_bounds__(384) ldpc_layered_kernel(
    const float* __restrict__ llr, float* __restrict__ out,
    float* __restrict__ msg, const int* __restrict__ row_ptr,
    const int* __restrict__ edge_col, const int* __restrict__ edge_shift,
    int n_rows, int n_cols, int n_edges, int z, int n_iter, float norm) {
  extern __shared__ float post[];  // [n_cols * z]
  const int i = threadIdx.x;
  const size_t cw = blockIdx.x;
  const int n_post = n_cols * z;
  const float* src = llr + cw * n_post;
  for (int j = i; j < n_post; j += blockDim.x) post[j] = src[j];
  __syncthreads();
  float* m = msg + cw * (size_t)n_edges * z;
  const bool active = i < z;
  for (int it = 0; it < n_iter; ++it) {
    for (int r = 0; r < n_rows; ++r) {
      if (active) {
        const int e0 = row_ptr[r];
        const int deg = row_ptr[r + 1] - e0;
        float t[MAX_DEG];
        float m1 = INFINITY, m2 = INFINITY, sprod = 1.0f;
        int arg = 0;
#pragma unroll
        for (int d = 0; d < MAX_DEG; ++d) {
          if (d < deg) {
            const int e = e0 + d;
            int j = i + edge_shift[e];
            if (j >= z) j -= z;
            const float v = post[edge_col[e] * z + j] - m[(size_t)e * z + i];
            t[d] = v;
            const float mag = fabsf(v);
            if (mag < m1) {
              m2 = m1;
              m1 = mag;
              arg = d;
            } else {
              m2 = fminf(m2, mag);
            }
            sprod = sprod * (v >= 0.0f ? 1.0f : -1.0f);
          }
        }
        const float ns = norm * sprod;
#pragma unroll
        for (int d = 0; d < MAX_DEG; ++d) {
          if (d < deg) {
            const int e = e0 + d;
            const float sgn = t[d] >= 0.0f ? 1.0f : -1.0f;
            const float nv = (ns * sgn) * (d == arg ? m2 : m1);
            m[(size_t)e * z + i] = nv;
            int j = i + edge_shift[e];
            if (j >= z) j -= z;
            post[edge_col[e] * z + j] = t[d] + nv;
          }
        }
      }
      __syncthreads();
    }
  }
  float* dst = out + cw * n_post;
  for (int j = i; j < n_post; j += blockDim.x) dst[j] = post[j];
}

// Plain C entry point (loaded with ctypes). llr/out [n_cw, n_cols, z] f32,
// msg [n_cw, n_edges, z] f32 zero-filled by the caller, row_ptr [n_rows+1],
// edge_col/edge_shift [n_edges] int32 in row order, max_deg the largest row
// degree of the plan. Launches on `stream` without synchronising; returns the
// cudaError_t of the launch (cudaErrorInvalidValue if max_deg > MAX_DEG).
extern "C" int ldpc_layered_decode(const float* llr, float* out, float* msg,
                                   const int* row_ptr, const int* edge_col,
                                   const int* edge_shift, int n_cw, int n_rows,
                                   int n_cols, int n_edges, int max_deg, int z,
                                   int n_iter, float norm, void* stream) {
  if (max_deg > MAX_DEG) return (int)cudaErrorInvalidValue;
  const int smem = n_cols * z * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((z + 31) / 32) * 32;
  ldpc_layered_kernel<<<n_cw, threads, smem, (cudaStream_t)stream>>>(
      llr, out, msg, row_ptr, edge_col, edge_shift, n_rows, n_cols, n_edges,
      z, n_iter, norm);
  return (int)cudaGetLastError();
}
