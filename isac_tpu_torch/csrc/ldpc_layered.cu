// Layered (serial-C) normalized min-sum LDPC decoder for Hopper (sm_90a).
//
// Replaces the TPU kernel isac_tpu/ops/ldpc_layered.py:_pallas_decoder, which
// keeps the posterior and every check-to-variable message of an 8-codeword
// tile resident in VMEM for the whole decode. An H100 block has 227 KB of
// shared memory; one BG1 Z=384 codeword needs 104 KB of posterior and would
// need 485 KB of float messages, so the messages cannot stay on chip as they
// are.
//
// What bounds it here: the rows of the base graph are a serial chain (46
// dependent steps per sweep for BG1, each closed by a barrier), so the time is
// the length of one row step, not bytes or operations: one codeword alone
// takes as long as 116 on 116 SMs, and the time grows by the same amount with
// every sweep (PERF.md has the numbers). Whatever a row step waits for is paid
// 276 times in a 6-sweep BG1 decode, so the design takes off that chain what
// can be taken off it:
//   - the check-to-variable messages of a row are stored compressed, per
//     (row, lane), as three 32-bit words: min1, min2 (the two smallest
//     magnitudes, float) and one word holding a sign bit per edge (bits
//     0..18) and the index of the minimum (bits 19..23). A message is
//     ((norm*sprod)*sgn_e) * (e == arg ? min2 : min1), with sprod the parity
//     of the sign bits. norm*sprod and its product with sgn_e are sign flips
//     of norm, and a sign flip commutes with the rounding of the one true
//     multiply, so +-(ns*min1) and +-(ns*min2), two multiplies per row, give
//     every message of the row with the bits it was first made with. 212 KB
//     per BG1 Z=384 codeword instead of 485 KB of floats: 116 codewords stay
//     in L2 (16-byte records, tried, did not: they ran slower at 116);
//   - the three words of the NEXT row step are fetched into registers before
//     the arithmetic of the current one, so they arrive behind it: a lane
//     reads only what it wrote itself, a whole sweep earlier;
//   - the first sweep reads no message and subtracts none (all are zero, and
//     t = post - (+0.0) is post, bit for bit), so the caller need not clear
//     the scratch; the last sweep stores none, since nothing reads them;
//   - row pointers and a per-edge pair (byte offset of (col, shift), first
//     lane that wraps) are copied into shared memory once, so no global load
//     stands in front of an address and an address is a compare, a select
//     and an add;
//   - the row step is compiled once per row degree (1..19) with both passes
//     fully unrolled: all posterior reads of a row are issued together, the
//     values stay in registers, and the min1/min2 chain has no branch;
//   - the posterior [n_cols, Z] of each codeword lives in dynamic shared
//     memory for the whole decode, brought in with 16-byte asynchronous
//     copies where the addresses allow. Thread t of a CTA serves lane t % Z
//     of the CTA's codeword t / Z, so a small lifting size still fills its
//     warps, and the caller packs several codewords into a CTA when the batch
//     has more codewords than the card has SMs. At BG1 Z=384 a CTA needs
//     105 KB and 80 registers a thread, so two fit on an SM.
// Within a row, a thread reads and writes exactly the posterior positions it
// owns (the row's columns are distinct), so one __syncthreads() between rows
// is the only barrier.
//
// Exactness: the running min1/min2 uses strict '<' for the index (the first
// minimum wins, like jnp.argmin in the reference) and min/max selections for
// the values, which pick the same floats; the multiply order is the plain
// PyTorch version's and the JAX reference's up to the sign flips above. Build
// with --fmad=false so that t - old and t + new are never contracted into an
// FMA. NaN LLRs are not supported (the reference gives NaN posteriors too).
//
// Left for later: what remains is the row step itself, about 0.63 us at BG1
// Z=384 (one sweep of 46 rows in 0.029 ms, NVIDIA H100 80GB HBM3 at 700 W);
// ROADMAP.md, Queue 2, says what was tried on it.
// Neither unrolling the rows per base graph (no dispatch on the degree at
// all) nor fetching the state with cp.async shortened it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Sign bits in the packed word = the largest row degree taken (BG1's 19; BG2's
// is 10). The minimum's index sits above them.
#define SIGN_BITS 19
#define SIGN_MASK ((1u << SIGN_BITS) - 1u)
#define MAX_THREADS 384

// Bytes of the tables in front of the posteriors in shared memory, padded so
// that the posteriors start on a 16-byte boundary.
__host__ __device__ inline int table_bytes(int n_rows, int n_edges) {
  return (n_edges * (int)sizeof(int2) + (n_rows + 1) * (int)sizeof(int) + 15) &
         ~15;
}

// One row step of one lane. smem + pb: this lane's own position i in column 0
// of its codeword's posterior; edges: per edge of the row, x = the byte
// offset of (col, shift) from there and y = z - shift, the first lane that
// wraps around the column's end (z4 = 4*z bytes back); (m1o, m2o, wo): the
// row's state from the sweep before (unused when FIRST); st: where this lane
// keeps this row's state, stride z.
template <int DEG, bool FIRST>
__device__ __forceinline__ void row_step(unsigned char* smem, int pb,
                                         const int2* edges, int i, int z,
                                         int z4, float norm, float m1o,
                                         float m2o, unsigned wo, unsigned* st,
                                         bool keep) {
  float t[DEG];
  int a[DEG];
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    const int2 e = edges[d];
    a[d] = pb + e.x - (i >= e.y ? z4 : 0);
    t[d] = *reinterpret_cast<const float*>(smem + a[d]);
  }
  if (!FIRST) {
    // the message was ((norm*sprod)*sgn)*mag; norm*sprod = ns and ns*sgn are
    // sign flips, which commute with the rounding of the one true multiply,
    // so sgn applied to ns*mag gives the same bits
    const float ns = (__popc(wo & SIGN_MASK) & 1) ? -norm : norm;
    const float v1 = ns * m1o, v2 = ns * m2o;
    const unsigned arg = wo >> SIGN_BITS;
#pragma unroll
    for (int d = 0; d < DEG; ++d) {
      const float v = d == arg ? v2 : v1;
      t[d] = t[d] - (((wo >> d) & 1u) ? -v : v);
    }
  }
  float m1 = INFINITY, m2 = INFINITY;
  unsigned arg = 0, neg = 0;
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    const float mag = fabsf(t[d]);
    if (mag < m1) arg = d;
    m2 = fminf(m2, fmaxf(m1, mag));  // m1 <= m2: the old m1 when mag < m1
    m1 = fminf(m1, mag);
    if (!(t[d] >= 0.0f)) neg |= 1u << d;
  }
  const float ns = (__popc(neg) & 1) ? -norm : norm;
  const float v1 = ns * m1, v2 = ns * m2;
#pragma unroll
  for (int d = 0; d < DEG; ++d) {
    const float v = d == arg ? v2 : v1;
    *reinterpret_cast<float*>(smem + a[d]) = t[d] + (((neg >> d) & 1u) ? -v : v);
  }
  if (keep) {
    __stcg(st, __float_as_uint(m1));
    __stcg(st + z, __float_as_uint(m2));
    __stcg(st + 2 * z, neg | (arg << SIGN_BITS));
  }
}

template <bool FIRST>
__device__ __forceinline__ void row_dispatch(int deg, unsigned char* smem,
                                             int pb, const int2* edges, int i,
                                             int z, int z4, float norm,
                                             float m1o, float m2o, unsigned wo,
                                             unsigned* st, bool keep) {
#define ROW_CASE(D)                                                         \
  case D:                                                                   \
    row_step<D, FIRST>(smem, pb, edges, i, z, z4, norm, m1o, m2o, wo, st,   \
                       keep);                                               \
    break;
  switch (deg) {
    ROW_CASE(1) ROW_CASE(2) ROW_CASE(3) ROW_CASE(4) ROW_CASE(5)
    ROW_CASE(6) ROW_CASE(7) ROW_CASE(8) ROW_CASE(9) ROW_CASE(10)
    ROW_CASE(11) ROW_CASE(12) ROW_CASE(13) ROW_CASE(14) ROW_CASE(15)
    ROW_CASE(16) ROW_CASE(17) ROW_CASE(18) ROW_CASE(19)
  }
#undef ROW_CASE
}

// One sweep over the rows for one lane. st: this lane's state of row 0, the
// rows row_stride words apart; (nm1, nm2, nw): the state of the row step to
// come, fetched one row step ahead, so that it arrives behind the arithmetic
// of the step before it. The first sweep reads no state but row 0's for the
// second sweep; the last sweep (keep false) stores none.
template <bool FIRST>
__device__ __forceinline__ void sweep(unsigned char* smem, const int* s_row,
                                      const int2* s_edges, int n_rows, int pb,
                                      int i, int z, int z4, float norm,
                                      unsigned* st, int row_stride, bool keep,
                                      bool active, float& nm1, float& nm2,
                                      unsigned& nw) {
  int off = 0;
  int e0 = s_row[0];
  for (int r = 0; r < n_rows; ++r) {
    const int e1 = s_row[r + 1];
    const bool wrap = r + 1 == n_rows;
    const int off_n = wrap ? 0 : off + row_stride;
    if (active) {
      const float m1o = nm1, m2o = nm2;
      const unsigned wo = nw;
      if (FIRST ? (wrap && keep) : (!wrap || keep)) {
        const unsigned* nx = st + off_n;
        nm1 = __uint_as_float(__ldcg(nx));
        nm2 = __uint_as_float(__ldcg(nx + z));
        nw = __ldcg(nx + 2 * z);
      }
      row_dispatch<FIRST>(e1 - e0, smem, pb, s_edges + e0, i, z, z4, norm, m1o,
                          m2o, wo, st + off, keep);
    }
    off = off_n;
    e0 = e1;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2) ldpc_layered_kernel(
    const float* __restrict__ llr, float* __restrict__ out, unsigned* state,
    const int* __restrict__ row_ptr, const int2* __restrict__ edge_tbl,
    int n_cw, int n_rows, int n_cols, int n_edges, int z, int n_iter,
    int cw_per_cta, float norm) {
  // [n_edges] int2 | [n_rows + 1] int | pad | [cw_per_cta][n_cols * z] float
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_edges = reinterpret_cast<int2*>(smem);
  int* s_row = reinterpret_cast<int*>(s_edges + n_edges);
  const int tb = table_bytes(n_rows, n_edges);
  float* s_post = reinterpret_cast<float*>(smem + tb);

  const int tid = threadIdx.x;
  const int n_post = n_cols * z;
  const int cw0 = blockIdx.x * cw_per_cta;
  const int n_here = min(cw_per_cta, n_cw - cw0);
  const int n_load = n_here * n_post;
  const float* src = llr + (size_t)cw0 * n_post;
  float* dst = out + (size_t)cw0 * n_post;
  // 16 bytes at a time where the codewords' addresses allow it
  const bool vec = (n_load & 3) == 0 &&
                   (((uintptr_t)src | (uintptr_t)dst) & 15) == 0;
  if (vec) {
    const unsigned s0 = (unsigned)__cvta_generic_to_shared(s_post);
    for (int j = tid; j < n_load / 4; j += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s0 + 16 * j),
                   "l"(src + 4 * j)
                   : "memory");
  } else {
#pragma unroll 4
    for (int j = tid; j < n_load; j += blockDim.x) s_post[j] = src[j];
  }
  for (int e = tid; e < n_edges; e += blockDim.x) s_edges[e] = edge_tbl[e];
  for (int r = tid; r <= n_rows; r += blockDim.x) s_row[r] = row_ptr[r];
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int local = tid / z;
  int i = tid - local * z;
  const bool active = local < n_here;
  int z4 = 4 * z;
  int pb = tb + 4 * (local * n_post + i);
  const int row_stride = 3 * z;  // min1, min2, word of one row, z lanes each
  unsigned* st = state + (size_t)(cw0 + local) * n_rows * row_stride + i;
  // Pin these to registers. The compiler otherwise rebuilds them from the
  // thread index inside every row step, in front of every address.
  asm volatile("" : "+r"(i), "+r"(z4), "+r"(pb), "+l"(st));
  float nm1 = 0.0f, nm2 = 0.0f;
  unsigned nw = 0u;
  if (n_iter > 0)
    sweep<true>(smem, s_row, s_edges, n_rows, pb, i, z, z4, norm, st,
                row_stride, n_iter > 1, active, nm1, nm2, nw);
  for (int it = 1; it < n_iter; ++it)
    sweep<false>(smem, s_row, s_edges, n_rows, pb, i, z, z4, norm, st,
                 row_stride, it + 1 < n_iter, active, nm1, nm2, nw);
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(s_post);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int j = tid; j < n_load / 4; j += blockDim.x) d4[j] = p4[j];
  } else {
#pragma unroll 4
    for (int j = tid; j < n_load; j += blockDim.x) dst[j] = s_post[j];
  }
}

// Plain C entry point (loaded with ctypes). llr/out [n_cw, n_cols, z] f32;
// state [n_cw, n_rows, 3, z] 32-bit words of scratch, uninitialised; row_ptr
// [n_rows + 1] int32; edge_tbl [n_edges, 2] int32 in row order, per edge
// ((col*z + shift)*4, z - shift); max_deg the largest row degree of the plan;
// cw_per_cta codewords share a CTA of ceil(cw_per_cta*z / 32) warps. Launches
// on `stream` without synchronising and returns the cudaError_t of the
// launch: cudaErrorInvalidValue for a plan or a CTA shape the kernel does not
// take (a row degree above SIGN_BITS, fewer than 2 rows, more than
// MAX_THREADS threads, more shared memory than a block may have).
extern "C" int ldpc_layered_decode(const float* llr, float* out,
                                   unsigned* state, const int* row_ptr,
                                   const int* edge_tbl, int n_cw, int n_rows,
                                   int n_cols, int n_edges, int max_deg, int z,
                                   int n_iter, int cw_per_cta, float norm,
                                   void* stream) {
  if (max_deg > SIGN_BITS || n_rows < 2 || cw_per_cta < 1 || z < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = ((cw_per_cta * z + 31) / 32) * 32;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)table_bytes(n_rows, n_edges) +
                      (size_t)cw_per_cta * n_cols * z * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ctas = (n_cw + cw_per_cta - 1) / cw_per_cta;
  ldpc_layered_kernel<<<ctas, threads, smem, (cudaStream_t)stream>>>(
      llr, out, state, row_ptr, reinterpret_cast<const int2*>(edge_tbl), n_cw,
      n_rows, n_cols, n_edges, z, n_iter, cw_per_cta, norm);
  return (int)cudaGetLastError();
}
