// VQ nearest-code search, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/vq.py
// (`nearest_code_pallas` -> `_vq_forward` -> `_vq_kernel`), with the scoring
// rule of the plain path facodec_tpu/ops/vq_math.py `nearest_code`:
//
//   e = lat / max(|lat|, 1e-12),  c = cb / max(|cb|, 1e-12)   (rows)
//   dist[n] = (|e|^2 - 2 e.c[n]) + |c[n]|^2,  idx = first n of the least dist
//   zq = cb[idx]                                 (the un-normalised row)
//
// What bounds it on this card: D = 8 FMAs per (row, code) pair, 8K of them
// per row against a 1024-code book; the latents and the output are a few
// hundred KB. The normalised codebook and its squared norms (N*9 floats,
// 36 KB at N = 1024) sit in shared memory, built by each block, and every
// code is read from there. LANES threads share a row: lane l scores codes
// l, l+LANES, ..., keeps its first minimum, and the lanes reduce
// (dist, index) pairs with the lower index winning ties, so the result is the
// first minimum over the whole book, as torch.argmax / jnp.argmax give it.

#include <cuda_runtime.h>

namespace {

constexpr int D = 8;         // codebook_dim of every FAcodec quantizer
constexpr int LANES = 8;     // threads per row
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / LANES;

__global__ void __launch_bounds__(THREADS)
vq_kernel(const float* __restrict__ lat, const float* __restrict__ cb, int M, int N,
          int* __restrict__ idx_out, float* __restrict__ zq) {
  extern __shared__ float smem[];
  float* cbn = smem;        // N x D normalised codebook
  float* csq = smem + N * D;  // N squared norms of the normalised rows

  for (int n = threadIdx.x; n < N; n += THREADS) {
    float v[D], ss = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      v[d] = cb[(size_t)n * D + d];
      ss = fmaf(v[d], v[d], ss);
    }
    const float nrm = fmaxf(sqrtf(ss), 1e-12f);
    float cs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float c = v[d] / nrm;
      cbn[n * D + d] = c;
      cs = fmaf(c, c, cs);
    }
    csq[n] = cs;
  }
  __syncthreads();

  const int m = blockIdx.x * ROWS + threadIdx.x / LANES;
  const int l = threadIdx.x % LANES;
  if (m >= M) return;  // whole row groups exit together: no shuffle is left short

  float e[D], ss = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    e[d] = lat[(size_t)m * D + d];
    ss = fmaf(e[d], e[d], ss);
  }
  const float nrm = fmaxf(sqrtf(ss), 1e-12f);
  float esq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    e[d] = e[d] / nrm;
    esq = fmaf(e[d], e[d], esq);
  }

  float best = __int_as_float(0x7f800000);  // +inf
  int bi = N;
  for (int n = l; n < N; n += LANES) {
    const float4 c0 = *reinterpret_cast<const float4*>(cbn + n * D);
    const float4 c1 = *reinterpret_cast<const float4*>(cbn + n * D + 4);
    float ec = e[0] * c0.x;
    ec = fmaf(e[1], c0.y, ec);
    ec = fmaf(e[2], c0.z, ec);
    ec = fmaf(e[3], c0.w, ec);
    ec = fmaf(e[4], c1.x, ec);
    ec = fmaf(e[5], c1.y, ec);
    ec = fmaf(e[6], c1.z, ec);
    ec = fmaf(e[7], c1.w, ec);
    const float dist = __fadd_rn(__fsub_rn(esq, __fmul_rn(2.f, ec)), csq[n]);
    if (dist < best) {  // strict: the first minimum of this lane's codes
      best = dist;
      bi = n;
    }
  }
  // The LANES lanes of a row are consecutive and aligned inside one warp.
  const unsigned mask = 0xffu << (threadIdx.x & 31 & ~(LANES - 1));
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(mask, best, off, LANES);
    const int oi = __shfl_xor_sync(mask, bi, off, LANES);
    if (ob < best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  if (bi >= N) bi = 0;  // every dist NaN: pick code 0 rather than read past the book
  if (l == 0) idx_out[m] = bi;
  zq[(size_t)m * D + l] = cb[(size_t)bi * D + l];  // LANES == D: one value per lane
}

static_assert(LANES == D, "each lane gathers one element of the selected row");

}  // namespace

// C entry point, bound with ctypes. lat (M, 8), cb (N, 8), idx (M,) int32,
// zq (M, 8). Returns a cudaError_t (0 = launched).
extern "C" int facodec_vq_f32(const float* lat, const float* cb, int M, int N, int* idx,
                              float* zq, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)N * (D + 1);
  cudaError_t err =
      cudaFuncSetAttribute(vq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + ROWS - 1) / ROWS;
  vq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(lat, cb, M, N, idx, zq);
  return (int)cudaGetLastError();
}
