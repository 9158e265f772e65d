// VQ nearest-code search, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/vq.py:76
// (`nearest_code_pallas` -> `_vq_forward` -> `_vq_kernel`), with the scoring
// rule of the plain path facodec_tpu/ops/vq_math.py `nearest_code`:
//
//   e = lat / max(|lat|, 1e-12),  c = cb / max(|cb|, 1e-12)   (rows)
//   dist[n] = (|e|^2 - 2 e.c[n]) + |c[n]|^2,  idx = first n of the least dist
//   zq = cb[idx]                                 (the un-normalised row)
//
// What bounds it on this card: at the main path's shape (M = 3200 latent
// rows, N = 1024 codes, D = 8) the work is 52 MFLOP and 250 KB, under a
// microsecond on either roofline. The time goes to latency: two launches,
// the dependency of the search on the normalised book, one staging round
// trip from L2, and the scoring loop on the SMs that hold a block.
//
// What the design does about it:
// - The book is normalised once per call, by `vq_norm_kernel`, into a
//   scratch the wrapper allocates: the low and high halves of each
//   normalised row as two float4 planes, then the squared norms, padded to a
//   multiple of CODE_STEP codes with zero rows of squared norm +inf (a padded
//   code scores +inf and never wins).
// - Both kernels use programmatic dependent launch. `vq_norm_kernel` waits
//   for the work before it on the stream (griddepcontrol.wait) and only then
//   lets `vq_search_kernel` start. So the search may read the latents and
//   the book at once: it normalises its rows while the book is normalised,
//   and waits for the first kernel only before it reads the scratch.
// - A search block scores ROWS = 32 rows with 8 warps; warp w scores span w
//   of each staged chunk (SPAN = 128 codes) and stages that span itself with
//   cp.async, so no block barrier stands between staging and scoring. At
//   M = 3200 that is 100 blocks, one per SM: fewer, fuller blocks stage the
//   book (36 KB) fewer times.
// - In a warp, 8 code-lanes x 4 row-lanes: lane (c, r) scores codes
//   c, c + 8, ... of the span against rows 8r..8r+7, held in registers. Each
//   shared-memory load is 8 distinct float4s, one wavefront, broadcast to the
//   4 row-lanes, and feeds 8 independent FMA chains. (With 32 lanes on 32
//   codes a load is 4 wavefronts, and the loop is bound by shared-memory
//   bandwidth.)
// - Each lane keeps the first minimum of its codes (strict <, codes in
//   increasing order); the code-lanes, then the warps, merge (dist, index)
//   pairs with the lower index winning ties, so the result is the first
//   minimum of the whole book, as torch.argmax / jnp.argmax give it. A row
//   whose every dist is NaN gets code 0.
//
// The arithmetic is fixed, so every layout gives the same bits: fmaf sums of squares,
// IEEE divisions, the e.c chain over d = 0..7 in order, and
// dist = (esq - 2 ec) + csq rounded twice (2 ec is exact, so the fmaf
// esq - 2 ec rounds as __fsub_rn(esq, __fmul_rn(2, ec)) does). It stays on
// the CUDA cores: D = 8 is one tensor-core k-step, and a 3xTF32 product
// would change the bits of the score.

#include <cuda_runtime.h>

namespace {

constexpr int D = 8;          // codebook_dim of every FAcodec quantizer
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CL = 8;         // code-lanes of a warp
constexpr int RL = 32 / CL;   // row-lanes of a warp
constexpr int RPT = 8;        // rows per lane
constexpr int ROWS = RL * RPT;
constexpr int SPAN = 128;     // codes of a chunk per warp
constexpr int CHUNK = SPAN * WARPS;
constexpr int CODE_STEP = 64; // the book is padded to a multiple of this
constexpr int NORM_THREADS = 128;

static_assert(SPAN % CODE_STEP == 0 && CODE_STEP % CL == 0 && CODE_STEP % 4 == 0,
              "a span is whole code-lane steps and whole float4s of squared norms");
static_assert(ROWS <= THREADS && ROWS * D <= THREADS, "one thread per row, per output");

__host__ __device__ constexpr int padded(int N) {
  return (N + CODE_STEP - 1) / CODE_STEP * CODE_STEP;
}

// v normalised in place; returns its squared norm after.
__device__ __forceinline__ float normalise(float (&v)[D]) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) ss = fmaf(v[d], v[d], ss);
  const float nrm = fmaxf(sqrtf(ss), 1e-12f);
  float s2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = v[d] / nrm;
    s2 = fmaf(v[d], v[d], s2);
  }
  return s2;
}

// Normalise codebook rows n < N into the scratch planes; rows N..NP-1 are
// zero with squared norm +inf.
__global__ void __launch_bounds__(NORM_THREADS)
vq_norm_kernel(const float* __restrict__ cb, int N, int NP, float4* __restrict__ lo,
               float4* __restrict__ hi, float* __restrict__ csq) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the stream's earlier work is done
  asm volatile("griddepcontrol.launch_dependents;");
  const int n = blockIdx.x * NORM_THREADS + threadIdx.x;
  if (n >= NP) return;
  float v[D] = {};
  float cs = __int_as_float(0x7f800000);  // +inf
  if (n < N) {
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = cb[(size_t)n * D + d];
    cs = normalise(v);
  }
  lo[n] = make_float4(v[0], v[1], v[2], v[3]);
  hi[n] = make_float4(v[4], v[5], v[6], v[7]);
  csq[n] = cs;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}

__device__ __forceinline__ float dot8(float4 ea, float4 eb, float4 a, float4 b) {
  float ec = ea.x * a.x;
  ec = fmaf(ea.y, a.y, ec);
  ec = fmaf(ea.z, a.z, ec);
  ec = fmaf(ea.w, a.w, ec);
  ec = fmaf(eb.x, b.x, ec);
  ec = fmaf(eb.y, b.y, ec);
  ec = fmaf(eb.z, b.z, ec);
  ec = fmaf(eb.w, b.w, ec);
  return ec;
}

// (best, bi) becomes the lesser pair, the lower index on equal dists.
__device__ __forceinline__ void keep_first(float& best, int& bi, float ob, int oi) {
  if (ob < best || (ob == best && oi < bi)) {
    best = ob;
    bi = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
vq_search_kernel(const float* __restrict__ lat, const float4* __restrict__ lo,
                 const float4* __restrict__ hi, const float* __restrict__ csq,
                 const float* __restrict__ cb, int M, int N, int NP, int* __restrict__ idx_out,
                 float* __restrict__ zq) {
  __shared__ float4 s_lo[CHUNK], s_hi[CHUNK];
  __shared__ __align__(16) float s_csq[CHUNK];
  __shared__ float4 s_e[ROWS][2];
  __shared__ float s_esq[ROWS];
  __shared__ float s_best[WARPS][ROWS];
  __shared__ int s_bi[WARPS][ROWS];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cl = lane % CL, rl = lane / CL;
  const int m0 = blockIdx.x * ROWS;

  // The block's rows, normalised while the book is. Rows past M score zeros
  // and write nothing.
  if (threadIdx.x < ROWS) {
    const int m = m0 + threadIdx.x;
    float v[D] = {};
    if (m < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) v[d] = lat[(size_t)m * D + d];
    }
    const float es = normalise(v);
    s_e[threadIdx.x][0] = make_float4(v[0], v[1], v[2], v[3]);
    s_e[threadIdx.x][1] = make_float4(v[4], v[5], v[6], v[7]);
    s_esq[threadIdx.x] = es;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the normalised book is written
  __syncthreads();

  float4 ea[RPT], eb[RPT];
  float esq[RPT], best[RPT];
  int bi[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = rl * RPT + q;
    ea[q] = s_e[r][0];
    eb[q] = s_e[r][1];
    esq[q] = s_esq[r];
    best[q] = __int_as_float(0x7f800000);  // +inf
    bi[q] = N;
  }

  float4* const w_lo = s_lo + warp * SPAN;
  float4* const w_hi = s_hi + warp * SPAN;
  float* const w_csq = s_csq + warp * SPAN;
  for (int c0 = 0; c0 < NP; c0 += CHUNK) {
    const int base = c0 + warp * SPAN;
    const int span = max(0, min(SPAN, NP - base));  // a multiple of CODE_STEP, or 0
    __syncwarp();  // the warp is done with its last span
    for (int i = lane; i < span; i += 32) {
      cp_async16(w_lo + i, lo + base + i);
      cp_async16(w_hi + i, hi + base + i);
    }
    for (int i = lane; i < span / 4; i += 32) cp_async16(w_csq + 4 * i, csq + base + 4 * i);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();

#pragma unroll 2
    for (int j = cl; j < span; j += CL) {
      const float4 a = w_lo[j], b = w_hi[j];
      const float q = w_csq[j];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float d = __fadd_rn(fmaf(-2.f, dot8(ea[r], eb[r], a, b), esq[r]), q);
        if (d < best[r]) {  // strict, codes in increasing order: the first minimum
          best[r] = d;
          bi[r] = base + j;
        }
      }
    }
  }

  // the code-lanes of each row, then the warps
#pragma unroll
  for (int off = CL / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      keep_first(best[r], bi[r], ob, oi);
    }
  }
  if (cl == 0) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      s_best[warp][rl * RPT + r] = best[r];
      s_bi[warp][rl * RPT + r] = bi[r];
    }
  }
  __syncthreads();
  // thread r * D + d gathers element d of row r; thread r * D writes its index
  const int r = threadIdx.x / D, d = threadIdx.x % D, m = m0 + r;
  if (r < ROWS && m < M) {
    float bb = s_best[0][r];
    int k = s_bi[0][r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) keep_first(bb, k, s_best[w][r], s_bi[w][r]);
    if (k >= N) k = 0;  // every dist NaN: pick code 0 rather than read past the book
    zq[(size_t)m * D + d] = cb[(size_t)k * D + d];
    if (d == 0) idx_out[m] = k;
  }
}

}  // namespace

// Floats of scratch `facodec_vq_f32` needs for an N-code book: the two float4
// planes and the squared norms of the padded book.
extern "C" long long facodec_vq_scratch_floats(int N) { return (long long)padded(N) * (D + 1); }

// C entry point, bound with ctypes. lat (M, 8), cb (N, 8), idx (M,) int32,
// zq (M, 8), scratch of facodec_vq_scratch_floats(N) floats, 16-byte aligned.
// Launches both kernels on `stream`; returns a cudaError_t (0 = launched).
extern "C" int facodec_vq_f32(const float* lat, const float* cb, int M, int N, int* idx,
                              float* zq, float* scratch, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int NP = padded(N);
  float4* lo = reinterpret_cast<float4*>(scratch);
  float4* hi = lo + NP;
  float* csq = reinterpret_cast<float*>(hi + NP);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  cfg.gridDim = dim3((NP + NORM_THREADS - 1) / NORM_THREADS);
  cfg.blockDim = dim3(NORM_THREADS);
  cudaError_t err = cudaLaunchKernelEx(&cfg, vq_norm_kernel, cb, N, NP, lo, hi, csq);
  if (err != cudaSuccess) return (int)err;

  cfg.gridDim = dim3((M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(THREADS);
  err = cudaLaunchKernelEx(&cfg, vq_search_kernel, lat, (const float4*)lo, (const float4*)hi,
                           (const float*)csq, cb, M, N, NP, idx, zq);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
