// Fused DAC residual unit, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/resunit.py
// (`fused_residual_unit` -> `_forward` -> `_kernel`):
//
//   out[b,t,:] = x[b,t,:] + W1 . snake2(W7 (*)_d snake1(xpad)[b, t .. t+6d, :] + b7) + b1
//
// with the 7-tap conv dilated by d and xpad the input pre-padded like
// SConv1d (reflect; causal (6d, 0)). Snake commutes with the pad, so it is
// applied to the padded rows as they are staged.
//
// What bounds it on this card: float32 FMAs on the CUDA cores (8*C^2 FMAs per
// output row; TF32 tensor cores are off limits because the codec's codes must
// stay float32-exact) and, before them, the shared-memory loads that feed
// them: a thread's 4 x NJ register tile takes 4 + NJ loads per 4*NJ FMAs.
// Device memory sees x once and out once: y1 and y2 never leave the SM.
//
// Design. The TPU kernel walks time tiles in order and carries a 6d-row halo
// between them; Hopper blocks run in no order, so each block owns one
// (batch, TT-row time tile) and loads its own overlapping halo from the padded
// input. The block computes all C outputs of the 7-tap conv for its tile,
// because the 1x1 conv needs the whole y2 row: conv outputs go tile by tile of
// NC channels, input channels stream through shared memory KC at a time (so
// C = 768 at d = 9 fits; KC = 4 from C = 640, so that two blocks share an
// SM), and snake2(y2) stays in shared memory for the 1x1.
// Each thread holds a RT x NJ register tile (rows r0..r0+3, channels
// lane + 32j): one warp shares its rows, so the activation loads are
// broadcasts and the weight loads hit 32 consecutive banks.
// The weights are read in torch's own layouts, w7 [out][in][tap] and w1
// [out][in], so no caller transposes them: the staging loops walk each
// output channel's contiguous run of inputs (and taps) and store it as a
// column of a [tap][in][out] shared-memory tile whose rows are padded to
// NC + 1 floats, so that the column stores spread over the banks. These
// reads come in runs of 7*KC floats instead of rows of NC, which costs about
// 1% of the kernel's time over the codec's 24 units (up to 18% at C = 512).
// The snake reciprocals 1 / (alpha + 1e-9) come from the caller: a division
// in the kernel's staging loops took 104-108 registers and cost 5%.
//
// Rounding: the snake (sin^2 with its Cody-Waite reduction) is written with
// __fmul_rn / __fadd_rn / __fsub_rn, so nvcc contracts none of it into FMAs
// and it gives the same bits as the plain PyTorch version; only the conv sums
// use FMAs and differ from it in summation order.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;        // time rows per block
constexpr int THREADS = 256;  // 8 warps; warp w owns rows 4w .. 4w+3
constexpr int RT = 4;         // rows per thread

__device__ __forceinline__ float sin2f(float x) {
  x = fminf(fmaxf(x, -3.0e4f), 3.0e4f);
  const float k = rintf(__fmul_rn(x, 0.318309886183790672f));  // round half even
  float t = __fsub_rn(x, __fmul_rn(k, 3.140625f));
  t = __fsub_rn(t, __fmul_rn(k, 9.6750259399414062e-4f));
  t = __fsub_rn(t, __fmul_rn(k, 1.5099580252808664e-07f));
  const float t2 = __fmul_rn(t, t);
  float p = 1.5896910177e-10f;
  p = __fadd_rn(__fmul_rn(p, t2), -2.5050759689e-08f);
  p = __fadd_rn(__fmul_rn(p, t2), 2.7557314297e-06f);
  p = __fadd_rn(__fmul_rn(p, t2), -1.9841270114e-04f);
  p = __fadd_rn(__fmul_rn(p, t2), 8.3333337680e-03f);
  p = __fadd_rn(__fmul_rn(p, t2), -1.6666667163e-01f);
  const float s = __fadd_rn(t, __fmul_rn(__fmul_rn(t, t2), p));
  return __fmul_rn(s, s);
}

__device__ __forceinline__ float snakef(float x, float alpha, float recip) {
  return __fadd_rn(x, __fmul_rn(sin2f(__fmul_rn(alpha, x)), recip));
}

// Shared memory of one block, in floats: the y2 tile, the snake1 rows of one
// chunk of KC input channels, and the weights of that chunk, 7*KC rows of
// NC + 1 (the 1x1 conv stages 4*KC rows in the same space).
constexpr size_t smem_floats(int C, int dil, int KC, int NC) {
  return (size_t)TT * C + (size_t)(TT + 6 * dil) * KC + (size_t)7 * KC * (NC + 1);
}

// xp (B, Tp, C) padded input; w7 (C, C, 7) and w1 (C, C, 1) in torch's
// [out][in][tap] layout; alpha1, alpha2 (C) and their snake reciprocals
// recip1, recip2 = 1 / (alpha + 1e-9) (C); out (B, T, C). Row t of out
// reads its residual from row t + res_off of xp. KC input channels are
// staged per chunk of the 7-tap conv, K1 = 4*KC per chunk of the 1x1 conv.
template <int NJ, int KC>
__global__ void __launch_bounds__(THREADS)
resunit_kernel(const float* __restrict__ xp, const float* __restrict__ w7,
               const float* __restrict__ b7, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ alpha1,
               const float* __restrict__ recip1, const float* __restrict__ alpha2,
               const float* __restrict__ recip2, float* __restrict__ out, int T, int Tp,
               int C, int dil, int res_off) {
  constexpr int NC = 32 * NJ;  // output channels per tile
  constexpr int NCP = NC + 1;  // padded row of a staged weight tile
  constexpr int K1 = 4 * KC;
  constexpr int KW = 7 * KC;   // contiguous floats of one output channel in w7
  extern __shared__ float smem[];
  const int rows_in = TT + 6 * dil;
  float* y2s = smem;                 // TT x C: snake2(conv7 + b7)
  float* xs = y2s + TT * C;          // rows_in x KC: snake1 of the padded rows
  float* ws = xs + rows_in * KC;     // KW x NCP as [tap][in][out] (conv7), K1 x NCP (1x1)
  static_assert(32 % KC == 0, "KC divides the 32-channel width granule");

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * RT;
  const float* xb = xp + (size_t)b * Tp * C;

  for (int co0 = 0; co0 < C; co0 += NC) {
    float acc[RT][NJ];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += KC) {
      __syncthreads();
      for (int e = tid; e < rows_in * KC; e += THREADS) {
        const int r = e / KC, c = e % KC, t = t0 + r;
        // rows past the padded input belong to the ragged last tile's
        // outputs beyond T, which are never stored
        const int ci = ci0 + c;
        xs[e] = t < Tp ? snakef(xb[(size_t)t * C + ci], alpha1[ci], recip1[ci]) : 0.f;
      }
      for (int e = tid; e < KW * NC; e += THREADS) {
        const int n = e / KW, ck = e % KW;  // ck = c * 7 + tap
        ws[((ck % 7) * KC + ck / 7) * NCP + n] = w7[((size_t)(co0 + n) * C + ci0) * 7 + ck];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const float* xk = xs + (r0 + k * dil) * KC;
        const float* wk = ws + k * KC * NCP;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          float a[RT], w[NJ];
#pragma unroll
          for (int i = 0; i < RT; ++i) a[i] = xk[i * KC + c];
#pragma unroll
          for (int j = 0; j < NJ; ++j) w[j] = wk[c * NCP + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = co0 + lane + 32 * j;
        y2s[(r0 + i) * C + co] = snakef(__fadd_rn(acc[i][j], b7[co]), alpha2[co], recip2[co]);
      }
  }

  for (int co0 = 0; co0 < C; co0 += NC) {
    float acc[RT][NJ];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

    for (int ci0 = 0; ci0 < C; ci0 += K1) {
      __syncthreads();  // the first one also publishes every y2s write
      for (int e = tid; e < K1 * NC; e += THREADS) {
        const int n = e / K1, c = e % K1;
        ws[c * NCP + n] = w1[(size_t)(co0 + n) * C + ci0 + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < K1; ++c) {
        float a[RT], w[NJ];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = y2s[(r0 + i) * C + ci0 + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) w[j] = ws[c * NCP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int t = t0 + r0 + i;
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int co = co0 + lane + 32 * j;
        out[((size_t)b * T + t) * C + co] =
            __fadd_rn(xb[(size_t)(t + res_off) * C + co], __fadd_rn(acc[i][j], b1[co]));
      }
    }
  }
}

// The kernel's arguments, in its order.
struct Args {
  const float *xp, *w7, *b7, *w1, *b1, *alpha1, *recip1, *alpha2, *recip2;
  float* out;
  int B, T, Tp, C, dil, res_off;
};

template <int NJ, int KC>
cudaError_t launch_kc(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.C, a.dil, KC, 32 * NJ);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_kernel<NJ, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + TT - 1) / TT, a.B);
  resunit_kernel<NJ, KC><<<grid, THREADS, smem, stream>>>(
      a.xp, a.w7, a.b7, a.w1, a.b1, a.alpha1, a.recip1, a.alpha2, a.recip2, a.out, a.T, a.Tp,
      a.C, a.dil, a.res_off);
  return cudaGetLastError();
}

// Where the y2 tile is large (C >= 640: 80 KB and up), stage 4 input
// channels per chunk instead of 8, so that two blocks fit an SM's 227 KB.
template <int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return a.C >= 640 ? launch_kc<NJ, 4>(a, stream) : launch_kc<NJ, 8>(a, stream);
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int facodec_resunit_f32(const float* xp, const float* w7, const float* b7,
                                   const float* w1, const float* b1, const float* alpha1,
                                   const float* recip1, const float* alpha2,
                                   const float* recip2, float* out, int B, int T, int Tp, int C,
                                   int dil, int res_off, void* stream) {
  if (C <= 0 || C % 32 != 0 || B <= 0 || T <= 0 || dil <= 0 || Tp < T + 6 * dil)
    return (int)cudaErrorInvalidValue;
  const Args a{xp, w7, b7, w1, b1, alpha1, recip1, alpha2, recip2, out, B, T, Tp, C, dil, res_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 128 == 0) return (int)launch<4>(a, s);
  if (C % 96 == 0) return (int)launch<3>(a, s);
  if (C % 64 == 0) return (int)launch<2>(a, s);
  return (int)launch<1>(a, s);
}
