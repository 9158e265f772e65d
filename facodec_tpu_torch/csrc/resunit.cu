// Fused DAC residual unit, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/resunit.py
// (`fused_residual_unit` -> `_forward` -> `_kernel`):
//
//   out[b,t,:] = x[b,t,:] + W1 . snake2(W7 (*)_d snake1(xpad)[b, t .. t+6d, :] + b7) + b1
//
// with the 7-tap conv dilated by d and xpad the input padded like SConv1d
// (reflect; causal (6d, 0)). The kernel reads x itself and reflects the row
// index: a padded copy of x cost a strided pad and a transposing copy, 1.2 ms
// of the 2.9 ms a C = 64 unit took. Snake commutes with the pad.
//
// Work and bound. Per output row the unit does 2 * 8 * C^2 FLOP (7 C^2 MACs
// for the conv7, C^2 for the 1x1) and moves 2 * C * 4 bytes (x in, out out),
// plus the 8 C^2 weights once. So at every width of the codec it is bound by
// operations: at C = 768 and 19200 rows, 2.7 ms at 67 TFLOP/s of float32 FMAs
// on the CUDA cores. This kernel runs both products on the tensor cores in
// 3xTF32, three TF32 products per float32 one, so its own bound is
// 3 * FLOP / 495 TFLOP/s: 1.1 ms at C = 768.
//
// Precision: 3xTF32. Each operand a splits into hi = tf32_rna(a) and
// lo = a - hi (see split_tf32), and a*b is taken as lo*hi' + hi*lo' + hi*hi'
// (mma.sync m16n8k8 .tf32, float32 accumulation). That leaves out lo*lo',
// about 2^-22 relative. The tensor cores do not round their float32 sums to
// nearest: with the whole reduction accumulated in the mma, the error
// reached 2.1e-5 at C = 768. So each k-step's three products go into a zeroed
// fragment, and a round-to-nearest add folds it into the running sum. The
// result is closer to float64 than cuDNN's float32 convolution is. Plain
// TF32 (one product, about 3 decimal digits) is not used: the codec's codes
// must stay float32-exact. Operands are split as they go from shared memory
// into fragment registers. A split kept in shared memory would double the
// shared-memory loads that feed the mma.
//
// Design. One block owns BM rows of one batch row and all C output channels.
// Blocks run in no order, so each one loads its own 6d-row halo.
//   0. snake1 of its BM + 6d padded rows, evaluated once per element, goes
//      into the block's region of a scratch buffer. It stays in L2: the block
//      reads it back at once.
//   1. conv7 is a GEMM [BM x 7C] . [7C x C], BN output channels at a time.
//      A chunk of 8 input channels is 8 * 7 contiguous floats of torch's w7
//      [out][in][tap] per output channel. Each mma k-step takes one tap and
//      the chunk's 8 channels; its A operand is the staged snake1 tile
//      shifted by tap * d rows. snake2(acc + b7) goes to the block's region
//      of the y2 scratch.
//   2. The 1x1 conv is a GEMM [BM x C] . [C x C] over that y2 tile, plus b1
//      and the residual, into out.
// y2 leaves the SM because the 1x1 needs the whole row of C channels. Kept in
// shared memory, it pinned the previous kernel to 32-row tiles (96 KB at
// C = 768), and every block restaged all 8 C^2 weight floats for 32 rows.
// With y2 in scratch the tile is 128 rows, so each staged weight float feeds
// 64-128 rows. Where B * T gives fewer than 4 such blocks per SM (C = 512 and
// 768 at the flagship's batch 4: 150 blocks), it is 64 rows instead, which
// ran faster there. Both operands of both GEMMs are staged with
// cp.async, 16 bytes a thread, into two shared-memory buffers, so the next
// chunk's copies overlap the current chunk's mma. Eight warps form a
// WM x (8 / WM) grid of 32 x 8*NT warp tiles:
//   C % 128 == 0: BN = 128, BM = 128 (WM = 4, NT = 8) or 64 (WM = 2, NT = 4)
//   C % 96 == 0: BN = 96 (WM = 4, NT = 6)
//   C % 64 == 0: BN = 64 (WM = 4, NT = 4)
//   else (C % 32 == 0): BN = 32 (WM = 4, NT = 2)
// Shared memory is 2 x (A tile + B tile), 80-98 KB at the codec's dilations,
// so two blocks (16 warps, 128 registers a thread) share an SM.
// What bounds it now is the stream of mma.sync: cutting the three TF32
// products to one cut the time far more than leaving out the snakes or the
// fold did. wgmma is the next step.
//
// Streaming. A second entry, facodec_resunit_halo_f32, runs one chunk of a
// causal stream. Its padded input is the carried halo, (B, 6d, C) rows that
// are already snake1'd (the JAX stream state of the unit's conv7), and then
// the chunk's x rows through snake1; or, on a stream's first chunk (no halo),
// x reflected as the causal one-shot unit reflects it. It also writes
// new_halo, the last 6d rows of that padded snake1 input: the last block
// stages all of them in step 0 and copies them out as it stages them, so they
// are the staged values bit for bit. A chunk shorter than 6d rows (T = 24 at
// the flagship's 4-frame chunks, d = 9) leaves old halo rows in new_halo.
//
// Rounding: the snake (sin^2 with its Cody-Waite reduction, in
// resunit_common.cuh) is written with __fmul_rn / __fadd_rn / __fsub_rn, so
// nvcc contracts none of it into FMAs and it gives the same bits as the plain
// PyTorch version; only the conv sums differ from it, in summation order and
// by the 3xTF32 split.
//
// The bf16 entry (the hybrid decode's units) is csrc/resunit_bf16.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "resunit_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 2;     // cp.async buffers
constexpr int KC7 = 8;        // input channels per conv7 chunk: K = 56
constexpr int KC1 = 32;       // input channels per 1x1 chunk: K = 32
constexpr int PAD = 4;        // floats added to each staged row (banks, 16 B rows)

// a = hi + lo exactly, hi = tf32_rna(a). lo goes to the mma as it is: the
// tensor core reads its top 10 mantissa bits, which drops at most
// 2^-11 |lo| <= 2^-22 |a|, as much as the lo*lo' term that 3xTF32 leaves
// out; rounding lo as well cost 6% of the kernel's time.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// acc[BM x BN tile of this warp] += A . B over all C input channels, where
// A[m][(ci, tap)] = a_src[(m + tap * dil) * C + ci] (a_rows rows, the block's
// scratch region) and B[(ci, tap)][n] = b_src[(n0 + n) * TAPS * C + ci * TAPS + tap]
// (torch's weight layout). KCH input channels are staged per chunk, as
// contiguous runs of global memory. Each mma k-step takes one tap and 8 of
// the chunk's channels, so that a lane's loads, row g and channel t of its
// fragment, fall on distinct banks: g * (KCH + 4) + t for A, and
// g * (TAPS * KCH + 4) + TAPS * t for B (60g + 7t covers all 32 banks).
template <int WM, int NT, int TAPS, int KCH>
__device__ __forceinline__ void gemm_tile(float (&acc)[2][NT][4], const float* __restrict__ a_src,
                                          const float* __restrict__ b_src, int C, int dil, int n0,
                                          int a_rows, float* smem, int a_floats) {
  constexpr int BN = 8 * NT * (8 / WM);
  constexpr int AS = KCH + PAD;         // staged A row: KCH channels
  constexpr int BS = TAPS * KCH + PAD;  // staged B row: TAPS * KCH reduction indices
  constexpr int AV = KCH / 4, BV = TAPS * KCH / 4;  // 16-byte copies per row
  static_assert(KCH % 8 == 0, "a k-step takes 8 channels of one tap");
  const int stage = a_floats + BN * BS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % WM) * 32, wc = (warp / WM) * NT * 8;

  auto load = [&](int ci0, int buf) {
    float* As = smem + buf * stage;
    float* Bs = As + a_floats;
    for (int e = tid; e < a_rows * AV; e += THREADS) {
      const int r = e / AV, v = 4 * (e % AV);
      cp_async16(As + r * AS + v, a_src + (size_t)r * C + ci0 + v);
    }
    for (int e = tid; e < BN * BV; e += THREADS) {
      const int r = e / BV, v = 4 * (e % BV);
      cp_async16(Bs + r * BS + v, b_src + (size_t)(n0 + r) * TAPS * C + ci0 * TAPS + v);
    }
  };

  const int nch = C / KCH;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load((c + 1) * KCH, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* As = smem + (c & 1) * stage;
    const float* Bs = As + a_floats;
#pragma unroll
    for (int kk = 0; kk < TAPS * KCH / 8; ++kk) {
      const int tap = kk % TAPS, c0 = (kk / TAPS) * 8 + t;  // channels c0, c0 + 4
      const int ao = tap * dil * AS + c0, bo = c0 * TAPS + tap;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = As + (wr + mt * 16 + g) * AS + ao;
        split_tf32(ar[0], ah[mt][0], al[mt][0]);
        split_tf32(ar[8 * AS], ah[mt][1], al[mt][1]);
        split_tf32(ar[4], ah[mt][2], al[mt][2]);
        split_tf32(ar[8 * AS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* br = Bs + (wc + nt * 8 + g) * BS + bo;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(br[0], bh0, bl0);
        split_tf32(br[4 * TAPS], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {  // small terms first
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, al[mt], bh0, bh1);
          mma_tf32(d, ah[mt], bl0, bl1);
          mma_tf32(d, ah[mt], bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], d[i]);
        }
      }
    }
    __syncthreads();
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// x (B, T, C); w7 (C, C, 7) and w1 (C, C, 1) in torch's [out][in][tap]
// layout; alpha1, alpha2 (C) and their snake reciprocals recip1, recip2 =
// 1 / (alpha + 1e-9) (C); out (B, T, C). scratch holds, per block, BM + 6d
// rows of snake1(xpad) and then BM rows of y2. halo (B, 6d, C), or null:
// padded rows p < 6d are halo[b, p] as they are, rows p >= 6d x[b, p - 6d]
// through snake1 (pad_left and ext are then unused). new_halo (B, 6d, C), or
// null: padded rows T .. T + 6d - 1 are written there.
template <int WM, int NT>
__global__ void __launch_bounds__(THREADS, 2)
resunit_kernel(const float* __restrict__ x, const float* __restrict__ w7,
               const float* __restrict__ b7, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ alpha1,
               const float* __restrict__ recip1, const float* __restrict__ alpha2,
               const float* __restrict__ recip2, float* __restrict__ out,
               float* __restrict__ scratch, const float* __restrict__ halo,
               float* __restrict__ new_halo, int T, int C, int dil, int pad_left, int ext,
               int a_floats) {
  constexpr int BM = 32 * WM, BN = 8 * NT * (8 / WM);
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * BM;
  const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
  const size_t nblk = (size_t)gridDim.x * gridDim.y;
  const int rows_in = BM + 6 * dil;
  float* s1 = scratch + blk * rows_in * C;
  float* y2 = scratch + nblk * rows_in * C + blk * BM * C;
  const float* xb = x + (size_t)b * T * C;
  const int Tp = T + 6 * dil;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % WM) * 32, wc = (warp / WM) * NT * 8;

  // 0. snake1 of the padded rows, once; rows past the padded input belong
  // to the ragged last tile's outputs beyond T, which are never stored
  const int C4 = C / 4, H = 6 * dil;
  const bool last = blockIdx.x == gridDim.x - 1;
  for (int e = tid; e < rows_in * C4; e += THREADS) {
    const int r = e / C4, c = 4 * (e % C4), p = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (halo != nullptr && p < H) {
      v = *reinterpret_cast<const float4*>(halo + ((size_t)b * H + p) * C + c);
    } else {
      const int q = p >= Tp ? -1 : halo != nullptr ? p - H : padded_row(p, T, ext, pad_left);
      if (q >= 0) {
        v = *reinterpret_cast<const float4*>(xb + (size_t)q * C + c);
        v.x = snakef(v.x, alpha1[c], recip1[c]);
        v.y = snakef(v.y, alpha1[c + 1], recip1[c + 1]);
        v.z = snakef(v.z, alpha1[c + 2], recip1[c + 2]);
        v.w = snakef(v.w, alpha1[c + 3], recip1[c + 3]);
      }
    }
    *reinterpret_cast<float4*>(s1 + (size_t)r * C + c) = v;
    if (new_halo != nullptr && last && p >= T && p < Tp)
      *reinterpret_cast<float4*>(new_halo + ((size_t)b * H + p - T) * C + c) = v;
  }
  __syncthreads();

  float acc[2][NT][4];
  // 1. y2 = snake2(conv7 + b7), BN output channels at a time
  for (int n0 = 0; n0 < C; n0 += BN) {
    zero(acc);
    gemm_tile<WM, NT, 7, KC7>(acc, s1, w7, C, dil, n0, rows_in, smem, a_floats);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + mt * 16 + g + 8 * h, co = n0 + wc + nt * 8 + 2 * t;
          float2 v;
          v.x = snakef(__fadd_rn(acc[mt][nt][2 * h], b7[co]), alpha2[co], recip2[co]);
          v.y = snakef(__fadd_rn(acc[mt][nt][2 * h + 1], b7[co + 1]), alpha2[co + 1],
                       recip2[co + 1]);
          *reinterpret_cast<float2*>(y2 + (size_t)r * C + co) = v;
        }
  }
  __syncthreads();  // publishes the block's y2 rows to its own cp.async reads

  // 2. out = x + conv1x1(y2) + b1
  for (int n0 = 0; n0 < C; n0 += BN) {
    zero(acc);
    gemm_tile<WM, NT, 1, KC1>(acc, y2, w1, C, 1, n0, BM, smem, a_floats);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tr = t0 + wr + mt * 16 + g + 8 * h, co = n0 + wc + nt * 8 + 2 * t;
          if (tr >= T) continue;
          const float2 xr = *reinterpret_cast<const float2*>(xb + (size_t)tr * C + co);
          float2 v;
          v.x = __fadd_rn(xr.x, __fadd_rn(acc[mt][nt][2 * h], b1[co]));
          v.y = __fadd_rn(xr.y, __fadd_rn(acc[mt][nt][2 * h + 1], b1[co + 1]));
          *reinterpret_cast<float2*>(out + ((size_t)b * T + tr) * C + co) = v;
        }
  }
}

// The kernel's arguments, in its order.
struct Args {
  const float *x, *w7, *b7, *w1, *b1, *alpha1, *recip1, *alpha2, *recip2;
  float *out, *scratch;
  const float* halo;
  float* new_halo;
  int B, T, C, dil, pad_left, ext;
};

int row_blocks(int T, int BM) { return (T + BM - 1) / BM; }

// Rows per block: 128, or 64 where C % 128 == 0 and 128-row tiles give
// fewer than 4 blocks per SM.
int tile_rows(int B, int T, int C) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool few = (size_t)row_blocks(T, 128) * B < (size_t)4 * sms;
  return C % 128 == 0 && few ? 64 : 128;
}

template <int WM, int NT>
cudaError_t launch_cfg(const Args& a, cudaStream_t stream) {
  constexpr int BM = 32 * WM, BN = 8 * NT * (8 / WM);
  const int a7 = (BM + 6 * a.dil) * (KC7 + PAD), a1 = BM * (KC1 + PAD);
  const int a_floats = a7 > a1 ? a7 : a1;
  const size_t smem = sizeof(float) * STAGES * (size_t)(a_floats + BN * (7 * KC7 + PAD));
  cudaError_t err = cudaFuncSetAttribute(resunit_kernel<WM, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(row_blocks(a.T, BM), a.B);
  resunit_kernel<WM, NT><<<grid, THREADS, smem, stream>>>(
      a.x, a.w7, a.b7, a.w1, a.b1, a.alpha1, a.recip1, a.alpha2, a.recip2, a.out, a.scratch,
      a.halo, a.new_halo, a.T, a.C, a.dil, a.pad_left, a.ext, a_floats);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.C % 128 == 0)
    return tile_rows(a.B, a.T, a.C) == 64 ? launch_cfg<2, 4>(a, s) : launch_cfg<4, 8>(a, s);
  if (a.C % 96 == 0) return launch_cfg<4, 6>(a, s);
  if (a.C % 64 == 0) return launch_cfg<4, 4>(a, s);
  return launch_cfg<4, 2>(a, s);
}

}  // namespace

// Floats of scratch that the float32 and halo entries need for these shapes
// (0 if the shapes are refused). The bf16 entry needs none.
extern "C" long long facodec_resunit_scratch_floats(int B, int T, int C, int dil) {
  if (!valid_shape(B, T, C, dil)) return 0;
  const int BM = tile_rows(B, T, C);  // per block: BM + 6d rows of snake1, BM rows of y2
  return (long long)row_blocks(T, BM) * B * (2 * BM + 6 * dil) * C;
}

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int facodec_resunit_f32(const float* x, const float* w7, const float* b7,
                                   const float* w1, const float* b1, const float* alpha1,
                                   const float* recip1, const float* alpha2,
                                   const float* recip2, float* out, float* scratch, int B, int T,
                                   int C, int dil, int pad_left, int ext, void* stream) {
  if (!valid_shape(B, T, C, dil) || !valid_pads(T, dil, pad_left, ext))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w7, b7, w1, b1, alpha1, recip1, alpha2, recip2, out, scratch,
               nullptr, nullptr, B, T, C, dil, pad_left, ext};
  return launch(a, static_cast<cudaStream_t>(stream));
}

// C entry point of one causal stream chunk (see "Streaming" above). halo is
// (B, 6d, C) or null on a stream's first chunk, which needs T > 6d; new_halo
// (B, 6d, C) is written. The scratch is facodec_resunit_scratch_floats'.
extern "C" int facodec_resunit_halo_f32(const float* x, const float* halo, const float* w7,
                                        const float* b7, const float* w1, const float* b1,
                                        const float* alpha1, const float* recip1,
                                        const float* alpha2, const float* recip2, float* out,
                                        float* new_halo, float* scratch, int B, int T, int C,
                                        int dil, void* stream) {
  if (!valid_shape(B, T, C, dil) || new_halo == nullptr) return (int)cudaErrorInvalidValue;
  if (halo == nullptr && !valid_pads(T, dil, 6 * dil, T)) return (int)cudaErrorInvalidValue;
  const Args a{x, w7, b7, w1, b1, alpha1, recip1, alpha2, recip2, out, scratch,
               halo, new_halo, B, T, C, dil, 6 * dil, T};
  return launch(a, static_cast<cudaStream_t>(stream));
}
