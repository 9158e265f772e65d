// Fused DAC residual unit with a W8A8 conv7, for Hopper (sm_90a): the units
// of the `int8` policy's decode whose conv7 quantizes (fan-in 7 C at least
// INT8_MIN_FANIN; at the flagship the three C = 768 units of decoder block 0).
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/resunit.py:273
// (`_forward`; entry `fused_residual_unit`) as the JAX package's default
// path runs such a unit under the `int8` policy (facodec_tpu/models/dac.py
// ResidualUnit, facodec_tpu/nn/conv.py W8A8 branch):
//
//   s1  = snake1(xpad)                          float32, not rounded
//   sx  = max(amax[b], 1e-12) * (1/127)         amax = max |s1| over (T, C) of row b
//   q1  = clip(rint(s1 / sx), -127, 127)        int8 (IEEE division, half to even)
//   c7  = float(sum q1 . q7) * (sx * sw[o]) + b7   the int8 sum exact in int32
//   s2  = bf16(snake2(c7))
//   y   = bf16(bf16(W1 . s2) + bf16(b1))        bf16 operands, float32 sums
//   out = x + y                                 float32
//
// with x float32 (a W8A8 conv before it returns float32), q7 the conv7's
// weight quantized per output channel over (tap, in) (`pack_int8`: (C, 7C),
// K index tap * C + in) with scales sw, and xpad x padded as SConv1d pads
// (reflect; causal (6d, 0)). Every step but the 1x1's float32 sum is written
// with __fmul_rn / __fadd_rn / __fdiv_rn, so q1, sx and c7 are the plain
// version's bits; the 1x1's sum differs from it in order only. Forward only.
//
// Two launches. The row scale pools over a whole batch row, so no tile can
// quantize before the row's maximum is known:
//   resunit_int8_amax: max |snake1(x)| per batch row, a grid-stride pass over
//     x with an atomic max (float bits as int: the values are >= 0);
//   resunit_int8_kernel: one CTA per tile of BM = 64 rows. It quantizes the
//     tile's BM + 6d padded rows of s1 into shared memory (int8, rows of
//     C + 16 bytes), runs the conv7 as int8 mma.sync m16n8k32 (s8 x s8 ->
//     s32) over N tiles of BN = 128 output channels, with the weight K
//     slices (64 bytes x BN rows) brought by cp.async through a ring of 3
//     stages; its epilogue writes c7 -> s2 as a BM x C bf16 tile in shared
//     memory; then the 1x1 as bf16 mma.sync m16n8k16 on that tile, with the
//     bf16 w1 slices through the same ring, and the residual into out.
//     8 warps, each 32 rows x 32 channels of an N tile.
//
// What bounds it. Per output row: 14 C^2 int8 operations (7 C^2 MACs) and
// 2 C^2 bf16 FLOP, on 8 C bytes (x in, out out, float32): at C = 768 about
// 1350 int8 operations a byte, far above the card's ridge (1979 TOPS /
// 3.35 TB/s = 590), so the tensor cores bound it. mma.sync reaches a part of
// the int8 peak that wgmma reaches in full: a wgmma k32 s8 form is later work.
//
// Shared memory per CTA at C = 768, d = 9: s1 118 x 784 B = 92.5 KB, s2
// 64 x 1552 B = 97 KB, the ring 3 x 128 x 80 B = 30 KB: 219.6 KB. Shapes whose
// tiles do not fit (wider C, larger d) are refused (the entry returns
// cudaErrorInvalidValue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "resunit_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;        // rows of a tile
constexpr int BN = 128;       // output channels of an N tile
constexpr int KCH = 64;       // bytes of a weight K slice (a row of a ring stage)
constexpr int WS = KCH + 16;  // bytes between the rows of a stage (no bank conflicts)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = BN * WS;
constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_bf(float v) {
  return __uint_as_float((uint32_t)f2bf(v) << 16);
}
__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
  return (uint32_t)f2bf(lo) | ((uint32_t)f2bf(hi) << 16);
}
__device__ __forceinline__ float bf_at(const uint16_t* p, int i) {
  return __uint_as_float((uint32_t)__ldg(p + i) << 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes of global memory into shared memory; `bytes` = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Four 8 x 16-byte matrices from shared memory, one per register.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------ row maxima
// amax[b] = max |snake1(x[b])| over (T, C); amax zeroed by the caller.
__global__ void __launch_bounds__(256) resunit_int8_amax(const float* __restrict__ x,
                                                         const float* __restrict__ alpha1,
                                                         const float* __restrict__ recip1,
                                                         float* amax, int T, int C) {
  const int b = blockIdx.y;
  const long long n4 = (long long)T * C / 4;
  const float4* xb = reinterpret_cast<const float4*>(x + (size_t)b * T * C);
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(xb + i);
    const int c = (int)((i * 4) % C);
    const float4 a = __ldg(reinterpret_cast<const float4*>(alpha1 + c));
    const float4 r = __ldg(reinterpret_cast<const float4*>(recip1 + c));
    m = fmaxf(m, fabsf(snakef(v.x, a.x, r.x)));
    m = fmaxf(m, fabsf(snakef(v.y, a.y, r.y)));
    m = fmaxf(m, fabsf(snakef(v.z, a.z, r.z)));
    m = fmaxf(m, fabsf(snakef(v.w, a.w, r.w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, part[w]);
    atomicMax(reinterpret_cast<int*>(amax + b), __float_as_int(m));
  }
}

// ------------------------------------------------------------------ unit
struct Params {
  const float* x;
  const float* amax;
  const int8_t* q7;  // (C, 7C)
  const float* sw;
  const uint16_t* w1;  // (C, C) bf16
  const float* b7;
  const uint16_t* b1;  // bf16
  const float *alpha1, *recip1, *alpha2, *recip2;
  float* out;
  float* c7_out;    // or null
  int8_t* q1_out;   // or null: (B, T + 6d, C)
  int T, C, dil, pad_left, ext, row_tiles;
  int rs_q, rs_s;   // bytes between rows of the s1 and s2 tiles
};

// The ring's stage `st` gets BN rows x 64 bytes of a row-major matrix with
// `ld` bytes a row, from row n0 and byte k0; rows past C and bytes past
// `kmax` read as zeros.
__device__ __forceinline__ void load_stage(uint32_t ring, int st, const uint8_t* w, int ld, int n0,
                                           int k0, int kmax, int C) {
#pragma unroll
  for (int i = 0; i < BN * (KCH / 16) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS, row = idx >> 2, part = idx & 3;
    const int n = n0 + row, k = k0 + 16 * part;
    const bool ok = n < C && k < kmax;
    const uint8_t* src = ok ? w + (size_t)n * ld + k : w;
    cp_async16(ring + st * STAGE_BYTES + row * WS + 16 * part, src, ok ? 16 : 0);
  }
}

// One GEMM pass over K = `kbytes` bytes of weights in 64-byte slices
// through the ring, `step(stage address, slice)` computing each.
template <typename Step>
__device__ __forceinline__ void pipeline(uint32_t ring, const uint8_t* w, int ld, int n0,
                                         int kbytes, int C, Step step) {
  const int slices = (kbytes + KCH - 1) / KCH;
  __syncthreads();  // every warp is done with the ring's previous pass
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) load_stage(ring, s, w, ld, n0, s * KCH, kbytes, C);
    cp_commit();
  }
  for (int i = 0; i < slices; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < slices) load_stage(ring, nxt % STAGES, w, ld, n0, nxt * KCH, kbytes, C);
    cp_commit();
    step(ring + (i % STAGES) * STAGE_BYTES, i);
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(THREADS, 1) resunit_int8_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows_in = BM + 6 * p.dil, C = p.C, K7 = 7 * C;
  uint8_t* q1s = smem;                                    // rows_in x rs_q int8
  uint8_t* s2s = smem + (size_t)rows_in * p.rs_q;         // BM x rs_s bf16
  const uint32_t q1a = smem_addr(q1s), s2a = smem_addr(s2s);
  const uint32_t ring = s2a + BM * p.rs_s;
  const int b = blockIdx.x / p.row_tiles, t0 = (blockIdx.x % p.row_tiles) * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, tig = lane & 3;
  const float sx = __fmul_rn(fmaxf(__ldg(p.amax + b), 1e-12f), INV127);
  const float* xb = p.x + (size_t)b * p.T * C;
  const int Tp = p.T + 6 * p.dil;

  // 1. q1 = clip(rint(snake1(xpad) / sx)) for the tile's padded rows, 4
  //    channels a thread at a time
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < rows_in * c4; e += THREADS) {
    const int r = e / c4, c = 4 * (e - r * c4), pr = t0 + r;
    const int q = pr < Tp ? padded_row(pr, p.T, p.ext, p.pad_left) : -1;
    uint32_t packed = 0u;
    if (q >= 0) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)q * C + c));
      const float4 a = __ldg(reinterpret_cast<const float4*>(p.alpha1 + c));
      const float4 rc = __ldg(reinterpret_cast<const float4*>(p.recip1 + c));
      const float s[4] = {snakef(v.x, a.x, rc.x), snakef(v.y, a.y, rc.y), snakef(v.z, a.z, rc.z),
                          snakef(v.w, a.w, rc.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = fminf(fmaxf(rintf(__fdiv_rn(s[i], sx)), -127.f), 127.f);
        packed |= (uint32_t)(uint8_t)(int8_t)(int)qv << (8 * i);
      }
    }
    *reinterpret_cast<uint32_t*>(q1s + (size_t)r * p.rs_q + c) = packed;
    if (p.q1_out != nullptr && pr < Tp && (r < BM || t0 + BM >= p.T))
      *reinterpret_cast<uint32_t*>(p.q1_out + ((size_t)b * Tp + pr) * C + c) = packed;
  }
  // (the first pipeline pass syncs before any warp reads q1)

  // 2. conv7 in int8, one N tile at a time; c7 -> s2 (bf16) into shared memory
  for (int n0 = 0; n0 < C; n0 += BN) {
    int acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0;
    pipeline(ring, reinterpret_cast<const uint8_t*>(p.q7), K7, n0, K7, C,
             [&](uint32_t st, int slice) {
#pragma unroll
               for (int s = 0; s < KCH / 32; ++s) {
                 const int k = slice * KCH + 32 * s;
                 if (k >= K7) break;
                 const int tap = k / C, c = k - tap * C;
                 uint32_t a[2][4], bf[4][2];
#pragma unroll
                 for (int m = 0; m < 2; ++m)
                   ldmatrix_x4(a[m], q1a + (wm * 32 + m * 16 + (lane & 15) + tap * p.dil) * p.rs_q +
                                         c + (lane >> 4) * 16);
#pragma unroll
                 for (int np = 0; np < 2; ++np) {
                   uint32_t r[4];
                   ldmatrix_x4(r, st + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * WS +
                                      32 * s + ((lane >> 3) & 1) * 16);
                   bf[2 * np][0] = r[0];
                   bf[2 * np][1] = r[1];
                   bf[2 * np + 1][0] = r[2];
                   bf[2 * np + 1][1] = r[3];
                 }
#pragma unroll
                 for (int m = 0; m < 2; ++m)
#pragma unroll
                   for (int n = 0; n < 4; ++n) mma_s8(acc[m][n], a[m], bf[n]);
               }
             });
    // epilogue: c7 = float(acc) * (sx * sw) + b7, s2 = bf16(snake2(c7))
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n0 + wn * 32 + n * 8 + 2 * tig;
      if (col >= C) continue;
      const float2 sw = __ldg(reinterpret_cast<const float2*>(p.sw + col));
      const float2 b7 = __ldg(reinterpret_cast<const float2*>(p.b7 + col));
      const float2 a2 = __ldg(reinterpret_cast<const float2*>(p.alpha2 + col));
      const float2 r2 = __ldg(reinterpret_cast<const float2*>(p.recip2 + col));
      const float sc0 = __fmul_rn(sx, sw.x), sc1 = __fmul_rn(sx, sw.y);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + m * 16 + g + 8 * h;
          const float c0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][n][2 * h]), sc0), b7.x);
          const float c1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[m][n][2 * h + 1]), sc1), b7.y);
          *reinterpret_cast<uint32_t*>(s2s + (size_t)r * p.rs_s + 2 * col) =
              pack_bf(snakef(c0, a2.x, r2.x), snakef(c1, a2.y, r2.y));
          if (p.c7_out != nullptr && t0 + r < p.T)
            *reinterpret_cast<float2*>(p.c7_out + ((size_t)b * p.T + t0 + r) * C + col) =
                make_float2(c0, c1);
        }
    }
  }
  // (the next pipeline pass syncs before any warp reads s2)

  // 3. the 1x1 in bf16 on the s2 tile; out = x + bf16(bf16(acc) + bf16(b1))
  for (int n0 = 0; n0 < C; n0 += BN) {
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
    pipeline(ring, reinterpret_cast<const uint8_t*>(p.w1), 2 * C, n0, 2 * C, C,
             [&](uint32_t st, int slice) {
#pragma unroll
               for (int s = 0; s < KCH / 32; ++s) {
                 const int kb = slice * KCH + 32 * s;  // byte of s2's row: 16 channels a step
                 uint32_t a[2][4], bf[4][2];
#pragma unroll
                 for (int m = 0; m < 2; ++m)
                   ldmatrix_x4(a[m], s2a + (wm * 32 + m * 16 + (lane & 15)) * p.rs_s + kb +
                                         (lane >> 4) * 16);
#pragma unroll
                 for (int np = 0; np < 2; ++np) {
                   uint32_t r[4];
                   ldmatrix_x4(r, st + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * WS +
                                      32 * s + ((lane >> 3) & 1) * 16);
                   bf[2 * np][0] = r[0];
                   bf[2 * np][1] = r[1];
                   bf[2 * np + 1][0] = r[2];
                   bf[2 * np + 1][1] = r[3];
                 }
#pragma unroll
                 for (int m = 0; m < 2; ++m)
#pragma unroll
                   for (int n = 0; n < 4; ++n) mma_bf16(acc[m][n], a[m], bf[n]);
               }
             });
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = n0 + wn * 32 + n * 8 + 2 * tig;
      if (col >= C) continue;
      const float bl = bf_at(p.b1, col), bh = bf_at(p.b1, col + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + wm * 32 + m * 16 + g + 8 * h;
          if (t >= p.T) continue;
          const size_t off = ((size_t)b * p.T + t) * C + col;
          const float2 xv = __ldg(reinterpret_cast<const float2*>(p.x + off));
          const float y0 = round_bf(__fadd_rn(round_bf(acc[m][n][2 * h]), bl));
          const float y1 = round_bf(__fadd_rn(round_bf(acc[m][n][2 * h + 1]), bh));
          *reinterpret_cast<float2*>(p.out + off) = make_float2(__fadd_rn(xv.x, y0),
                                                                __fadd_rn(xv.y, y1));
        }
    }
  }
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// Dynamic shared memory of a call: the s1 tile, the s2 tile and the ring.
long long smem_bytes(int C, int dil) {
  return (long long)(BM + 6 * dil) * (C + 16) + (long long)BM * (2 * C + 16) +
         (long long)STAGES * STAGE_BYTES;
}

bool fits(int B, int T, int C, int dil) {
  return valid_shape(B, T, C, dil) && smem_bytes(C, dil) <= device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

}  // namespace

// Row maxima of |snake1(x)|: x (B, T, C) float32, alpha1 and recip1 (C),
// into amax (B) float32, which the caller zeroes. Returns a cudaError_t.
extern "C" int facodec_resunit_int8_amax(const float* x, const float* alpha1, const float* recip1,
                                         float* amax, int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)T * C / 4;
  long long blocks = (n4 + 256 * 8 - 1) / (256 * 8);  // about 8 float4 a thread
  blocks = blocks < 1 ? 1 : (blocks > 1024 ? 1024 : blocks);
  resunit_int8_amax<<<dim3((unsigned)blocks, (unsigned)B), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, alpha1, recip1, amax, T, C);
  return (int)cudaGetLastError();
}

// C entry point, bound with ctypes: the unit on x (B, T, C) float32 into
// out, with the row maxima amax (facodec_resunit_int8_amax) and the packed
// operands (q7 int8 (C, 7C), sw, b7, the alphas and reciprocals float32, w1
// (C, C) and b1 bf16 as 16-bit patterns), the pads and ext of
// facodec_resunit_f32. c7_out (B, T, C) float32 and q1_out (B, T + 6d, C)
// int8 may be null; given, they get the conv7's output and the quantized
// padded input. Returns a cudaError_t (0 = launched).
extern "C" int facodec_resunit_int8(const float* x, const float* amax, const int8_t* q7,
                                    const float* sw, const uint16_t* w1, const float* b7,
                                    const uint16_t* b1, const float* alpha1, const float* recip1,
                                    const float* alpha2, const float* recip2, float* out,
                                    float* c7_out, int8_t* q1_out, int B, int T, int C, int dil,
                                    int pad_left, int ext, void* stream) {
  if (!fits(B, T, C, dil) || !valid_pads(T, dil, pad_left, ext)) return (int)cudaErrorInvalidValue;
  const int row_tiles = (T + BM - 1) / BM;
  const Params prm{x, amax, q7, sw, w1, b7, b1, alpha1, recip1, alpha2, recip2, out, c7_out, q1_out,
                   T, C, dil, pad_left, ext, row_tiles, C + 16, 2 * C + 16};
  const int smem = (int)smem_bytes(C, dil);
  static int set_for = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (set_for != dev) {
    const cudaError_t err =
        cudaFuncSetAttribute(resunit_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
    if (err != cudaSuccess) return (int)err;
    set_for = dev;
  }
  resunit_int8_kernel<<<B * row_tiles, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return (int)cudaGetLastError();
}
