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
//   resunit_int8_kernel: the unit, below.
//
// What bounds it. Per output row: 14 C^2 int8 operations (7 C^2 MACs) and
// 2 C^2 bf16 FLOP, on 8 C bytes (x in, out out, float32): at C = 768 about
// 1350 int8 operations a byte, far above the card's ridge (1979 TOPS /
// 3.35 TB/s = 590), so the tensor cores bound it. What stands between a
// CTA and that bound: its weight stream (5.3 MB at C = 768 per 64-row tile,
// 128 int8 operations a byte: one SM takes them from L2 only as fast as the
// ring keeps bytes in flight, whatever the other SMs do), and CUDA-core work
// of the order of the tensor cores' (the quantization of 64 + 6d rows, the
// snake2 of the conv7's epilogue).
//
// Design:
// 1. wgmma. The conv7 is wgmma.mma_async m64nNk32 .s32.s8.s8, the 1x1
//    m64nNk16 bf16 with float32 sums, A and B from shared memory (int8
//    operands must both be K-major: q1's rows and q7's are). An N tile is BN
//    output channels (64, 96, 128, 192 or 256; 256 at C = 768, three N
//    tiles), split between two consumer warpgroups of NW = BN / 2 channels.
// 2. q1 is quantized once per 64-row tile, into shared memory in the
//    16-byte octet-column order of the bf16 kernel's s1 ([channel / 16]
//    [row][16 B]): a core matrix (8 rows x 16 B) is 128 contiguous bytes from
//    any start row, so tap j's A descriptor is tap 0's with its start moved
//    j * d rows. The row count R = 64 + 6d is made odd, so that one row's
//    stores spread over the banks. Seven quantizer warps fill it in tap
//    order (rows 0-63, then d rows per tap), each part behind an mbarrier,
//    while the consumers run the previous tile's 1x1 (which does not read
//    q1), and go on during this tile's first N tile, whose tap-j slices wait
//    for part j only.
// 3. Weights by TMA. One producer thread streams K slices of KC = 128 bytes
//    x BN rows of q7 (128-byte swizzle) through a ring of stages guarded by
//    full / empty mbarriers. Slices run in K order over 7C; a k32 step never
//    straddles two taps (C % 32 == 0), and each step's A descriptor has its
//    own tap.
// 4. s2 leaves shared memory for the ring: the conv7's epilogue stores the
//    64 x C bf16 tile in the same octet-column order into the CTA's slice of
//    a device scratch (it stays in L2), and each 1x1 slice brings KC / 2
//    bytes of w1's rows by TMA with the same channels of that tile by bulk
//    copy behind them. The deep ring this frees is what feeds the tensor
//    cores: a 2-stage ring beside an on-chip s2 tile left the conv7 waiting
//    for weights most of the time.
// 5. A persistent grid: one CTA per SM walks the row tiles of all batch
//    rows; each tile reads its own row's scale from amax.
// Warp roles (512 threads): warp 0 issues the copies, warps 1-7 quantize,
// warpgroups 2 and 3 issue the wgmma and run the epilogues. setmaxnreg
// gives the consumers 160 registers and the others 96.
//
// Shared memory per CTA at C = 768 (227 KB; the ring takes what is left):
//   d   q1 (R x C int8)      ring                     total
//   1   71 x 768  = 53 KB    5 x 32 KB (KC 128)       214 KB
//   3   83 x 768  = 62 KB    5 x 32 KB                223 KB
//   9   119 x 768 = 89 KB    4 x 32 KB                218 KB
// Shapes where two stages do not fit beside the q1 tile are refused (the
// entry returns cudaErrorInvalidValue): with 227 KB a CTA every C (a
// multiple of 32) up to 1376 at d = 9, 1984 at d = 3 and 2304 at d = 1 is
// taken.
//
// The host side reads the card's SM count and opt-in shared memory once per
// device (`device_info`, csrc/hopper.cuh; the caller passes the device
// index), and sets each instantiation's shared-memory limit once per
// device: no device query on the launch path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "hopper.cuh"
#include "resunit_common.cuh"

namespace {

constexpr int THREADS = 512;        // warpgroups 0 and 1 produce, 2 and 3 consume
constexpr int QUANT_THREADS = 224;  // warps 1-7
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMER_THREADS = 256;
constexpr int BM = 64;              // rows of a tile
constexpr int KC = 128;             // bytes of a q7 slice's rows (w1's: KC / 2)
constexpr int MAX_STAGES = 16;
constexpr int ALIGN = 1024;         // of the ring's base
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
__device__ __forceinline__ float lo_bf(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void quant_sync() { asm volatile("bar.sync 2, 224;" ::: "memory"); }

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
  const float* sw;
  const float* b7;
  const uint16_t* b1;  // bf16
  const float *alpha1, *recip1, *alpha2, *recip2;
  float* out;
  float* c7_out;   // or null
  int8_t* q1_out;  // or null: (B, T + 6d, C)
  uint16_t* s2g;   // the s2 tiles, BM x C bf16 per CTA ([channel / 8][row][8])
  int T, C, dil, pad_left, ext;
  int n_tiles;     // N tiles of BN output channels
  int rows;        // R, rows of the q1 tile: BM + 6d, made odd
  int stages;      // weight slices the ring holds
  int tiles, row_tiles;  // row tiles in all, and per batch row
};

// A row tile and its batch row's scale.
struct Tile {
  int b, t0;
  float sx;  // the row's scale
  __device__ __forceinline__ Tile(const Params& p, int tile) {
    b = tile / p.row_tiles;
    t0 = (tile % p.row_tiles) * BM;
    sx = __fmul_rn(fmaxf(__ldg(p.amax + b), 1e-12f), INV127);
  }
};

// Thread 0: every slice the consumers take, in their order, into the ring:
// per tile, for each N tile the 7C / KC slices of q7 (KC bytes x BN rows);
// then, once the consumers have stored the tile's s2, for each N tile the
// 4C / KC slices of the 1x1, each KC / 2 bytes of w1's rows with the same
// channels of the CTA's s2 tile (BM rows, by bulk copy) behind them. A
// weight slice comes as two boxes of BN / 2 rows.
template <int BN>
__device__ void load_weights(const CUtensorMap* map7, const CUtensorMap* map1, const Params& p,
                             uint32_t ring, uint32_t full, uint32_t empty, uint32_t s2_ready) {
  constexpr int HALF = BN / 2, STAGE = BN * KC, A_BYTES = BM * KC / 2;
  const int s7 = (7 * p.C + KC - 1) / KC, s1 = 4 * p.C / KC;
  const uint8_t* s2 = reinterpret_cast<const uint8_t*>(p.s2g) + (size_t)blockIdx.x * BM * p.C * 2;
  int it = 0;
  // the slice's weight rows n .. n + BN of `map` at K element k (rows of
  // `rb` bytes), and `a` bytes of the s2 tile from `src` behind them
  auto load = [&](const CUtensorMap* map, int k, int n, int rb, const uint8_t* src, int a) {
    const int s = it % p.stages;
    mbar_wait(empty + 8 * s, ((it / p.stages) & 1) ^ 1);
    const uint32_t dst = ring + s * STAGE, bar = full + 8 * s;
    mbar_expect_tx(bar, BN * rb + a);
    tma_load(dst, map, k, n, bar);
    tma_load(dst + HALF * rb, map, k, n + HALF, bar);
    if (a > 0) bulk_load(dst + BN * rb, src, a, bar);
    ++it;
  };
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    for (int nt = 0; nt < p.n_tiles; ++nt)
      for (int sl = 0; sl < s7; ++sl) load(map7, sl * KC, nt * BN, KC, nullptr, 0);
    mbar_wait(s2_ready, k & 1);
    fence_async_global();
    for (int nt = 0; nt < p.n_tiles; ++nt)
      for (int sl = 0; sl < s1; ++sl)
        load(map1, sl * (KC / 4), nt * BN, KC / 2, s2 + (size_t)sl * A_BYTES, A_BYTES);
  }
}

// One unit of the quantizers' work: 8 channels of one padded row, its x
// loaded ahead of its turn.
struct QUnit {
  float4 v[2];
  int r, c, q;  // tile row, channel, row of x (-1: a zero row)
};

// Warps 1-7: q1 = clip(rint(snake1(xpad) / sx)) of each tile's R padded
// rows into the q1 tile ([channel / 16][row][16 B]; rows past the padded
// input are zero), in seven parts: part 0 rows 0-63 (tap 0's), part j the d
// rows tap j adds; each behind its mbarrier, on which a thread arrives once
// it has stored its units of the part. A thread takes units of 8 channels
// in row order, QUANT_THREADS apart, with the x of the next two in flight
// while it computes one.
__device__ void quantize(const Params& p, uint8_t* q1, uint32_t q1_ready, uint32_t q1_empty) {
  const int i0 = threadIdx.x - 32, C = p.C, c8 = C / 8, Tp = p.T + 6 * p.dil;
  const int n = (BM + 6 * p.dil) * c8;  // units of a tile
  int k = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const Tile tl(p, tile);
    const float* xb = p.x + (size_t)tl.b * p.T * C;
    auto fetch = [&](QUnit& u, int e) {
      if (e >= n) return;
      const int row = e / c8, pr = tl.t0 + row;
      u.r = row;
      u.c = 8 * (e - row * c8);
      u.q = pr < Tp ? padded_row(pr, p.T, p.ext, p.pad_left) : -1;
      if (u.q >= 0) {
        const float4* src = reinterpret_cast<const float4*>(xb + (size_t)u.q * C + u.c);
        u.v[0] = __ldg(src);
        u.v[1] = __ldg(src + 1);
      }
    };
    int parts = 0;  // parts this thread has arrived on
    auto arrive_before = [&](int part) {
      if (parts >= part) return;
      fence_async_smem();
      for (; parts < part; ++parts) mbar_arrive(q1_ready + 8 * parts);
    };
    auto finish = [&](const QUnit& u, int e) {
      if (e >= n) return;
      arrive_before(u.r < BM ? 0 : 1 + (u.r - BM) / p.dil);
      uint32_t w[2] = {0u, 0u};
      if (u.q >= 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(p.alpha1 + u.c) + h);
          const float4 rc = __ldg(reinterpret_cast<const float4*>(p.recip1 + u.c) + h);
          const float s[4] = {snakef(u.v[h].x, a.x, rc.x), snakef(u.v[h].y, a.y, rc.y),
                              snakef(u.v[h].z, a.z, rc.z), snakef(u.v[h].w, a.w, rc.w)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qv = fminf(fmaxf(rintf(__fdiv_rn(s[i], tl.sx)), -127.f), 127.f);
            w[h] |= (uint32_t)(uint8_t)(int8_t)(int)qv << (8 * i);
          }
        }
      }
      *reinterpret_cast<uint2*>(q1 + ((size_t)(u.c >> 4) * p.rows + u.r) * 16 + (u.c & 15)) =
          make_uint2(w[0], w[1]);
      const int pr = tl.t0 + u.r;
      if (p.q1_out != nullptr && pr < Tp && (u.r < BM || tl.t0 + BM >= p.T))
        *reinterpret_cast<uint2*>(p.q1_out + ((size_t)tl.b * Tp + pr) * C + u.c) =
            make_uint2(w[0], w[1]);
    };
    QUnit ua, ub;
    // one thread polls the barrier; the others sleep in the named barrier
    if (i0 == 0) mbar_wait(q1_empty, (k & 1) ^ 1);
    quant_sync();
    fetch(ua, i0);
    fetch(ub, i0 + QUANT_THREADS);
    for (int e = i0; e < n; e += 2 * QUANT_THREADS) {
      finish(ua, e);
      fetch(ua, e + 2 * QUANT_THREADS);
      finish(ub, e + QUANT_THREADS);
      fetch(ub, e + 3 * QUANT_THREADS);
    }
    arrive_before(7);
  }
}

// A consumer warpgroup's side of the ring: `stage` and `phase` are the next
// slice's ring stage and full-barrier parity; `held` the stage whose wgmma
// may still run (released once the next slice's is issued and it has
// finished).
struct Ring {
  uint32_t full, empty;
  int stages, lane, stage, phase, held;

  // Waits for the next slice; returns its stage.
  __device__ __forceinline__ int next() {
    mbar_wait(full + 8 * stage, phase);
    const int s = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    return s;
  }
  // After a slice's wgmma are committed: the previous one's have finished
  // (one group stays in flight), so its stage goes back to the producer.
  __device__ __forceinline__ void issued(int s) {
    wgmma_wait<1>();
    if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
    held = s;
  }
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
    held = -1;
  }
};

template <int NW>
constexpr int JC = (NW / 8) % 4 == 0 ? 4 : 2;

// c7 = float(acc) * (sx * sw) + b7 and s2 = bf16(snake2(c7)) into the
// CTA's s2 tile (and c7 into c7_out). A thread's accumulator element
// 4j + 2h + i is row r0 + 8h, column col0 + 8j + i; columns go in groups of
// JC n8 blocks whose operand loads are issued together; columns past C are
// not stored.
template <int NW>
__device__ __forceinline__ void store_s2(const int (&acc)[NW / 2], const Params& p, const Tile& tl,
                                         uint16_t* s2, int col0, int r0) {
#pragma unroll
  for (int j0 = 0; j0 < NW / 8; j0 += JC<NW>) {
    float2 sw[JC<NW>], b7[JC<NW>], al[JC<NW>], rc[JC<NW>];
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj) {
      const int col = min(col0 + 8 * (j0 + jj), p.C - 2);
      sw[jj] = __ldg(reinterpret_cast<const float2*>(p.sw + col));
      b7[jj] = __ldg(reinterpret_cast<const float2*>(p.b7 + col));
      al[jj] = __ldg(reinterpret_cast<const float2*>(p.alpha2 + col));
      rc[jj] = __ldg(reinterpret_cast<const float2*>(p.recip2 + col));
    }
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj) {
      const int j = j0 + jj, col = col0 + 8 * j;
      if (col >= p.C) continue;
      const float sc0 = __fmul_rn(tl.sx, sw[jj].x), sc1 = __fmul_rn(tl.sx, sw[jj].y);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float c0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sc0), b7[jj].x);
        const float c1 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sc1), b7[jj].y);
        *reinterpret_cast<uint32_t*>(s2 + ((col >> 3) * BM + r) * 8 + (col & 7)) =
            pack_bf(snakef(c0, al[jj].x, rc[jj].x), snakef(c1, al[jj].y, rc[jj].y));
        if (p.c7_out != nullptr && tl.t0 + r < p.T)
          *reinterpret_cast<float2*>(p.c7_out + ((size_t)tl.b * p.T + tl.t0 + r) * p.C + col) =
              make_float2(c0, c1);
      }
    }
  }
}

// out = x + bf16(bf16(acc) + b1), b1 (bf16 pairs) loaded before the products.
template <int NW>
__device__ __forceinline__ void store_out(const float (&acc)[NW / 2], const uint32_t (&b1)[NW / 8],
                                          const Params& p, const Tile& tl, int col0, int r0) {
#pragma unroll
  for (int j0 = 0; j0 < NW / 8; j0 += JC<NW>) {
    float2 xv[JC<NW>][2];
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = min(col0 + 8 * (j0 + jj), p.C - 2);
        const int t = min(tl.t0 + r0 + 8 * h, p.T - 1);
        xv[jj][h] = __ldg(reinterpret_cast<const float2*>(p.x + ((size_t)tl.b * p.T + t) * p.C + col));
      }
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj, col = col0 + 8 * j, t = tl.t0 + r0 + 8 * h;
        const float y0 = round_bf(__fadd_rn(round_bf(acc[4 * j + 2 * h]), lo_bf(b1[j])));
        const float y1 = round_bf(__fadd_rn(round_bf(acc[4 * j + 2 * h + 1]), hi_bf(b1[j])));
        if (t < p.T && col < p.C)
          *reinterpret_cast<float2*>(p.out + ((size_t)tl.b * p.T + t) * p.C + col) =
              make_float2(__fadd_rn(xv[jj][h].x, y0), __fadd_rn(xv[jj][h].y, y1));
      }
  }
}

// Warpgroups 2 and 3 (cw = 0, 1), each NW = BN / 2 of an N tile's output
// channels: per tile, the conv7 (int8) into the s2 tile, then the 1x1
// (bf16) into out.
template <int NW>
__device__ void consume(const Params& p, uint32_t ring, uint32_t q1, uint32_t full, uint32_t empty,
                        uint32_t q1_ready, uint32_t q1_empty, uint32_t s2_ready) {
  constexpr int BN = 2 * NW, STAGE = BN * KC;
  const int tid = threadIdx.x - 256, cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int C = p.C, K7 = 7 * C, s7 = (K7 + KC - 1) / KC, s1 = 4 * C / KC;
  uint16_t* s2 = p.s2g + (size_t)blockIdx.x * BM * C;
  Ring rg{full, empty, p.stages, lane, 0, 0, -1};
  int k = 0;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++k) {
    const Tile tl(p, tile);
    // 1. the conv7 in int8, one N tile at a time; c7 -> the s2 tile
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      int acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
      int tap = 0, ch = 0, ready = nt == 0 ? -1 : 6;  // the q1 parts this N tile has waited for
      for (int sl = 0; sl < s7; ++sl) {
        const int last = (min(sl * KC + KC, K7) - 1) / C;  // the slice's last tap
        while (ready < last) mbar_wait(q1_ready + 8 * ++ready, k & 1);
        const int s = rg.next();
        const uint64_t b = desc_sw<KC>(ring + s * STAGE + cw * NW * KC);  // this warpgroup's rows
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 32; ++ks) {
          // past 7C (the last slice, where C % KC != 0) q7 reads as zeros:
          // those steps take tap 0's rows, which lie in the q1 tile (not
          // issuing them made ptxas serialize the wgmma, C7519)
          const int tp = tap < 7 ? tap : 0;
          const uint32_t a = q1 + ((ch >> 4) * p.rows + tp * p.dil) * 16;
          wgmma_s8<NW>(acc, desc_a(a, p.rows * 16), b + 2 * ks);
          ch += 32;
          if (ch == C) {
            ch = 0;
            ++tap;
          }
        }
        wgmma_commit();
        rg.issued(s);
        fence_regs(acc);
      }
      rg.drain();
      fence_regs(acc);
      if (nt == p.n_tiles - 1 && lane == 0) mbar_arrive(q1_empty);  // q1's last reader is done
      store_s2<NW>(acc, p, tl, s2, nt * BN + cw * NW + cq, r0);
    }
    fence_async_global();
    mbar_arrive(s2_ready);  // this thread's part of the s2 tile is stored

    // 2. the 1x1 in bf16 on the s2 tile; out = x + bf16(bf16(acc) + bf16(b1))
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      const int col0 = nt * BN + cw * NW + cq;
      uint32_t b1[NW / 8];
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        b1[j] = __ldg(reinterpret_cast<const uint32_t*>(p.b1 + min(col0 + 8 * j, C - 2)));
      float acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      for (int sl = 0; sl < s1; ++sl) {
        const int s = rg.next();
        const uint32_t st = ring + s * STAGE;
        const uint64_t b = desc_sw<KC / 2>(st + cw * NW * KC / 2);
        const uint32_t a = st + BN * KC / 2;  // the s2 slice behind the weights
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 64; ++ks)
          wgmma<NW>(acc, desc_a(a + ks * 2 * BM * 16, BM * 16), b + 2 * ks);
        wgmma_commit();
        rg.issued(s);
        fence_regs(acc);
      }
      rg.drain();
      fence_regs(acc);
      store_out<NW>(acc, b1, p, tl, col0, r0);
    }
  }
}

// map7, map1: the TMA tensor maps of q7 (C, 7C) int8 and w1 (C, C) bf16,
// boxes of KC and KC / 2 bytes x BN / 2 rows, swizzled over those rows.
template <int NW>
__global__ void __launch_bounds__(THREADS, 1)
resunit_int8_kernel(const __grid_constant__ CUtensorMap map7,
                    const __grid_constant__ CUtensorMap map1, const Params p) {
  constexpr int BN = 2 * NW;
  extern __shared__ uint8_t smem_raw[];
  // [ring: stages x BN x KC][q1: R x C][mbarriers]
  uint8_t* smem = smem_raw + (ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN;
  const uint32_t ring = smem_addr(smem);
  const uint32_t q1 = ring + p.stages * BN * KC;
  const uint32_t full = q1 + p.rows * p.C, empty = full + 8 * MAX_STAGES;
  const uint32_t q1_ready = empty + 8 * MAX_STAGES, q1_empty = q1_ready + 8 * 7;
  const uint32_t s2_ready = q1_empty + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    for (int j = 0; j < 7; ++j) mbar_init(q1_ready + 8 * j, QUANT_THREADS);
    mbar_init(q1_empty, CONSUMER_WARPS);
    mbar_init(s2_ready, CONSUMER_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
    consume<NW>(p, ring, q1, full, empty, q1_ready, q1_empty, s2_ready);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;");
    if (threadIdx.x == 0)
      load_weights<BN>(&map7, &map1, p, ring, full, empty, s2_ready);
    else if (threadIdx.x >= 32)
      quantize(p, smem + (q1 - ring), q1_ready, q1_empty);
  }
}

// ------------------------------------------------------------------- host
struct Plan {
  int bn, n_tiles, rows, stages, smem, grid, tiles, row_tiles;
};

// As many ring stages as fit beside the q1 tile (up to MAX_STAGES); fewer
// than two are refused.
bool make_plan(int B, int T, int C, int dil, const DeviceInfo& dv, Plan& pl) {
  if (!valid_shape(B, T, C, dil)) return false;
  pl.bn = pick_bn(C, &pl.n_tiles);
  pl.rows = (BM + 6 * dil) | 1;
  const long long fixed = ALIGN + (long long)pl.rows * C + 8LL * (2 * MAX_STAGES + 9);
  const long long room = dv.optin - fixed;
  const long long stage = (long long)pl.bn * KC;
  const long long stages = room / stage < MAX_STAGES ? room / stage : MAX_STAGES;
  if (stages < 2) return false;
  pl.stages = (int)stages;
  pl.smem = (int)(fixed + stages * stage);
  pl.row_tiles = (T + BM - 1) / BM;
  pl.tiles = B * pl.row_tiles;
  pl.grid = pl.tiles < dv.sms ? pl.tiles : dv.sms;
  return true;
}

template <int NW>
cudaError_t launch_cfg(const CUtensorMap* maps, const Params& prm, const Plan& pl, int dev,
                       int optin, cudaStream_t stream) {
  // the opt-in limit once per device and instantiation, before any capture
  static std::atomic<int> done[MAX_DEVICES];
  if (!done[dev].load(std::memory_order_acquire)) {
    const cudaError_t err = cudaFuncSetAttribute(
        resunit_int8_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    done[dev].store(1, std::memory_order_release);
  }
  resunit_int8_kernel<NW><<<pl.grid, THREADS, pl.smem, stream>>>(maps[0], maps[1], prm);
  return cudaGetLastError();
}

cudaError_t dispatch_bn(const CUtensorMap* maps, const Params& prm, const Plan& pl, int dev,
                        int optin, cudaStream_t s) {
  switch (pl.bn) {
    case 64: return launch_cfg<32>(maps, prm, pl, dev, optin, s);
    case 96: return launch_cfg<48>(maps, prm, pl, dev, optin, s);
    case 128: return launch_cfg<64>(maps, prm, pl, dev, optin, s);
    case 192: return launch_cfg<96>(maps, prm, pl, dev, optin, s);
    case 256: return launch_cfg<128>(maps, prm, pl, dev, optin, s);
    default: return cudaErrorInvalidValue;
  }
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

// Bytes of the tensor maps facodec_resunit_int8_maps writes.
extern "C" int facodec_resunit_int8_maps_bytes() { return 2 * (int)sizeof(CUtensorMap); }

// The TMA tensor maps of the packed weights, q7 (C, 7C) int8 K-major (K
// index tap * C + in) and w1 (C, C) bf16, boxes of KC and KC / 2 bytes,
// written to `maps` (host memory, facodec_resunit_int8_maps_bytes()). They
// hold the weights' device addresses: build them once per packed weight.
// Returns a cudaError_t.
extern "C" int facodec_resunit_int8_maps(const int8_t* q7, const uint16_t* w1, int C, void* maps) {
  if (C <= 0 || C % 32 != 0) return (int)cudaErrorInvalidValue;
  int n_tiles = 0;
  const int half = pick_bn(C, &n_tiles) / 2;
  CUtensorMap m[2];
  if (!encode_map(&m[0], q7, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, C, 7 * C, half, KC) ||
      !encode_map(&m[1], w1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, C, C, half, KC / 4))
    return (int)cudaErrorInvalidValue;
  memcpy(maps, m, sizeof(m));
  return 0;
}

// Bytes of the device scratch a call on device `dev` needs (each CTA's
// BM x C bf16 s2 tile), or -1 for shapes the kernel refuses.
extern "C" long long facodec_resunit_int8_scratch_bytes(int B, int T, int C, int dil, int dev) {
  const DeviceInfo* dv = device_info(dev);
  Plan pl;
  if (dv == nullptr || !make_plan(B, T, C, dil, *dv, pl)) return -1;
  return (long long)pl.grid * BM * C * 2;
}

// C entry point, bound with ctypes: the unit on x (B, T, C) float32 into
// out, with the row maxima amax (facodec_resunit_int8_amax), the weights of
// `maps` (facodec_resunit_int8_maps) and the packed operands (sw, b7, the
// alphas and reciprocals float32, b1 bf16 as 16-bit patterns), the pads
// and ext of facodec_resunit_f32, and `scratch` of
// facodec_resunit_int8_scratch_bytes. c7_out (B, T, C) float32 and q1_out
// (B, T + 6d, C) int8 may be null; given, they get the conv7's output and
// the quantized padded input. `dev`: the index of the current device.
// Returns a cudaError_t (0 = launched).
extern "C" int facodec_resunit_int8(const float* x, const float* amax, const void* maps,
                                    const float* sw, const float* b7, const uint16_t* b1,
                                    const float* alpha1, const float* recip1, const float* alpha2,
                                    const float* recip2, float* out, float* c7_out, int8_t* q1_out,
                                    void* scratch, int B, int T, int C, int dil, int pad_left,
                                    int ext, int dev, void* stream) {
  const DeviceInfo* dv = device_info(dev);
  Plan pl;
  if (dv == nullptr || scratch == nullptr || !make_plan(B, T, C, dil, *dv, pl) ||
      !valid_pads(T, dil, pad_left, ext))
    return (int)cudaErrorInvalidValue;
  const Params prm{x,      amax,   sw,       b7,         b1,        alpha1,
                   recip1, alpha2, recip2,   out,        c7_out,    q1_out,
                   static_cast<uint16_t*>(scratch),      T,         C,
                   dil,    pad_left,         ext,        pl.n_tiles, pl.rows,
                   pl.stages, pl.tiles,      pl.row_tiles};
  const CUtensorMap* m = static_cast<const CUtensorMap*>(maps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch_bn(m, prm, pl, dev, dv->optin, s);
}
