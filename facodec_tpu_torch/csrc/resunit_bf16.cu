// Fused DAC residual unit with bf16 activations, for Hopper (sm_90a): the
// kernel of the `hybrid` codec's decode (the `bfloat16_act` policy), and in
// two float32-in/out forms (the I/O forms below) the units of the
// `bfloat16` policy and the `int8` policy's units that do not quantize.
//
// Replaces the Pallas TPU kernel facodec_tpu/ops/pallas/resunit.py:273
// (`_forward`; body `_kernel`; entry `fused_residual_unit`) as the JAX
// package runs it on bf16 activations (`bfloat16_act`, resunit.py:134-198):
//
//   out[b,t,:] = x[b,t,:] + W1 . snake2(W7 (*)_d snake1(xpad)[b, t .. t+6d, :] + b7) + b1
//
// with xpad x padded as SConv1d pads (reflect; causal (6d, 0)), which the
// kernel does by reflecting the row index (padded_row). It rounds where the
// JAX package's default (unfused) path rounds under that policy, which is
// what the port's CPU tests hold the plain version to:
//   s1 = bf16(snake1(x))                      (snake in float32)
//   c7 = bf16(bf16(W7 (*)_d s1) + bf16(b7))   (bf16 operands, float32 sums)
//   s2 = bf16(snake2(c7))
//   y  = bf16(bf16(W1 . s2) + bf16(b1))
//   out = bf16(x + y)
// The snake is resunit_common.cuh's (__fmul_rn / __fadd_rn), so s1 and s2
// are the plain version's bits wherever their inputs are; the float32 sums
// of the two products differ from it in order only. Forward only.
// The float32-in/out forms read x and the biases and write out in float32
// (F32_ACT: the rounding above with out = x + y in float32; F32_BF16, the
// `bfloat16` policy's: c7 = float(bf16(W7 (*) s1)) + b7 and y =
// float(bf16(W1 . s2)) + b1 in float32). They double the bytes of x and
// out: at C = 64, 96 and 128 (2 C FLOP a byte) the bytes bound them.
//
// What bounds it. Per output row the unit does 16 C^2 FLOP (7 C^2 MACs in the
// conv7, C^2 in the 1x1) on 4 C bytes (x in, out out), and reads the 16 C^2
// bytes of bf16 weights once a call: 4 C FLOP per byte against the card's
// 989 TFLOP/s / 3.35 TB/s, about 295. So operations bound it at C = 768 to
// 192 (3072 to 768 FLOP/B), and C = 96 (384 FLOP/B) sits near the byte line.
// The snakes add CUDA-core work that the bound leaves out: about 30
// instructions per element of s1 (over BM + 6d rows) and of s2, which at
// C = 96 takes the SM's 128 lanes longer than the row's tensor-core work.
//
// Design, against what held back the mma.sync kernel it replaces:
// 1. wgmma. Both products are wgmma.mma_async m64nNk16 bf16 with float32
//    accumulators, A and B from shared memory. An N tile is BN output
//    channels (64, 96, 128, 192 or 256: C = 96 and 192 are one whole-width
//    tile, C = 384, 512, 768 two, two and three), split between two
//    consumer warpgroups of NW = BN / 2 channels each, so that both run
//    their epilogues at once. Rows come in tiles of BM = 128 (two m tiles)
//    where shared memory holds the 128-row s2 tile beside a ring of 3
//    stages and NW <= 96 (C = 96, 192, 384), else 64 (C = 768).
// 2. Weights by TMA. The wrapper packs w7 as the (out, 7C) K-major matrix (K
//    index tap * C + in) and w1 as (out, C), once per weight version, with a
//    TMA tensor map each. Thread 0 alone streams K slices of KC = 64 (rows
//    of 128 B, 128-byte swizzle; KC = 32 and the 64-byte swizzle where
//    C % 64 != 0 or C > 1024) into a ring of stages guarded by full / empty
//    mbarriers, as many as shared memory holds. Where every slice of a tile
//    fits (C <= 96), it loads them once and they stay resident for the call.
// 3. s1 and s2 stay on chip. Seven snake warps write s1 = snake1(xpad) for
//    a tile's BM + 6d padded rows into shared memory, KC channels at a
//    time (a group), into two group buffers, so that they compute the next
//    group while the consumers multiply this one. A group is stored
//    unswizzled in column order of 16-byte octets ([channel / 8][row][8]):
//    a core matrix (8 rows x 16 B) is then 128 contiguous bytes from any
//    start row, so the conv7's A for tap j is the same descriptor with its
//    start moved j * d rows, and no swizzle phase moves with it. The row
//    count R is made odd, so that stores of one row's octets spread over
//    the banks. Where C takes more than one N tile, each tile recomputes the
//    groups (x comes from L2 again). s2 stays as the BM x C tile in the same
//    layout and is the 1x1's A. Nothing is written to device memory but out,
//    at every width up to the fit below. Past it, the s2 tile goes to the
//    CTA's slice of a device scratch (BM x C, same layout; it stays in L2),
//    and thread 0 brings each 1x1 slice's A from there by bulk copy into the
//    ring stage beside its weight slice, once all 256 consumer threads have
//    stored the tile (an mbarrier).
// 4. A persistent grid: one CTA per SM walks the row tiles; the producers
//    load the next slices and compute the next groups while the consumers
//    run this tile's products and epilogues. The epilogues issue their
//    operand loads together (the 1x1's residual rows and b1 before its
//    products) and store s2 with st.shared: issued one at a time behind
//    each store, those loads had made the epilogues half of the kernel.
// Warp roles (512 threads): warp 0 issues the TMA copies, warps 1-7 compute
// s1, warpgroups 2 and 3 issue the wgmma and run the epilogues (b7, snake2
// into s2; b1 and the residual into out). setmaxnreg gives the consumers
// 176 registers and the producers 80.
//
// Shared memory per CTA at d = 9 (the ring takes what is left of 227 KB):
//   C    BN  BM   ring                   s1 groups      s2      total
//   96   96  128  24 x 6 KB, resident    2 x 11.4 KB    24 KB   192 KB
//   192  192 128  5 x 24 KB              2 x 22.9 KB    48 KB   215 KB
//   384  192 128  3 x 24 KB              2 x 22.9 KB    96 KB   215 KB
//   768  256 64   3 x 32 KB              2 x 14.9 KB    96 KB   223 KB
// s2 fits in shared memory up to C = 1408 at d = 9 and 1472 at d = 1 (KC = 32
// past 1024). Wider units take the scratch (facodec_resunit_bf16_scratch_bytes,
// 128 C bytes per CTA; 0 where s2 fits, as at every width of the flagship),
// with 10 stages of 20 KB in the ring: every C (a multiple of 32) is taken.
// The float32 entries' facodec_resunit_scratch_floats (csrc/resunit.cu) does
// not serve this entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"
#include "resunit_common.cuh"

namespace {

constexpr int THREADS = 512;        // warpgroups 0 and 1 produce, 2 and 3 consume
constexpr int SNAKE_THREADS = 224;  // warps 1-7
constexpr int CONSUMER_WARPS = 8;   // warpgroups 2 and 3, one arrival each on a release
constexpr int CONSUMER_THREADS = 256;
constexpr int MAX_STAGES = 32;
constexpr int ALIGN = 1024;         // of the ring's base (the swizzle atom is 512 B)

// ------------------------------------------------------------- bf16 bits
// bf16 values are kept as their 16-bit patterns: a bf16 is the top half of
// a float32, so widening is a shift.
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

// ------------------------------------------------------------- I/O forms
// IO = BF16: x, out, b7 and b1 bf16 (the bf16 entry). The float32-in/out
// forms read x and the biases and write out in float32, with s1 and s2
// bf16 on chip as in the bf16 entry:
//   F32_ACT (the bf16 entry's rounding; `int8`'s units that do not
//   quantize, given a float32 x): c7 = bf16(bf16(acc) + bf16(b7)),
//   y = bf16(bf16(acc) + bf16(b1)), out = x + y in float32;
//   F32_BF16 (the `bfloat16` policy's): c7 = float(bf16(acc)) + b7,
//   y = float(bf16(acc)) + b1, out = x + y, every sum in float32.
constexpr int BF16 = 0, F32_ACT = 1, F32_BF16 = 2;
template <int IO>
using io_t = std::conditional_t<IO == BF16, uint16_t, float>;
// two adjacent biases as loaded: their bf16 bits, or two floats
template <int IO>
using bias2_t = std::conditional_t<IO == BF16, uint32_t, float2>;

template <int IO>
__device__ __forceinline__ bias2_t<IO> load_bias2(const void* base, int col) {
  if constexpr (IO == BF16)
    return __ldg(reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(base) + col));
  else
    return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(base) + col));
}
__device__ __forceinline__ float bias_lo(uint32_t b) { return lo_bf(b); }
__device__ __forceinline__ float bias_hi(uint32_t b) { return hi_bf(b); }
__device__ __forceinline__ float bias_lo(float2 b) { return b.x; }
__device__ __forceinline__ float bias_hi(float2 b) { return b.y; }

// A conv's output element from its float32 sum and its bias, rounded where
// the form's policy rounds (above).
template <int IO>
__device__ __forceinline__ float conv_out(float acc, float bias) {
  if constexpr (IO == F32_BF16)
    return __fadd_rn(round_bf(acc), bias);
  else
    return round_bf(__fadd_rn(round_bf(acc), IO == F32_ACT ? round_bf(bias) : bias));
}

// Eight consecutive channels of one x row, as loaded (16 bytes of bf16,
// or 32 of float32), and widened to float32 one at a time (i is a
// constant after unrolling).
template <int IO>
struct Row8;
template <>
struct Row8<BF16> {
  uint4 w;
  __device__ __forceinline__ void load(const uint16_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { w = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float get(int i) const {
    const uint32_t v = i < 2 ? w.x : i < 4 ? w.y : i < 6 ? w.z : w.w;
    return (i & 1) ? hi_bf(v) : lo_bf(v);
  }
};
struct Row8F32 {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p + 4));
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float get(int i) const {
    const float4& v = i < 4 ? a : b;
    const int k = i & 3;
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <>
struct Row8<F32_ACT> : Row8F32 {};
template <>
struct Row8<F32_BF16> : Row8F32 {};

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }
__device__ __forceinline__ void snake_sync() { asm volatile("bar.sync 2, 224;" ::: "memory"); }

// The kernel's scalars (by value). Shapes: x, out (B, T, C) and b7, b1 (C),
// bf16 or float32 as the I/O form says (io_t); alpha1, recip1, alpha2,
// recip2 (C) float32, recip = 1 / (alpha + 1e-9).
struct Params {
  const void* x;
  const void *b7, *b1;
  const float *alpha1, *recip1, *alpha2, *recip2;
  void* out;
  uint8_t* s2g;   // the scratch s2 tiles, BM x C bf16 per CTA (SPILL only)
  int T, C, dil, pad_left, ext;
  int n_tiles;    // N tiles of BN output channels
  int rows;       // R, rows of an s1 group: BM + 6d, made odd
  int stages;     // weight slices the ring holds
  int stage;      // bytes of a ring stage: the weight slice (and, SPILL, its A)
  int resident;   // the ring holds every slice of a tile: each loaded once
  int tiles, row_tiles;  // row tiles in all, and per batch row
};

// Thread 0: every weight slice the consumers take, in their order, into the
// ring. Per tile: for each N tile, each s1 group and tap, the group's K
// slice of w7; then for each N tile the C / KC slices of w1 (with SPILL,
// each with its K slice of the scratch s2 tile, once the consumers have
// stored the tile).
template <int BN, int KC, int BM, bool SPILL>
__device__ void load_weights(const CUtensorMap* map7, const CUtensorMap* map1, const Params& p,
                             uint32_t ring, uint32_t full, uint32_t empty, uint32_t s2_ready) {
  constexpr int B_BYTES = BN * KC * 2, A_BYTES = BM * KC * 2;
  int it = 0;
  auto load = [&](const CUtensorMap* map, int k, int n, const uint8_t* a) {
    const int s = it % p.stages;
    if (!p.resident) mbar_wait(empty + 8 * s, ((it / p.stages) & 1) ^ 1);
    const uint32_t dst = ring + s * p.stage;
    mbar_expect_tx(full + 8 * s, a != nullptr ? B_BYTES + A_BYTES : B_BYTES);
    tma_load(dst, map, k, n, full + 8 * s);
    if (a != nullptr) bulk_load(dst + B_BYTES, a, A_BYTES, full + 8 * s);
    ++it;
  };
  const uint8_t* s2 = SPILL ? p.s2g + (size_t)blockIdx.x * BM * p.C * 2 : nullptr;
  for (int tile = blockIdx.x, k = 0; tile < p.tiles; tile += gridDim.x, ++k) {
    for (int nt = 0; nt < p.n_tiles; ++nt)
      for (int g = 0; g < p.C; g += KC)
        for (int tap = 0; tap < 7; ++tap) load(map7, tap * p.C + g, nt * BN, nullptr);
    if constexpr (SPILL) {
      mbar_wait(s2_ready, k & 1);
      fence_async_global();
    }
    for (int nt = 0; nt < p.n_tiles; ++nt)
      for (int c = 0; c < p.C; c += KC)
        load(map1, c, nt * BN, SPILL ? s2 + (size_t)(c / 8) * BM * 16 : nullptr);
    if (p.resident) break;
  }
}

// Warps 1-7: s1 of each group of KC channels the consumers take, in their
// order, into the two group buffers ([octet][row][8] bf16; rows past the
// padded input are zero).
template <int BM, int KC, int IO>
__device__ void snake_groups(const Params& p, uint8_t* s1, uint32_t s1_full, uint32_t s1_empty) {
  constexpr int octs = KC / 8, sh = octs == 8 ? 3 : 2;
  const int i0 = threadIdx.x - 32;
  const int rows_in = BM + 6 * p.dil, Tp = p.T + 6 * p.dil, n = rows_in * octs;
  const int bytes = p.rows * KC * 2;
  constexpr int U = IO == BF16 ? 4 : 2;  // 64 bytes of x in flight a thread
  int grp = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.row_tiles, t0 = (tile % p.row_tiles) * BM;
    const io_t<IO>* xb = static_cast<const io_t<IO>*>(p.x) + (size_t)b * p.T * p.C;
    for (int nt = 0; nt < p.n_tiles; ++nt)
      for (int g = 0; g < p.C; g += KC, ++grp) {
        const int buf = grp & 1;
        // one thread polls the barrier; the others sleep in the named barrier
        if (i0 == 0) mbar_wait(s1_empty + 8 * buf, ((grp >> 1) & 1) ^ 1);
        snake_sync();
        uint8_t* dst = s1 + buf * bytes;
        // SNAKE_THREADS is a multiple of 8: a thread's octet, and so its
        // channels and snake parameters, stay the same for the whole group
        const int o = i0 & (octs - 1), c = g + 8 * o;
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(p.alpha1 + c));
        const float4 a1 = __ldg(reinterpret_cast<const float4*>(p.alpha1 + c + 4));
        const float4 r0 = __ldg(reinterpret_cast<const float4*>(p.recip1 + c));
        const float4 r1 = __ldg(reinterpret_cast<const float4*>(p.recip1 + c + 4));
        // U rows at a time: their loads are issued together, then used
        for (int e0 = i0; e0 < n; e0 += U * SNAKE_THREADS) {
          Row8<IO> w[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = (e0 + u * SNAKE_THREADS) >> sh, pr = t0 + r;
            const int q = r >= rows_in || pr >= Tp ? -1 : padded_row(pr, p.T, p.ext, p.pad_left);
            if (q < 0)
              w[u].zero();
            else
              w[u].load(xb + (size_t)q * p.C + c);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = (e0 + u * SNAKE_THREADS) >> sh, pr = t0 + r;
            if (r >= rows_in) break;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (pr < Tp && padded_row(pr, p.T, p.ext, p.pad_left) >= 0) {
              v.x = pack_bf(snakef(w[u].get(0), a0.x, r0.x), snakef(w[u].get(1), a0.y, r0.y));
              v.y = pack_bf(snakef(w[u].get(2), a0.z, r0.z), snakef(w[u].get(3), a0.w, r0.w));
              v.z = pack_bf(snakef(w[u].get(4), a1.x, r1.x), snakef(w[u].get(5), a1.y, r1.y));
              v.w = pack_bf(snakef(w[u].get(6), a1.z, r1.z), snakef(w[u].get(7), a1.w, r1.w));
            }
            *reinterpret_cast<uint4*>(dst + ((size_t)o * p.rows + r) * 16) = v;
          }
        }
        fence_async_smem();
        mbar_arrive(s1_full + 8 * buf);
      }
  }
}

// The consumer's side of the weight ring and the s1 buffers. `stage` and
// `phase` are the next slice's ring stage and full-barrier parity, `tail`
// the stage of the oldest slice not yet released, `running` the slices
// whose wgmma may still run. The s1 buffer `s1_buf` (or -1) is read last by
// the slice that `s1_after` more releases complete.
struct Pipe {
  uint32_t ring, full, empty, s1_empty;
  int stages, resident, lane;
  int stage, phase, tail, running, s1_buf, s1_after;

  // The oldest n running slices have finished: free their stages (and the
  // s1 buffer, after its last reader).
  __device__ __forceinline__ void release(int n) {
    for (; n > 0; --n) {
      if (lane == 0 && !resident) mbar_arrive(empty + 8 * tail);
      tail = tail + 1 == stages ? 0 : tail + 1;
      --running;
      if (s1_buf >= 0 && --s1_after == 0) {
        if (lane == 0) mbar_arrive(s1_empty + 8 * s1_buf);
        s1_buf = -1;
      }
    }
  }
};

template <int MT, int NA>
__device__ __forceinline__ void zero(float (&acc)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[m][i] = 0.f;
}

template <int MT, int NA>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][NA]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
}

// One weight slice (KC K elements) for this warpgroup's NW output channels
// (rows `b_off` bytes into the stage): KC / 16 k16 steps for each m tile.
// `a` is the A descriptor of m tile 0, step 0; each step is `ks_step` on
// and each m tile 64 rows (64 x 16 B) on, in the descriptor's 16-byte
// units. `first` marks an accumulation's first slice: its registers were
// written by other instructions, so it needs wgmma.fence (wgmma of one
// shape on the same accumulators are ordered among themselves). One
// slice's wgmma keeps running while the next one is issued.
template <int NW, int MT, int KC>
__device__ __forceinline__ void slice(float (&acc)[MT][NW / 2], Pipe& q, uint32_t stage_bytes,
                                      uint32_t b_off, uint64_t a, uint32_t ks_step, bool first,
                                      int ends_s1) {
  mbar_wait(q.full + 8 * q.stage, q.resident ? 0 : q.phase);
  const uint64_t b = desc_sw<2 * KC>(q.ring + q.stage * stage_bytes + b_off);
  fence_acc(acc);
  if (first) wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
    for (int m = 0; m < MT; ++m) wgmma<NW>(acc[m], a + ks * ks_step + 64 * m, b + 2 * ks);
  wgmma_commit();
  if (++q.stage == q.stages) {
    q.stage = 0;
    q.phase ^= 1;
  }
  ++q.running;
  if (ends_s1 >= 0) {
    q.s1_buf = ends_s1;
    q.s1_after = q.running;
  }
  wgmma_wait<1>();
  fence_acc(acc);
  q.release(q.running - 1);
}

template <int MT, int NA>
__device__ __forceinline__ void drain(float (&acc)[MT][NA], Pipe& q) {
  wgmma_wait<0>();
  fence_acc(acc);
  q.release(q.running);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v));
}

// Epilogues. A thread's accumulator element 4j + 2h + i of m tile m is row
// 64m + rq + 8h (rq = 16 * warp + lane / 4), column col0 + 8j + i (col0 =
// the warpgroup's first column of the N tile + 2 (lane % 4)). Columns go in
// groups of JC n8 blocks whose loads are issued together, then used, so
// that their latencies overlap; columns past C (a ragged last N tile) are
// computed on clamped operands and not stored.
template <int NW>
constexpr int JC = (NW / 8) % 4 == 0 ? 4 : 2;

// s2 = bf16(snake2(c7)), c7 = conv_out(acc, b7), into the s2 tile (with
// SPILL, the CTA's scratch tile s2g).
template <int NW, int MT, bool SPILL, int IO>
__device__ __forceinline__ void store_s2(const float (&acc)[MT][NW / 2], const Params& p,
                                         uint32_t s2, uint8_t* s2g, int col0, int rq) {
  constexpr int BM = 64 * MT;
  const float* __restrict__ alpha2 = p.alpha2;
  const float* __restrict__ recip2 = p.recip2;
#pragma unroll
  for (int j0 = 0; j0 < NW / 8; j0 += JC<NW>) {
    bias2_t<IO> bias[JC<NW>];
    float2 al[JC<NW>], rc[JC<NW>];
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj) {
      const int col = min(col0 + 8 * (j0 + jj), p.C - 2);
      bias[jj] = load_bias2<IO>(p.b7, col);
      al[jj] = __ldg(reinterpret_cast<const float2*>(alpha2 + col));
      rc[jj] = __ldg(reinterpret_cast<const float2*>(recip2 + col));
    }
#pragma unroll
    for (int jj = 0; jj < JC<NW>; ++jj) {
      const int j = j0 + jj, col = col0 + 8 * j;
      if (col >= p.C) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float c0 = conv_out<IO>(acc[m][4 * j + 2 * h], bias_lo(bias[jj]));
          const float c1 = conv_out<IO>(acc[m][4 * j + 2 * h + 1], bias_hi(bias[jj]));
          const int r = 64 * m + rq + 8 * h, off = (((col >> 3) * BM + r) * 8 + (col & 7)) * 2;
          const uint32_t v =
              pack_bf(snakef(c0, al[jj].x, rc[jj].x), snakef(c1, al[jj].y, rc[jj].y));
          if constexpr (SPILL)
            *reinterpret_cast<uint32_t*>(s2g + off) = v;
          else
            st_shared(s2 + off, v);
        }
    }
  }
}

// The residual rows x (bf16 entry only: float32 rows would not fit the
// registers beside the accumulators) and b1 of this thread's output
// elements, loaded before the 1x1's products so that their latency hides
// behind them.
template <int NW, int MT, int IO>
struct OutOperands {
  uint32_t x[IO == BF16 ? NW / 8 : 1][MT][2];
  bias2_t<IO> bias[NW / 8];
};

template <int NW, int MT, int IO>
__device__ __forceinline__ void load_out_operands(OutOperands<NW, MT, IO>& o, const Params& p,
                                                  int b, int t0, int col0, int rq) {
  const uint16_t* __restrict__ x = static_cast<const uint16_t*>(p.x);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = min(col0 + 8 * j, p.C - 2);
    o.bias[j] = load_bias2<IO>(p.b1, col);
    if constexpr (IO == BF16) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tr = min(t0 + 64 * m + rq + 8 * h, p.T - 1);
          o.x[j][m][h] =
              __ldg(reinterpret_cast<const uint32_t*>(x + ((size_t)b * p.T + tr) * p.C + col));
        }
    }
  }
}

// out = x + conv_out(acc, b1): in bf16 for the bf16 entry (bf16(x + y)),
// else in float32, its x rows loaded JC n8 blocks at a time.
template <int NW, int MT, int IO>
__device__ __forceinline__ void store_out(const float (&acc)[MT][NW / 2],
                                          const OutOperands<NW, MT, IO>& o, const Params& p,
                                          int b, int t0, int col0, int rq) {
  if constexpr (IO == BF16) {
    uint16_t* __restrict__ out = static_cast<uint16_t*>(p.out);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tr = t0 + 64 * m + rq + 8 * h;
        uint16_t* row = out + ((size_t)b * p.T + tr) * p.C;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const int col = col0 + 8 * j;
          const float y0 = conv_out<IO>(acc[m][4 * j + 2 * h], bias_lo(o.bias[j]));
          const float y1 = conv_out<IO>(acc[m][4 * j + 2 * h + 1], bias_hi(o.bias[j]));
          const uint32_t w = o.x[j][m][h];
          if (tr < p.T && col < p.C)
            *reinterpret_cast<uint32_t*>(row + col) =
                pack_bf(__fadd_rn(lo_bf(w), y0), __fadd_rn(hi_bf(w), y1));
        }
      }
  } else {
    const float* __restrict__ x = static_cast<const float*>(p.x);
    float* __restrict__ out = static_cast<float*>(p.out);
#pragma unroll
    for (int j0 = 0; j0 < NW / 8; j0 += JC<NW>) {
      float2 xv[JC<NW>][MT][2];
#pragma unroll
      for (int jj = 0; jj < JC<NW>; ++jj)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = min(col0 + 8 * (j0 + jj), p.C - 2);
            const int tr = min(t0 + 64 * m + rq + 8 * h, p.T - 1);
            xv[jj][m][h] =
                __ldg(reinterpret_cast<const float2*>(x + ((size_t)b * p.T + tr) * p.C + col));
          }
#pragma unroll
      for (int jj = 0; jj < JC<NW>; ++jj)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = j0 + jj, col = col0 + 8 * j, tr = t0 + 64 * m + rq + 8 * h;
            const float y0 = conv_out<IO>(acc[m][4 * j + 2 * h], bias_lo(o.bias[j]));
            const float y1 = conv_out<IO>(acc[m][4 * j + 2 * h + 1], bias_hi(o.bias[j]));
            if (tr < p.T && col < p.C)
              *reinterpret_cast<float2*>(out + ((size_t)b * p.T + tr) * p.C + col) =
                  make_float2(__fadd_rn(xv[jj][m][h].x, y0), __fadd_rn(xv[jj][m][h].y, y1));
          }
    }
  }
}

// Warpgroups 2 and 3 (cw = 0, 1), each NW = BN / 2 of an N tile's output
// channels: per tile, conv7 (+ b7, snake2) into s2, then the 1x1 (+ b1, + x)
// into out.
template <int NW, int MT, int KC, bool SPILL, int IO>
__device__ void consume(const Params& p, uint32_t ring, uint32_t s1, uint32_t s2, uint32_t full,
                        uint32_t empty, uint32_t s1_full, uint32_t s1_empty, uint32_t s2_ready) {
  constexpr int BM = 64 * MT, BN = 2 * NW;
  const uint32_t stage = p.stage;
  uint8_t* s2g = SPILL ? p.s2g + (size_t)blockIdx.x * BM * p.C * 2 : nullptr;
  const int tid = threadIdx.x - 256, cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rq = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t b_off = cw * NW * KC * 2;  // this warpgroup's rows of a stage
  const int bytes = p.rows * KC * 2;
  Pipe q{ring, full, empty, s1_empty, p.stages, p.resident, lane, 0, 0, 0, 0, -1, 0};
  float acc[MT][NW / 2];
  int grp = 0;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int b = tile / p.row_tiles, t0 = (tile % p.row_tiles) * BM;
    // 1. s2 = bf16(snake2(conv_out(conv7(s1), b7))), one N tile at a time
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      zero(acc);
      for (int g = 0; g < p.C; g += KC, ++grp) {
        const int buf = grp & 1;
        mbar_wait(s1_full + 8 * buf, (grp >> 1) & 1);
        const uint32_t a0 = s1 + buf * bytes;
        for (int tap = 0; tap < 7; ++tap)
          slice<NW, MT, KC>(acc, q, stage, b_off,
                            desc_a(a0 + tap * p.dil * 16, p.rows * 16), 2 * p.rows,
                            g == 0 && tap == 0, tap == 6 ? buf : -1);
      }
      drain(acc, q);
      if (nt == 0) consumer_sync();  // both warpgroups are past the previous tile's 1x1 on s2
      store_s2<NW, MT, SPILL, IO>(acc, p, s2, s2g, nt * BN + cw * NW + cq, rq);
    }
    if constexpr (SPILL) {
      fence_async_global();
      mbar_arrive(s2_ready);  // s2 complete: thread 0 may copy it
    } else {
      fence_async_smem();
      consumer_sync();  // s2 complete, and visible to the wgmma
    }

    // 2. out = x + conv_out(conv1x1(s2), b1)
    for (int nt = 0; nt < p.n_tiles; ++nt) {
      const int col0 = nt * BN + cw * NW + cq;
      OutOperands<NW, MT, IO> o;
      load_out_operands<NW, MT, IO>(o, p, b, t0, col0, rq);
      zero(acc);
      for (int c = 0; c < p.C; c += KC) {
        // A: the s2 tile's K slice, or its copy behind the weight slice in the stage
        const uint32_t a = SPILL ? q.ring + q.stage * stage + BN * KC * 2 : s2 + (c / 8) * BM * 16;
        slice<NW, MT, KC>(acc, q, stage, b_off, desc_a(a, BM * 16), 2 * BM, c == 0, -1);
      }
      drain(acc, q);
      store_out<NW, MT, IO>(acc, o, p, b, t0, col0, rq);
    }
  }
}

// map7, map1: the TMA tensor maps of the packed w7 (C, 7C) and w1 (C, C),
// boxes of KC K elements x BN rows, swizzled over their 2 KC-byte rows.
template <int NW, int MT, int KC, bool SPILL, int IO>
__global__ void __launch_bounds__(THREADS, 1)
resunit_bf16_kernel(const __grid_constant__ CUtensorMap map7,
                    const __grid_constant__ CUtensorMap map1, const Params p) {
  constexpr int BM = 64 * MT, BN = 2 * NW;
  extern __shared__ uint8_t smem_raw[];
  // [ring: stages x stage][s1: 2 groups of R x KC][s2: BM x C, unless SPILL][mbarriers]
  uint8_t* smem = smem_raw + (ALIGN - smem_addr(smem_raw) % ALIGN) % ALIGN;
  const uint32_t ring = smem_addr(smem);
  const uint32_t s1 = ring + p.stages * p.stage;
  const uint32_t s2 = s1 + 2 * p.rows * KC * 2;
  const uint32_t full = s2 + (SPILL ? 0 : BM * p.C * 2), empty = full + 8 * MAX_STAGES;
  const uint32_t s1_full = empty + 8 * MAX_STAGES, s1_empty = s1_full + 16;
  const uint32_t s2_ready = s1_empty + 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(s1_full + 8 * i, SNAKE_THREADS);
      mbar_init(s1_empty + 8 * i, CONSUMER_WARPS);
    }
    mbar_init(s2_ready, CONSUMER_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 176;");
    consume<NW, MT, KC, SPILL, IO>(p, ring, s1, s2, full, empty, s1_full, s1_empty, s2_ready);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;");
    if (threadIdx.x == 0)
      load_weights<BN, KC, BM, SPILL>(&map7, &map1, p, ring, full, empty, s2_ready);
    else if (threadIdx.x >= 32)
      snake_groups<BM, KC, IO>(p, smem + (s1 - ring), s1_full, s1_empty);
  }
}

// ------------------------------------------------------------------- host
// The tile shapes, ring and grid of one call.
struct Plan {
  int bn, mt, kc, n_tiles, rows, stages, stage, resident, spill, smem, grid, tiles, row_tiles;
};

// K elements of a weight slice: 64 (128-byte rows) where C % 64 == 0 and
// two such stages fit beside a 64-row s2 tile (C <= 1024), else 32.
int slice_k(int C) { return C % 64 == 0 && C <= 1024 ? 64 : 32; }

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

// The ring's share of shared memory at BM rows per tile: stages of
// BN x KC weights (with `spill`, and BM x KC of s2), after the two s1
// groups, the s2 tile (unless `spill`) and the barriers.
void fit_ring(int C, int dil, int bm, bool spill, Plan& pl) {
  pl.mt = bm / 64;
  pl.spill = spill;
  pl.rows = (bm + 6 * dil) | 1;
  pl.stage = (pl.bn + (spill ? bm : 0)) * pl.kc * 2;
  const long long stage = pl.stage;
  const long long fixed = ALIGN + 2LL * pl.rows * pl.kc * 2 + (spill ? 0LL : (long long)bm * C * 2) +
                          8LL * (2 * MAX_STAGES + 5);
  const long long slices = (long long)pl.n_tiles * 8 * C / pl.kc;  // 7C / KC + C / KC per N tile
  const long long fit = (device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) - fixed) / stage;
  const long long stages = slices < fit ? slices : fit;
  pl.stages = (int)(stages < MAX_STAGES ? stages : (long long)MAX_STAGES);
  pl.resident = pl.stages == slices;
  pl.smem = (int)(fixed + (pl.stages > 0 ? pl.stages : 0) * stage);
}

// 128-row tiles (two m tiles) where the ring keeps 3 stages and each
// consumer warpgroup's NW = BN / 2 <= 96 (its accumulators then fit beside
// the prefetched epilogue operands), else 64; s2 in the scratch where a
// 64-row s2 tile leaves no room for two stages.
bool make_plan(int B, int T, int C, int dil, Plan& pl) {
  pl.bn = pick_bn(C, &pl.n_tiles);
  pl.kc = slice_k(C);
  fit_ring(C, dil, 128, false, pl);
  if (pl.bn > 192 || (pl.stages < 3 && !pl.resident)) fit_ring(C, dil, 64, false, pl);
  if (pl.stages < 2) fit_ring(C, dil, 64, true, pl);
  if (pl.stages < 2) return false;
  const int bm = 64 * pl.mt;
  pl.row_tiles = (T + bm - 1) / bm;
  pl.tiles = B * pl.row_tiles;
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  pl.grid = pl.tiles < sms ? pl.tiles : sms;
  return true;
}

template <int NW, int MT, int KC, bool SPILL, int IO>
cudaError_t launch_cfg(const CUtensorMap& m7, const CUtensorMap& m1, const Params& prm,
                       const Plan& pl, cudaStream_t stream) {
  // the opt-in limit once per device, before any capture into a graph
  static int set_for = -1;
  int dev = 0;
  cudaGetDevice(&dev);
  if (set_for != dev) {
    const cudaError_t err =
        cudaFuncSetAttribute(resunit_bf16_kernel<NW, MT, KC, SPILL, IO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin));
    if (err != cudaSuccess) return err;
    set_for = dev;
  }
  resunit_bf16_kernel<NW, MT, KC, SPILL, IO><<<pl.grid, THREADS, pl.smem, stream>>>(m7, m1, prm);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the two tensor maps facodec_resunit_bf16_maps writes.
extern "C" int facodec_resunit_bf16_maps_bytes() { return 2 * (int)sizeof(CUtensorMap); }

// The TMA tensor maps of the packed weights, w7 (C, 7C) K-major (K index
// tap * C + in) and w1 (C, C), both bf16, written to `maps` (host memory,
// facodec_resunit_bf16_maps_bytes()). They hold the weights' device
// addresses: build them once per packed weight. Returns a cudaError_t.
extern "C" int facodec_resunit_bf16_maps(const uint16_t* w7, const uint16_t* w1, int C,
                                         void* maps) {
  if (C <= 0 || C % 32 != 0) return (int)cudaErrorInvalidValue;
  int n_tiles = 0;
  const int bn = pick_bn(C, &n_tiles);
  CUtensorMap m[2];
  const int kc = slice_k(C);
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_map(&m[0], w7, bf16, 2, C, 7 * C, bn, kc) ||
      !encode_map(&m[1], w1, bf16, 2, C, C, bn, kc))
    return (int)cudaErrorInvalidValue;
  memcpy(maps, m, sizeof(m));
  return 0;
}

// The plan of a call, for reports: {BN, BM, N tiles, KC (the K elements of
// a weight slice, and the channels of an s1 group), ring stages, resident,
// s2 in the scratch, shared-memory bytes, grid, row tiles}. Returns 0, or
// cudaErrorInvalidValue for shapes the kernel refuses.
extern "C" int facodec_resunit_bf16_plan(int B, int T, int C, int dil, int* out) {
  Plan pl;
  if (!valid_shape(B, T, C, dil) || !make_plan(B, T, C, dil, pl)) return (int)cudaErrorInvalidValue;
  const int v[10] = {pl.bn, 64 * pl.mt, pl.n_tiles, pl.kc, pl.stages, pl.resident, pl.spill,
                     pl.smem, pl.grid, pl.tiles};
  memcpy(out, v, sizeof(v));
  return 0;
}

// Bytes of device scratch a call needs: each CTA's s2 tile where it does
// not fit in shared memory, else 0; -1 for shapes the kernel refuses.
extern "C" long long facodec_resunit_bf16_scratch_bytes(int B, int T, int C, int dil) {
  Plan pl;
  if (!valid_shape(B, T, C, dil) || !make_plan(B, T, C, dil, pl)) return -1;
  return pl.spill ? (long long)pl.grid * 64 * pl.mt * C * 2 : 0;
}

namespace {

constexpr int cfg_key(int bn, int mt, int kc, int spill) {
  return ((bn * 4 + mt) * 2 + (kc == 64)) * 2 + spill;
}

// The instantiation of a plan, for I/O form IO.
template <int IO>
cudaError_t dispatch(const CUtensorMap& m7, const CUtensorMap& m1, const Params& prm,
                     const Plan& pl, cudaStream_t s) {
  switch (cfg_key(pl.bn, pl.mt, pl.kc, pl.spill)) {
    case cfg_key(64, 2, 64, 0): return launch_cfg<32, 2, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(64, 1, 64, 0): return launch_cfg<32, 1, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(128, 2, 64, 0): return launch_cfg<64, 2, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(128, 1, 64, 0): return launch_cfg<64, 1, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(192, 2, 64, 0): return launch_cfg<96, 2, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(192, 1, 64, 0): return launch_cfg<96, 1, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(256, 1, 64, 0): return launch_cfg<128, 1, 64, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(64, 2, 32, 0): return launch_cfg<32, 2, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(64, 1, 32, 0): return launch_cfg<32, 1, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(96, 2, 32, 0): return launch_cfg<48, 2, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(96, 1, 32, 0): return launch_cfg<48, 1, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(192, 2, 32, 0): return launch_cfg<96, 2, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(192, 1, 32, 0): return launch_cfg<96, 1, 32, false, IO>(m7, m1, prm, pl, s);
    case cfg_key(256, 1, 32, 0): return launch_cfg<128, 1, 32, false, IO>(m7, m1, prm, pl, s);
    // s2 in the scratch: past the fit (C >= 1440), so 32-wide slices and 256-wide N tiles
    case cfg_key(256, 1, 32, 1): return launch_cfg<128, 1, 32, true, IO>(m7, m1, prm, pl, s);
    default: return cudaErrorInvalidValue;
  }
}

int launch_io(int io, const void* x, const void* maps, const void* b7, const void* b1,
              const float* alpha1, const float* recip1, const float* alpha2, const float* recip2,
              void* out, void* scratch, int B, int T, int C, int dil, int pad_left, int ext,
              void* stream) {
  Plan pl;
  if (!valid_shape(B, T, C, dil) || !valid_pads(T, dil, pad_left, ext) ||
      !make_plan(B, T, C, dil, pl) || (pl.spill && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[2];
  memcpy(m, maps, sizeof(m));
  const Params prm{x, b7, b1, alpha1, recip1, alpha2, recip2, out, static_cast<uint8_t*>(scratch),
                   T, C, dil, pad_left, ext, pl.n_tiles, pl.rows, pl.stages, pl.stage,
                   pl.resident, pl.tiles, pl.row_tiles};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (io) {
    case BF16: return (int)dispatch<BF16>(m[0], m[1], prm, pl, s);
    case F32_ACT: return (int)dispatch<F32_ACT>(m[0], m[1], prm, pl, s);
    case F32_BF16: return (int)dispatch<F32_BF16>(m[0], m[1], prm, pl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes: the unit on x (B, T, C) bf16 into out,
// with the weights of `maps` (facodec_resunit_bf16_maps) and the pads and
// ext of facodec_resunit_f32; `scratch` holds facodec_resunit_bf16_scratch_bytes
// (null where that is 0). bf16 tensors are passed as their 16-bit patterns.
// Returns a cudaError_t (0 = launched).
extern "C" int facodec_resunit_bf16(const uint16_t* x, const void* maps, const uint16_t* b7,
                                    const uint16_t* b1, const float* alpha1, const float* recip1,
                                    const float* alpha2, const float* recip2, uint16_t* out,
                                    void* scratch, int B, int T, int C, int dil, int pad_left,
                                    int ext, void* stream) {
  return launch_io(BF16, x, maps, b7, b1, alpha1, recip1, alpha2, recip2, out, scratch, B, T, C,
                   dil, pad_left, ext, stream);
}

// The float32-in/out forms: x, out (B, T, C) and b7, b1 (C) float32, the
// rest as facodec_resunit_bf16's; `act` != 0 rounds as the bf16 entry does,
// 0 as the bfloat16 policy does (the I/O forms above).
extern "C" int facodec_resunit_bf16_f32io(const float* x, const void* maps, const float* b7,
                                          const float* b1, const float* alpha1,
                                          const float* recip1, const float* alpha2,
                                          const float* recip2, float* out, void* scratch, int B,
                                          int T, int C, int dil, int pad_left, int ext, int act,
                                          void* stream) {
  return launch_io(act ? F32_ACT : F32_BF16, x, maps, b7, b1, alpha1, recip1, alpha2, recip2, out,
                   scratch, B, T, C, dil, pad_left, ext, stream);
}
