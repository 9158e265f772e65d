// W8A8 LSTM recurrence, one whole layer in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as an XLA
// scan (facodec_tpu/nn/lstm.py `lstm_layer`, the `_lstm_int8` branch,
// :110-139), opt-in by FACODEC_LSTM_INT8. cuDNN has no int8 recurrence, and
// a host loop over the 800 steps of a 10 s decode costs some ten launches a
// step, so the port carries it here. Per step t, for each row b:
//
//   s_h  = max(max_k |h[b,k]|, 1e-12) * f32(1/127)
//   hq   = clip(rint(h[b,:] / s_h), -127, 127)                   (int8)
//   acc  = sum_k hq[k] * w_q[j,k]                 (int32, exact; w_q (4H, H))
//   gate = xp[b,t,j] + f32(acc) * (s_h * w_scale[j])
//   c    = sig(f) * c + sig(i) * tanh(g),  h = sig(o) * tanh(c)   (float32)
//
// with the gates i, f, g, o at columns j, H + j, 2H + j, 3H + j (torch's
// order). w_q is w_hh quantized per row (the JAX package's w_hh.T per
// column, transposed), w_scale its row scales. The arithmetic is the plain
// version's op for op (ops/kernels/lstm.py `lstm_int8_reference`): a true
// division and round half to even in the quantizer (no --use_fast_math),
// each product and sum rounded on its own (__fmul_rn / __fadd_rn, so that
// nvcc contracts nothing into an FMA), sigmoid as 1 / (1 + expf(-x)) and
// tanhf as PyTorch's CUDA kernels compute them.
//
// What bounds it on this card: the recurrence is serial. At the decoder's
// shape (H = 1536, B = 4, T = 800) a step is 2 * B * 4H * H = 75.5 M int8
// operations (38 ns at 1979 TOPS) on 9.4 MB of int8 weights, so the time
// is T times a step's latency: reading h, quantizing it, the dot products,
// the cell, and one grid-wide barrier.
//
// What the design does about it:
// - A persistent cooperative grid of at most one CTA per SM. CTA k owns
//   hidden units [k * hs, (k + 1) * hs) and their four gate columns, so the
//   cell update stays in the CTA; at H = 1536 on 132 SMs, hs = 12 and 128
//   CTAs. Its H x 4hs int8 weight slice (72 KB) and their scales are loaded
//   into shared memory once and kept for all T steps; c stays in shared
//   memory too.
// - Each step every CTA reads all of h_{t-1} (rows of y itself, or h0) with
//   __ldcg, which skips L1: an SM may hold a stale L1 line of y from
//   another step. It stages the rows in shared memory (float4 loads, all in
//   flight together, beside the loads of the step's projections for its
//   columns: one L2 round trip a step, where a warp reading a row in a loop
//   waited on one for every 32 values), forms each row's absmax there and
//   quantizes the rows into shared memory, RB rows at a time, so that any
//   batch fits.
// - A warp's task is RT rows x 4 gate columns: each lane runs __dp4a over
//   16-byte slices of K, then the warp sums its lanes (integer sums, so the
//   order does not matter). One lane per output dequantizes and adds the
//   input projection.
// - h_t goes to y[:, t], which the next step reads: y is the ping-pong
//   buffer, since each step reads only the row the last one wrote. Then a
//   grid barrier (cooperative groups).
//
// `wgmma` s8, TMA weight loads and a fused pair of layers are speed work for
// later; this is the simple form that is right.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CG = 4;        // gate columns of a dot task
constexpr int RB_MAX = 32;   // rows quantized into shared memory at a time
constexpr int KSTEP = 16;    // K is padded to whole 16-byte slices
constexpr float INT8_SCALE = 1.0f / 127.0f;

struct Args {
  const float* xp;      // (B, T, 4H) input projection plus both biases
  const int8_t* wq;     // (4H, H) int8
  const float* ws;      // (4H,) row scales of wq
  const float* h0;      // (B, H)
  const float* c0;      // (B, H)
  float* y;             // (B, T, H)
  float* hT;            // (B, H)
  float* cT;            // (B, H)
  int B, T, H, hs, Kp, RB;
};

struct Plan {
  int rt, hs, grid, Kp, RB;
  long long smem;
};

// Shared memory of a plan: the weight slice, then per row of a chunk its
// int8 h, float32 h, gates and projections and scale, then the weight
// scales and the cell state of every row.
__host__ __device__ constexpr long long smem_bytes(int NC, int Kp, int H, int RB, int B,
                                                   int hs) {
  return (long long)NC * Kp + (long long)RB * Kp +
         4LL * ((long long)RB * H + 2LL * RB * NC + RB + NC + (long long)B * hs);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

template <int RT>
__global__ void __launch_bounds__(THREADS, 1) lstm_int8_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, hs = a.hs, NC = 4 * hs, Kp = a.Kp, RB = a.RB, B = a.B, T = a.T;
  const int KV = Kp / KSTEP;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);         // NC rows of Kp
  int8_t* h_s = w_s + (size_t)NC * Kp;                   // RB rows of Kp
  float* hf_s = reinterpret_cast<float*>(h_s + (size_t)RB * Kp);  // RB rows of H
  float* g_s = hf_s + (size_t)RB * H;                   // RB x NC gates
  float* xp_s = g_s + RB * NC;                           // RB x NC projections
  float* sc_s = xp_s + RB * NC;                          // RB row absmaxes
  float* ws_s = sc_s + RB;                               // NC weight scales
  float* c_s = ws_s + NC;                                // B x hs cell state

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * hs;
  const int nu = min(hs, H - k0);  // units of this CTA (the last may own fewer)

  // Local column lc = gate * hs + unit; zero rows past the last unit and
  // zero bytes past H, so padded dots add nothing.
  for (int lc = warp; lc < NC; lc += WARPS) {
    const int g = lc / hs, u = lc - g * hs;
    const int8_t* src = a.wq + (size_t)(g * H + k0 + u) * H;
    for (int k = lane; k < Kp; k += 32)
      w_s[(size_t)lc * Kp + k] = (u < nu && k < H) ? src[k] : int8_t(0);
  }
  for (int lc = tid; lc < NC; lc += THREADS) {
    const int g = lc / hs, u = lc - g * hs;
    ws_s[lc] = u < nu ? a.ws[g * H + k0 + u] : 0.f;
  }
  for (int i = tid; i < B * hs; i += THREADS) {
    const int b = i / hs, u = i - b * hs;
    c_s[i] = u < nu ? a.c0[(size_t)b * H + k0 + u] : 0.f;
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const int ntask_c = NC / CG;
  for (int t = 0; t < T; ++t) {
    for (int r0 = 0; r0 < B; r0 += RB) {
      const int rows = min(RB, B - r0);
      const int rows_p = (rows + RT - 1) / RT * RT;
      // row b of h_{t-1}: h0, or the row of y the last step wrote
      auto hrow = [&](int b) {
        return t == 0 ? a.h0 + (size_t)b * H : a.y + ((size_t)b * T + (t - 1)) * H;
      };

      // 1. stage the chunk's rows of h_{t-1} in shared memory, every load
      //    in flight at once, and this step's projections of the CTA's columns
      const int H4 = H / 4;
#pragma unroll 4
      for (int i = tid; i < rows * H4; i += THREADS) {
        const int r = i / H4, k4 = i - r * H4;
        reinterpret_cast<float4*>(hf_s + (size_t)r * H)[k4] =
            __ldcg(reinterpret_cast<const float4*>(hrow(r0 + r)) + k4);
      }
      for (int i = tid; i < rows * NC; i += THREADS) {
        const int r = i / NC, lc = i - r * NC, g = lc / hs, u = lc - g * hs;
        xp_s[i] = u < nu ? __ldcg(a.xp + ((size_t)(r0 + r) * T + t) * 4 * H + g * H + k0 + u)
                         : 0.f;
      }
      if (tid < RB) sc_s[tid] = 0.f;
      __syncthreads();

      // 2. each row's absmax (non-negative floats order as their bits) ...
      for (int r = 0; r < rows; ++r) {
        float m = 0.f;
        for (int k = tid; k < H; k += THREADS) m = fmaxf(m, fabsf(hf_s[(size_t)r * H + k]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (lane == 0) atomicMax(reinterpret_cast<int*>(sc_s + r), __float_as_int(m));
      }
      __syncthreads();
      // ... then its scale, and h in int8 (pad rows and bytes zero)
      for (int i = tid; i < rows_p * Kp; i += THREADS) {
        const int r = i / Kp, k = i - r * Kp;
        float v = 0.f;
        if (r < rows && k < H) {
          const float s = __fmul_rn(fmaxf(sc_s[r], 1e-12f), INT8_SCALE);
          v = fminf(fmaxf(rintf(__fdiv_rn(hf_s[(size_t)r * H + k], s)), -127.f), 127.f);
        }
        h_s[i] = static_cast<int8_t>(static_cast<int>(v));
      }
      __syncthreads();

      // 3. the int8 dots of RT rows x CG columns a task, dequantized
      const int ntask = (rows_p / RT) * ntask_c;
      for (int task = warp; task < ntask; task += WARPS) {
        const int rt = task / ntask_c, cq = task - rt * ntask_c;
        const int4* wv = reinterpret_cast<const int4*>(w_s + (size_t)cq * CG * Kp);
        const int4* hv = reinterpret_cast<const int4*>(h_s + (size_t)rt * RT * Kp);
        int acc[RT][CG];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CG; ++c) acc[r][c] = 0;
        for (int v = lane; v < KV; v += 32) {
          int4 w[CG], h[RT];
#pragma unroll
          for (int c = 0; c < CG; ++c) w[c] = wv[c * KV + v];
#pragma unroll
          for (int r = 0; r < RT; ++r) h[r] = hv[r * KV + v];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < CG; ++c) {
              acc[r][c] = __dp4a(h[r].x, w[c].x, acc[r][c]);
              acc[r][c] = __dp4a(h[r].y, w[c].y, acc[r][c]);
              acc[r][c] = __dp4a(h[r].z, w[c].z, acc[r][c]);
              acc[r][c] = __dp4a(h[r].w, w[c].w, acc[r][c]);
            }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CG; ++c) {
            if (lane != r * CG + c) continue;
            const int row = rt * RT + r, lc = cq * CG + c;
            if (row < rows) {
              const float s = __fmul_rn(fmaxf(sc_s[row], 1e-12f), INT8_SCALE);
              const float rec = __fmul_rn(__int2float_rn(acc[r][c]), __fmul_rn(s, ws_s[lc]));
              g_s[row * NC + lc] = __fadd_rn(xp_s[row * NC + lc], rec);
            }
          }
      }
      __syncthreads();

      // 4. the cell of each (row, unit)
      for (int i = tid; i < rows * nu; i += THREADS) {
        const int r = i / nu, u = i - r * nu, b = r0 + r;
        const float* gr = g_s + r * NC;
        const float si = sigmoid(gr[u]), sf = sigmoid(gr[hs + u]);
        const float tg = tanhf(gr[2 * hs + u]), so = sigmoid(gr[3 * hs + u]);
        const float c = __fadd_rn(__fmul_rn(sf, c_s[b * hs + u]), __fmul_rn(si, tg));
        const float h = __fmul_rn(so, tanhf(c));
        c_s[b * hs + u] = c;
        a.y[((size_t)b * T + t) * H + k0 + u] = h;
        if (t == T - 1) {
          a.hT[(size_t)b * H + k0 + u] = h;
          a.cT[(size_t)b * H + k0 + u] = c;
        }
      }
      __syncthreads();  // the chunk's buffers are the next chunk's
    }
    if (t + 1 < T) grid.sync();  // y[:, t] complete before any CTA reads it
  }
}

// `n` grid barriers and nothing else, on the recurrence's grid: the serial
// floor of a layer is T of them.
__global__ void __launch_bounds__(THREADS, 1) lstm_barrier_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

cudaError_t make_plan(int B, int H, Plan* p) {
  if (B <= 0 || H <= 0 || H % 4) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  p->rt = B >= 3 ? 4 : B;
  p->hs = (H + sms - 1) / sms;
  p->grid = (H + p->hs - 1) / p->hs;
  p->Kp = (H + KSTEP - 1) / KSTEP * KSTEP;
  // as many rows a chunk as the batch needs, up to RB_MAX and to what
  // shared memory holds, in whole row tiles
  int rb = (B + p->rt - 1) / p->rt * p->rt;
  if (rb > RB_MAX) rb = RB_MAX;
  while (rb > p->rt && smem_bytes(4 * p->hs, p->Kp, H, rb, B, p->hs) > optin) rb -= p->rt;
  p->RB = rb;
  p->smem = smem_bytes(4 * p->hs, p->Kp, H, rb, B, p->hs);
  if (p->smem > optin) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Launch `fn` cooperatively on the plan's grid, after checking that the
// whole grid can be resident: a grid that cannot is an error, never a
// smaller launch.
cudaError_t launch_coop(const void* fn, const Plan& p, void** args, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, (size_t)p.smem);
  if (e != cudaSuccess) return e;
  if ((long long)per_sm * sms < p.grid) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(p.grid), dim3(THREADS), args, (size_t)p.smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The launch's shape for batch B and width H on the current device:
// out = {rows a task, units a CTA, CTAs, padded K, rows a chunk, shared
// bytes}. Returns a cudaError_t (0 = the shape fits).
extern "C" int facodec_lstm_int8_plan(int B, int H, long long* out) {
  Plan p;
  const cudaError_t e = make_plan(B, H, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.rt;
  out[1] = p.hs;
  out[2] = p.grid;
  out[3] = p.Kp;
  out[4] = p.RB;
  out[5] = p.smem;
  return 0;
}

// C entry point, bound with ctypes: one layer's recurrence over T steps on
// `stream`. Every tensor contiguous float32 but wq (int8); y, hT and cT are
// written whole; H % 4 == 0, and h0 and y 16-byte aligned (h's rows are
// read as float4s). Returns a cudaError_t (0 = launched).
extern "C" int facodec_lstm_int8(const float* xp, const int8_t* wq, const float* ws,
                                 const float* h0, const float* c0, float* y, float* hT,
                                 float* cT, int B, int T, int H, void* stream) {
  if (T <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(h0) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorMisalignedAddress;
  Plan p;
  cudaError_t e = make_plan(B, H, &p);
  if (e != cudaSuccess) return (int)e;
  Args a{xp, wq, ws, h0, c0, y, hT, cT, B, T, H, p.hs, p.Kp, p.RB};
  void* args[] = {&a};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.rt) {
    case 1: return (int)launch_coop((const void*)lstm_int8_kernel<1>, p, args, s);
    case 2: return (int)launch_coop((const void*)lstm_int8_kernel<2>, p, args, s);
    default: return (int)launch_coop((const void*)lstm_int8_kernel<4>, p, args, s);
  }
}

// `n` grid barriers on the grid facodec_lstm_int8 launches for (B, H), and
// with its shared memory: the time of one, by the step count, is the
// recurrence's serial floor.
extern "C" int facodec_lstm_int8_barriers(int B, int H, int n, void* stream) {
  Plan p;
  cudaError_t e = make_plan(B, H, &p);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&n};
  return (int)launch_coop((const void*)lstm_barrier_kernel, p, args,
                          static_cast<cudaStream_t>(stream));
}
