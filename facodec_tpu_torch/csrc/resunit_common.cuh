// Helpers shared by the residual unit's sources, csrc/resunit.cu (float32
// and halo entries), csrc/resunit_bf16.cu (bf16 entry) and
// csrc/resunit_int8.cu (int8 unit): the snake activation with the plain
// version's rounding, the row index of the SConv1d-padded input, the shape
// checks of the C entry points, and the wgmma kernels' N tiles.
#pragma once

#include <cuda_runtime.h>

namespace {

// sin(x)^2 with its Cody-Waite reduction, written with __fmul_rn /
// __fadd_rn / __fsub_rn so that nvcc contracts none of it into FMAs and it
// gives the plain PyTorch version's bits.
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

// Row p of the padded input, as ops/padding.py `pad1d` pads: x zero-extended
// to ext rows (ext = T unless T <= the longer pad), reflected about its ends,
// pad_left rows in front. -1 stands for a zero row.
__device__ __forceinline__ int padded_row(int p, int T, int ext, int pad_left) {
  int q = p - pad_left;
  q = q < 0 ? -q : q;
  q = q >= ext ? 2 * (ext - 1) - q : q;
  return q < T ? q : -1;
}

bool valid_shape(int B, int T, int C, int dil) {
  return C > 0 && C % 32 == 0 && B > 0 && T > 0 && dil > 0;
}

// The wgmma kernels' N tiles (csrc/resunit_bf16.cu, csrc/resunit_int8.cu),
// of equal width: the fewest of at most 256 channels, each BN of
// 64, 96, 128, 192 or 256 wide (the last one ragged where BN does not divide C).
int pick_bn(int C, int* n_tiles) {
  *n_tiles = (C + 255) / 256;
  const int need = (C + *n_tiles - 1) / *n_tiles;
  constexpr int widths[4] = {64, 96, 128, 192};
  for (int bn : widths) {
    if (bn >= need) return bn;
  }
  return 256;
}

// The pads are (pad_left, 6d - pad_left); reflection needs ext > either.
bool valid_pads(int T, int dil, int pad_left, int ext) {
  return pad_left >= 0 && pad_left <= 6 * dil && ext >= T && ext > pad_left &&
         ext > 6 * dil - pad_left;
}

}  // namespace
