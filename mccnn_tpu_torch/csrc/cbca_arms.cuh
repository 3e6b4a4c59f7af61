// Arm-gated sums shared by the row-rolling CBCA kernels (K8 cbca_rolling.cu,
// K9 cbca_two_round.cu); K2 (cbca_round.cu) takes the halo and the operand
// rounding from here and keeps its sums in register windows of its own.
//
// Both sums add in the plain round's order (mccnn_tpu_torch/ops/cbca.py:
// centre, then +1, -1, +2, -2, ...) with plain f32 adds, so a kernel built
// from them equals the plain round, K2 and K7 bit for bit. Arms are clamped
// to the image by the callers; the loops stop at the longer of the two arms.
#pragma once

#include "common.cuh"

namespace mccnn {

constexpr int kArmHalo = 16;  // largest radius (distance - 1) supported

// A volume value as the round's operand: with round_operand the value is
// rounded to bf16 first (compute_dtype = bf16 on f32 storage; a no-op on
// bf16 storage), all sums stay f32.
__device__ __forceinline__ float as_operand(float v, bool round_operand) {
  return round_operand ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// sum of centre[o * stride] over o in [-neg, +pos]
__device__ __forceinline__ float arm_sum(const float* centre, int stride,
                                         int neg, int pos) {
  float acc = centre[0];
  const int reach = max(neg, pos);
  for (int o = 1; o <= reach; ++o) {
    if (o <= pos) acc += centre[o * stride];
    if (o <= neg) acc += centre[-o * stride];
  }
  return acc;
}

// The same sum down a ring of `slots` rows (row stride `stride` words): the
// centre row sits in slot `centre_slot`, row +o in slot centre_slot + o
// (mod slots). `column` points at this thread's element of slot 0.
__device__ __forceinline__ float ring_sum(const float* column, int stride,
                                          int slots, int centre_slot, int neg,
                                          int pos) {
  float acc = column[centre_slot * stride];
  const int reach = max(neg, pos);
  int below = centre_slot;  // row + o
  int above = centre_slot;  // row - o
  for (int o = 1; o <= reach; ++o) {
    below = below + 1 == slots ? 0 : below + 1;
    above = above == 0 ? slots - 1 : above - 1;
    if (o <= pos) acc += column[below * stride];
    if (o <= neg) acc += column[above * stride];
  }
  return acc;
}

// The two arm lengths of pixel `pix` along one axis, clamped to the radius
// and to the room the image leaves on either side.
__device__ __forceinline__ void load_arms(const int* __restrict__ neg_plane,
                                          const int* __restrict__ pos_plane,
                                          size_t pix, int radius, int room_neg,
                                          int room_pos, int& neg, int& pos) {
  neg = min(min(neg_plane[pix], radius), room_neg);
  pos = min(min(pos_plane[pix], radius), room_pos);
}

// Four lanes of one pixel from device memory as f32 (one 16- or 8-byte load)
__device__ __forceinline__ float4 load_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ... and as the round's operands
template <typename T>
__device__ __forceinline__ float4 load_operand_quad(const T* p,
                                                    bool round_operand) {
  float4 v = load_quad(p);
  v.x = as_operand(v.x, round_operand);
  v.y = as_operand(v.y, round_operand);
  v.z = as_operand(v.z, round_operand);
  v.w = as_operand(v.w, round_operand);
  return v;
}

}  // namespace mccnn
