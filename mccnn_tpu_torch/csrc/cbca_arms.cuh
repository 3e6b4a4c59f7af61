// What the CBCA round kernels share below their walk (cbca_walk.cuh: K2,
// K4, K7, K8 and, two walks chained, K9): the largest radius they take and
// the bf16-operand rounding. Their sums add in the plain round's order
// (mccnn_tpu_torch/ops/cbca.py: centre, then +1, -1, +2, -2, ...) with plain
// f32 adds, so each equals the plain round bit for bit.
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

}  // namespace mccnn
