// K2: one cross-based cost-aggregation (CBCA) round, one pass.
//
// Replaces mccnn_tpu/ops/cbca_fused.py::_round_kernel (cbca_fused, the f32
// and bf16 storage modes and the bf16-operand flag on f32 storage). What
// the TPU kernel keeps out of device memory and what of it stays behind
// (the 0/1-mask matmuls, the d-split layouts, the sequential grid), the
// design and what bounds it: cbca_walk.cuh, which K7 (cbca_stencil.cu)
// shares.
//
// K2 runs the walk with blocks of 256 threads and 16-row steps: V runs two
// steps behind H over a 48-row ring. Shared memory, bf16, R = 13 / 16: ring
// 48 x 33 x 64 B = 101,376; raw 2 x 16 x (33 + 2R) x 32 B = 60,416 /
// 66,560; planes 2 x 5 x 16 x 33 x 4 B = 21,120; 182,912 / 189,056 of
// 232,448 bytes. f32: ring 50,688, the rest the same. Registers: 128-153 a
// thread as built, nothing spilled (a 256-thread block may use 255). Grid:
// 16 x 47 x 4 = 3,008 blocks at the main shape in bf16.
#include "cbca_walk.cuh"

namespace {

constexpr int kThreads = 256;  // per block
constexpr int kBatch = 16;     // rows per step

template <typename T>
cudaError_t launch_radius(const void* vol_in, void* vol_out, const int* arm_l,
                          const int* arm_r, const int* arm_u,
                          const int* arm_d, const float* inv, int height,
                          int width, int d_pad, int radius,
                          int round_operand, cudaStream_t s) {
  return radius <= 13
      ? launch_walk<T, 13, kThreads, kBatch>(
            vol_in, vol_out, arm_l, arm_r, arm_u, arm_d, inv, height, width,
            d_pad, radius, round_operand, s)
      : launch_walk<T, mccnn::kArmHalo, kThreads, kBatch>(
            vol_in, vol_out, arm_l, arm_r, arm_u, arm_d, inv, height, width,
            d_pad, radius, round_operand, s);
}

}  // namespace

extern "C" int mccnn_cbca_round(const void* vol_in, void* vol_out,
                                const void* arm_left, const void* arm_right,
                                const void* arm_up, const void* arm_down,
                                const void* inv_region, int height, int width,
                                int d_pad, int radius, int bf16,
                                int round_operand, void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo || d_pad % 128 ||
      vol_in == vol_out ||
      reinterpret_cast<size_t>(vol_in) % kPieceBytes ||
      (width + kTileW - 1) / kTileW > 65535 ||
      (height + kBandH - 1) / kBandH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* al = static_cast<const int*>(arm_left);
  const int* ar = static_cast<const int*>(arm_right);
  const int* au = static_cast<const int*>(arm_up);
  const int* ad = static_cast<const int*>(arm_down);
  const float* inv = static_cast<const float*>(inv_region);
  return static_cast<int>(
      bf16 ? launch_radius<__nv_bfloat16>(vol_in, vol_out, al, ar, au, ad,
                                          inv, height, width, d_pad, radius,
                                          round_operand, s)
           : launch_radius<float>(vol_in, vol_out, al, ar, au, ad, inv,
                                  height, width, d_pad, radius,
                                  round_operand, s));
}
