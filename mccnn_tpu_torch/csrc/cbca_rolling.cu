// K8: one cross-based cost-aggregation (CBCA) round, rows rolled down a
// column strip.
//
// Replaces mccnn_tpu/ops/cbca_rolling.py::_rolling_kernel
// (cbca_fused_rolling; cbca_impl "rolling" and, with the bf16-operand flag
// on f32 storage, "rolling16"):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// What the TPU kernel is for: its grid runs over column tiles only and rolls
// down the column, so every volume row is read once per strip and its
// horizontal sums are formed once, not once per haloed row tile. What stays
// behind: the 0/1-mask matmuls, the ring-frame vertical masks, the
// pair-block schedule and the DMA semaphores.
//
// Design. The first port rolled one row at a time and fetched every operand
// of every sum from shared memory, which held it at the shared-memory bound
// that cbca_walk.cuh computes (3.11 ms per bf16 round at 1000 x 1504 x
// 256). K8 is now its own instantiation of that walk, which rolls down a
// band of a 32-column strip kBatch rows a step with register windows; the
// walk's note says what bounds it. What K8 chooses for itself:
//
//   * bf16 storage: K2's shape, 256 threads and 16-row steps, V two steps
//     behind H over a 48-row ring; 16 lanes a block. Shared memory, R = 13
//     / 16: 182,912 / 189,056 of 232,448 bytes.
//   * f32 storage, with or without bf16 operands: K7's lever at R = 13, 512
//     threads and 32-row steps, V one step behind H over a 64-row ring
//     (230,656 bytes); at R = 16 the lever's stages do not fit and K2's
//     shape runs (138,368 bytes); 8 lanes a block.
//   * bands of 512 rows, where K2, K7, K4 and K9 take the walk's 256: half
//     the band halo's re-read rows ((512 + 2R) / 512 = 1.05 x) and half the
//     walk start-ups (kLag steps of H before V's first row), against half
//     the blocks (1,504 in bf16 at the main shape, 11.4 waves of one block
//     per SM). Timed in one call at 1000 x 1504 x 256 (NVIDIA H100 80GB
//     HBM3, 700 W; mccnn_tpu_torch/tools/time_walk_variants.py), 256 / 512
//     / whole-height bands: bf16 1.633 / 1.602 / 1.616 ms, f32 2.009 /
//     1.905 / 1.921, f32 with bf16 operands 2.176 / 2.060 / 2.079; with
//     every arm at the radius 2.608 / 2.612 / 2.563. K2's shape in f32
//     takes 2.322 / 2.205 / 2.225 (with bf16 operands 2.564 / 2.441 /
//     2.470), so the lever stays.
//   * D a multiple of the block's lane chunk (16 lanes in bf16, 8 in f32),
//     so narrow volumes run the kernel too (K2's entry takes whole 128-lane
//     chunks only).
//
// Sums run in the plain round's order with one __fmul_rn, so the round
// equals the plain round, K2 and K7 bit for bit in every mode. Out of place
// (the wrapper alternates two buffers).
#include "cbca_walk.cuh"

namespace {

constexpr int kThreads = 256;       // bf16, and f32 at R = 16: K2's shape
constexpr int kBatch = 16;
constexpr int kThreadsF32 = 512;    // f32 at R = 13: K7's lever
constexpr int kBatchF32 = 32;
constexpr int kBandRows = 512;      // output rows per block

template <typename T>
constexpr int kLanesOf = kPixelBytes / sizeof(T);

template <typename T, int R, int kBlock, int kStep>
cudaError_t launch(const void* vol_in, void* vol_out, const int* arm_l,
                   const int* arm_r, const int* arm_u, const int* arm_d,
                   const float* inv, int height, int width, int d_pad,
                   int radius, int round_operand, cudaStream_t s) {
  return launch_walk<T, R, kBlock, kStep, kLanesOf<T>, kBandRows>(
      vol_in, vol_out, arm_l, arm_r, arm_u, arm_d, inv, height, width, d_pad,
      radius, round_operand, s);
}

}  // namespace

extern "C" int mccnn_cbca_rolling_round(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    int bf16, int round_operand, void* stream) {
  const int lanes = bf16 ? kLanesOf<__nv_bfloat16> : kLanesOf<float>;
  if (radius < 0 || radius > mccnn::kArmHalo || d_pad % lanes ||
      vol_in == vol_out ||
      reinterpret_cast<size_t>(vol_in) % kPieceBytes ||
      (width + kTileW - 1) / kTileW > 65535 ||
      (height + kBandRows - 1) / kBandRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* al = static_cast<const int*>(arm_left);
  const int* ar = static_cast<const int*>(arm_right);
  const int* au = static_cast<const int*>(arm_up);
  const int* ad = static_cast<const int*>(arm_down);
  const float* inv = static_cast<const float*>(inv_region);
  constexpr int kBig = mccnn::kArmHalo;
  cudaError_t err;
  if (bf16) {
    err = radius <= 13
        ? launch<__nv_bfloat16, 13, kThreads, kBatch>(
              vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
              radius, round_operand, s)
        : launch<__nv_bfloat16, kBig, kThreads, kBatch>(
              vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
              radius, round_operand, s);
  } else {
    err = radius <= 13
        ? launch<float, 13, kThreadsF32, kBatchF32>(
              vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
              radius, round_operand, s)
        : launch<float, kBig, kThreads, kBatch>(
              vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
              radius, round_operand, s);
  }
  return static_cast<int>(err);
}
