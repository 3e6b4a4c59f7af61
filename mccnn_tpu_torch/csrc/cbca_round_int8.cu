// K4: one cross-based cost-aggregation (CBCA) round on int8 storage.
//
// Replaces mccnn_tpu/ops/cbca_fused.py::_round_kernel with
// int8_storage=True (cbca_fused(..., int8_storage=True), the "fused8" mode):
//
//   sum[h, w, d] = sum of the i8 volume over the cross of (h, w)
//                  (horizontal arm sums, then their sum along the vertical arm)
//   out[h, w, d] = i8(round_half_even(f32(sum) * inv_region(h, w)))
//
// Exact integer math: a cross holds at most 27 x 27 values of |q| <= 127, so
// every sum is below 2^24 and exact in f32 in any order; the one f32
// multiply (__fmul_rn) and rintf (round half to even) are what
// cbca_int8_plain does, so the round equals it bit for bit. BIG_COST lanes
// hold 127 and stay 127 only because whole lanes average among themselves:
// nothing here treats 127 specially.
//
// Design: K2's one-pass walk (cbca_walk.cuh) with an int8 raw stage. The raw
// rows are staged as bytes by 16-byte cp.async and converted to f32 as they
// enter the register window; the ring of horizontal sums, the arm-gated
// unrolled walks and the skipped groups of offsets are K2's; the only int8
// code is the load of a lane pair and the rounding store (cbca_walk.cuh).
// Lanes per block: 16, one 16-byte piece per pixel. The walk's default, a
// 32-byte sector, would be 32 int8 lanes and a ring of 48 x 33 x 32 x 4 B =
// 203 KB, which leaves no room for the stages; 16 lanes keep K2's bf16 ring
// (its sums per pixel are the same 64 bytes) and its thread layout (8 lane
// pairs per pixel) and halve the raw stage: 256 threads, 16-row steps, V two
// steps behind H over a 48-row ring. Shared memory, R = 13 / 16: ring 48 x
// 33 x 64 B = 101,376; raw 2 x 16 x (33 + 2R) x 16 B = 30,208 / 33,280;
// planes 2 x 5 x 16 x 33 x 4 B = 21,120; 152,704 / 155,776 of 232,448
// bytes. The wrapper keeps D a multiple of 32; a 128-lane chunk is 8 blocks
// across.
//
// Bound: bytes on paper, 2 B per volume element per round; like K2, in
// practice the walk's latency and barriers, not its sums. The round reads
// neighbours, so it runs out of place.
#include "cbca_walk.cuh"

namespace {

constexpr int kThreads = 256;  // per block
constexpr int kBatch = 16;     // rows per step
constexpr int kLanes = 16;     // int8 lanes per block: one 16-byte piece

}  // namespace

extern "C" int mccnn_cbca_round_int8(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo || d_pad % kLanes ||
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
      radius <= 13
          ? launch_walk<signed char, 13, kThreads, kBatch, kLanes>(
                vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
                radius, 0, s)
          : launch_walk<signed char, mccnn::kArmHalo, kThreads, kBatch,
                        kLanes>(vol_in, vol_out, al, ar, au, ad, inv, height,
                                width, d_pad, radius, 0, s));
}
