// K7: one cross-based cost-aggregation (CBCA) round, exact f32, one pass.
//
// Replaces mccnn_tpu/ops/cbca_pallas.py::_iteration_kernel (cbca_pallas):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// keeping, as the TPU kernel does, the horizontal sums on the chip. Its
// first port tiled the image in 32 x 32 x 8-lane blocks, whose 58 x 58
// haloed windows re-read the volume 3.3 x through L2 and whose sums fetched
// every operand from shared memory. It now runs the rolled walk of
// cbca_walk.cuh, which K2 shares: a 256-row band of a 32-column strip, one
// 32-byte sector (8 f32 lanes) per pixel, raw rows through two cp.async
// stages, a ring of f32 horizontal sums, fully unrolled register windows,
// the warp's longest arm per sum by one redux.sync.max and groups of four
// offsets that no pixel of the warp reaches skipped. It sums in the plain
// round's order (centre, +1, -1, +2, -2, ...; horizontal before vertical;
// one __fmul_rn), so it equals the plain round, K2 in f32, K8 and two
// rounds of K9 bit for bit.
//
// K7 is f32 only. In f32 a block's lane chunk is 8 lanes, half of bf16's,
// so K2's shape (256 threads, 16-row steps) pays twice the steps, barriers
// and walk start-ups per element, with 8 warps per SM to hide them. K7
// takes blocks of 512 threads (the compiler then keeps each under 128
// registers: 124, nothing spilled) and steps of 32 rows: V runs one step
// behind H over a 64-row ring, each thread walks as far as in K2, half the
// barriers per row, twice the warps; chip_smoke.py times it beside K2's
// shape in f32, which is K7 without this lever. At R = 13 the block's
// shared memory is ring 64 x 33 x 32 B = 67,584, raw 2 x 32 x
// 59 x 32 B = 120,832 and planes 2 x 5 x 32 x 33 x 4 B = 42,240: 230,656
// of 232,448 bytes. R = 16 does not fit so and runs K2's shape.
#include "cbca_walk.cuh"

namespace {

constexpr int kThreads = 512;     // per block, R = 13
constexpr int kBatch = 32;        // rows per step, R = 13
constexpr int kThreadsAt16 = 256;  // R = 16: K2's shape
constexpr int kBatchAt16 = 16;

}  // namespace

extern "C" int mccnn_cbca_stencil_round(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo ||
      d_pad % Shape<float, 13, kThreads, kBatch>::kLanes ||
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
          ? launch_walk<float, 13, kThreads, kBatch>(
                vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
                radius, 0, s)
          : launch_walk<float, mccnn::kArmHalo, kThreadsAt16, kBatchAt16>(
                vol_in, vol_out, al, ar, au, ad, inv, height, width, d_pad,
                radius, 0, s));
}
