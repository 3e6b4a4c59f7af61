// K9: two cross-based cost-aggregation (CBCA) rounds in one pass.
//
// Replaces mccnn_tpu/ops/cbca_fused2.py::_two_round_kernel (cbca_fused_two;
// cbca_impl "fused2" and, with the bf16-operand flag on f32 storage,
// "fused2_16"). Round A is evaluated on the region the output strip's arms
// can reach and never leaves the chip; round B runs on it:
//
//   a[h, w, d]   = store(inv_region(h, w) * sum over the cross of vol)
//   out[h, w, d] = store(inv_region(h, w) * sum over the cross of a)
//
// where store rounds to the storage type, as an unfused round's write would:
// a pass equals two single rounds (K2) bit for bit. With the bf16-operand
// flag the intermediate stays f32 and is rounded to bf16 again as round B's
// operand, which is what two flagged K2 rounds do. What stays behind from
// the TPU kernel: the four 0/1-mask matmuls, the pre-shifted arm planes, the
// clamped window bases and their offset algebra, the DMA semaphores.
//
// Design: two of K2's walks (cbca_walk.cuh: request_row, h_walk, v_walk)
// chained in one block, which owns a 32-column strip of output, one lane
// chunk and a 256-row band. Walk A covers the 32 + 2 x 16 = 64 intermediate
// columns that round B's arms can reach (for R = 13 the last 6 are not
// read), from a raw stage of 64 + 2R columns; walk B covers the strip. Per
// step of kBatch rows, with two barriers as in K2:
//
//   1. the next step's raw rows and its four sets of planes (A's left and
//      right arms at the raw rows, A's up, down and 1 / region at the
//      intermediate rows it emits, B's left and right at the intermediate
//      rows it sums, B's up, down and 1 / region at its output rows) are
//      requested by cp.async into the other of two stages;
//   2. warps 0-7 run A's H walk on the raw stage into ring A; warps 8-11
//      run B's H walk on the intermediate stage (what A's V emitted one
//      step before) into ring B;
//   3. warps 0-7 run A's V walk down ring A (kLag steps behind its H) and
//      emit intermediate rows into the intermediate stage, rounded to the
//      storage type (exactly 0 outside the image); warps 8-11 run B's V
//      walk down ring B (kLag steps behind B's H) and store the output.
//
// Every thread runs one walk of 8 sums per phase (A has twice B's columns
// and twice its warps), so no warp idles as in the first K9, where 256 of
// 512 threads had no round-B work. K2's levers stay: register windows of
// 2R + 1 operands, fully unrolled; the arms of a walk reduced per warp
// before its first add; groups of four offsets that no pixel reaches
// skipped; the copies a whole step ahead; f32 sums in the plain round's
// order (centre, +1, -1, ...).
//
// Shape. Two rings of f32 sums do not fit beside the stages at K2's 16
// lanes and 16-row steps (ring A alone would be 48 x 65 x 64 B = 200 KB),
// so a block takes 8 lanes (16 bytes of bf16, 32 of f32, per pixel) and
// 8-row steps: V runs kLag = 4 steps behind H over 40-row rings. Shared
// memory, R = 13 / 16: ring A 40 x 65 x 32 B = 83,200; ring B 40 x 33 x
// 32 B = 42,240; raw 2 x 8 x (65 + 2R) x 16 B = 23,296 / 24,832 (f32 twice
// that); intermediate stage 8 x 65 x 16 B = 8,320 (f32 16,640); planes 2 x
// 5 x 8 x (65 + 33) x 4 B = 31,360: bf16 188,416 / 189,952, f32 220,032 /
// 223,104 of 232,448 bytes. A wider strip does not fit: S = 48 (80 A
// columns) would need 245,760 bytes in bf16 at R = 13.
//
// Bound: like K2, not bytes (one read and one write of the volume per two
// rounds) but the walks' latency, barriers and halo: round A runs on 64 /
// 32 = 2 x the strip's columns, and the raw stage re-reads (64 + 2R) / 32
// of the volume's columns through L2.
#include "cbca_walk.cuh"

namespace {

constexpr int kLanes2 = 8;    // lanes per block
constexpr int kBatch2 = 8;    // rows per step
constexpr int kSegCols = 8;   // columns a warp walks (H) or holds (V)
constexpr int kColsA = kTileW + 2 * mccnn::kArmHalo;  // 64
constexpr int kWarpsA = kColsA / kSegCols;            // 8
constexpr int kWarpsB = kTileW / kSegCols;            // 4
constexpr int kThreads2 = 32 * (kWarpsA + kWarpsB);   // 384

template <typename T, int R>
struct TwoShape {
  static constexpr int kGroups = kLanes2 / kLpt;  // lane pairs per pixel
  static constexpr int kRawCols = kColsA + 2 * R;
  // row strides, each padded by one pixel
  static constexpr int kRawStride = (kRawCols + 1) * kLanes2;    // in T
  static constexpr int kStageStride = (kColsA + 1) * kLanes2;    // in T
  static constexpr int kRingAStride = (kColsA + 1) * kLanes2;    // floats
  static constexpr int kRingBStride = (kTileW + 1) * kLanes2;    // floats
  static constexpr int kPlaneAStride = kColsA + 1;               // words
  static constexpr int kPlaneBStride = kTileW + 1;
  static constexpr int kPlaneAWords = kBatch2 * kPlaneAStride;
  static constexpr int kPlaneBWords = kBatch2 * kPlaneBStride;
  static constexpr int kStageWords = kPlanes * (kPlaneAWords + kPlaneBWords);
  static constexpr int kLag = (2 * R + kBatch2 - 1) / kBatch2;
  static constexpr int kRingRows = (kLag + 1) * kBatch2;
  static constexpr size_t kRingABytes =
      sizeof(float) * kRingRows * kRingAStride;
  static constexpr size_t kRingBBytes =
      sizeof(float) * kRingRows * kRingBStride;
  static constexpr size_t kRawBytes = sizeof(T) * 2 * kBatch2 * kRawStride;
  static constexpr size_t kStageBytes = sizeof(T) * kBatch2 * kStageStride;
  static constexpr size_t kSharedBytes = kRingABytes + kRingBBytes +
                                         kRawBytes + kStageBytes +
                                         sizeof(int) * 2 * kStageWords;
  static_assert(kGroups * kBatch2 == 32 && kGroups * kSegCols == 32,
                "a warp walks 8 rows (H) or 8 columns (V) of lane pairs");
  static_assert(kRingABytes % 16 == 0 && kRingBBytes % 16 == 0 &&
                    kRawBytes % 16 == 0 && kStageBytes % 16 == 0,
                "16-byte copies need aligned stages");
  static_assert(kSharedBytes <= mccnn::kMaxSharedBytes,
                "more shared memory than a block has");
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads2, 1)
cbca_two_round_kernel(const T* __restrict__ vol, T* __restrict__ out,
                      const int* __restrict__ arm_left,
                      const int* __restrict__ arm_right,
                      const int* __restrict__ arm_up,
                      const int* __restrict__ arm_down,
                      const float* __restrict__ inv_region, int height,
                      int width, int d_pad, int radius, int round_operand) {
  using S = TwoShape<T, R>;
  extern __shared__ __align__(16) unsigned char s_bytes[];
  float* s_ring_a = reinterpret_cast<float*>(s_bytes);
  float* s_ring_b = reinterpret_cast<float*>(s_bytes + S::kRingABytes);
  T* s_raw = reinterpret_cast<T*>(s_bytes + S::kRingABytes + S::kRingBBytes);
  T* s_stage = reinterpret_cast<T*>(s_bytes + S::kRingABytes +
                                    S::kRingBBytes + S::kRawBytes);
  int* s_planes = reinterpret_cast<int*>(
      s_bytes + S::kRingABytes + S::kRingBBytes + S::kRawBytes +
      S::kStageBytes);

  const int d0 = blockIdx.x * kLanes2;
  const int w0 = blockIdx.y * kTileW;
  const int hb0 = blockIdx.z * kBandH;
  const int hb1 = min(hb0 + kBandH, height);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool rounded = round_operand != 0;
  const bool in_a = warp < kWarpsA;  // round A's warps, then round B's
  // image column of A column 0 (and of stage column 0), of raw column 0
  const int xa0 = w0 - R;
  // image row of ring A's offset 0 and of ring B's (the first intermediate
  // row round B needs)
  const int ya0 = hb0 - 2 * R;
  const int yb0 = hb0 - R;
  // B sums the rows A emitted one step before: B's step jb = j - 1 - kLag
  const int steps = (hb1 - hb0 + kBatch2 - 1) / kBatch2 + 2 * S::kLag + 1;

  // step j's raw rows and planes; warps 0-7 one raw row and A's planes
  // each, warps 8-11 B's planes of two rows
  auto request = [&](int j) {
    const int stage = j & 1;
    int* planes = s_planes + stage * S::kStageWords;
    const int jb = j - 1 - S::kLag;
    if (in_a) {
      const int row = warp;
      const int y = ya0 + j * kBatch2 + row;
      request_row<T, kLanes2, S::kRawCols>(
          vol, s_raw + (stage * kBatch2 + row) * S::kRawStride, y,
          y >= 0 && y < min(height, hb1 + 2 * R), w0 - 2 * R, width, d_pad,
          d0, lane);
      const int o = yb0 + (j - S::kLag) * kBatch2 + row;  // A's V row
      for (int c = lane; c < kColsA; c += 32) {
        const int x = xa0 + c;
        int* at = planes + row * S::kPlaneAStride + c;
        const bool valid_h = x >= 0 && x < width && y >= 0 && y < height;
        const size_t pix_h =
            valid_h ? static_cast<size_t>(y) * width + x : 0;
        copy_async_4(at, arm_left + pix_h, valid_h);
        copy_async_4(at + S::kPlaneAWords, arm_right + pix_h, valid_h);
        const bool valid_v =
            x >= 0 && x < width && o >= yb0 && o >= 0 && o < height;
        const size_t pix_v =
            valid_v ? static_cast<size_t>(o) * width + x : 0;
        copy_async_4(at + 2 * S::kPlaneAWords, arm_up + pix_v, valid_v);
        copy_async_4(at + 3 * S::kPlaneAWords, arm_down + pix_v, valid_v);
        copy_async_4(at + 4 * S::kPlaneAWords, inv_region + pix_v, valid_v);
      }
    } else {
      int* planes_b = planes + kPlanes * S::kPlaneAWords;
      const int x = w0 + lane;
      for (int row = warp - kWarpsA; row < kBatch2; row += kWarpsB) {
        const int y = yb0 + jb * kBatch2 + row;           // B's H row
        const int o = hb0 + (jb - S::kLag) * kBatch2 + row;  // B's V row
        int* at = planes_b + row * S::kPlaneBStride + lane;
        const bool valid_h = x < width && y >= yb0 && y >= 0 && y < height;
        const size_t pix_h =
            valid_h ? static_cast<size_t>(y) * width + x : 0;
        copy_async_4(at, arm_left + pix_h, valid_h);
        copy_async_4(at + S::kPlaneBWords, arm_right + pix_h, valid_h);
        const bool valid_v = x < width && o >= hb0 && o < hb1;
        const size_t pix_v =
            valid_v ? static_cast<size_t>(o) * width + x : 0;
        copy_async_4(at + 2 * S::kPlaneBWords, arm_up + pix_v, valid_v);
        copy_async_4(at + 3 * S::kPlaneBWords, arm_down + pix_v, valid_v);
        copy_async_4(at + 4 * S::kPlaneBWords, inv_region + pix_v, valid_v);
      }
    }
  };

  // the thread's items, lane pair fastest: H (row, 8-column segment), V
  // (column); a warp of A or B takes segment / columns (warp - first) x 8
  const int group = lane % S::kGroups;
  const int h_row = lane / S::kGroups;
  const int seg0 = (in_a ? warp : warp - kWarpsA) * kSegCols;
  const int v_col = seg0 + lane / S::kGroups;

  request(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // step j's copies have landed, and everyone is done with step j - 1:
    // its stage, the ring rows its V walks started from and the
    // intermediate rows B's H read may all be overwritten
    __syncthreads();
    if (j + 1 < steps) {
      request(j + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    const int stage = j & 1;
    const int* planes_a = s_planes + stage * S::kStageWords;
    const int* planes_b = planes_a + kPlanes * S::kPlaneAWords;
    const int jb = j - 1 - S::kLag;
    if (in_a) {
      // A's H: raw column c is image column w0 - 2R + c, so the window of
      // A column a starts at raw column a
      h_walk<T, R, kSegCols, kLanes2>(
          s_raw + (stage * kBatch2 + h_row) * S::kRawStride +
              seg0 * kLanes2 + group * kLpt,
          planes_a + h_row * S::kPlaneAStride + seg0, S::kPlaneAWords,
          s_ring_a + ((j % (S::kLag + 1)) * kBatch2 + h_row) *
                         S::kRingAStride +
              seg0 * kLanes2 + group * kLpt,
          radius, rounded);
    } else if (jb >= 0) {
      // B's H: stage column c is image column w0 - R + c, so the window of
      // output column b starts at stage column b
      h_walk<T, R, kSegCols, kLanes2>(
          s_stage + h_row * S::kStageStride + seg0 * kLanes2 + group * kLpt,
          planes_b + h_row * S::kPlaneBStride + seg0, S::kPlaneBWords,
          s_ring_b + ((jb % (S::kLag + 1)) * kBatch2 + h_row) *
                         S::kRingBStride +
              seg0 * kLanes2 + group * kLpt,
          radius, rounded);
    }
    __syncthreads();

    if (in_a && j >= S::kLag) {
      // A's V: ring A offset k is image row ya0 + k; it emits intermediate
      // rows yb0 + first .. + kBatch2 - 1 into the stage
      const int first = (j - S::kLag) * kBatch2;
      const int* arm = planes_a + 2 * S::kPlaneAWords + v_col;
      const int x = xa0 + v_col;
      const bool col_ok = x >= 0 && x < width;
      T* target = s_stage + v_col * kLanes2 + group * kLpt;
      v_walk<R, kBatch2, S::kRingRows, S::kRingAStride, S::kPlaneAStride>(
          s_ring_a + v_col * kLanes2 + group * kLpt, first % S::kRingRows,
          arm, S::kPlaneAWords, radius,
          [&](int s, const float (&acc)[kLpt]) {
            const float inv = __int_as_float(
                arm[2 * S::kPlaneAWords + s * S::kPlaneAStride]);
            const int o = yb0 + first + s;
            // exactly 0 outside the image, as the plain round's padding
            const bool inside = col_ok && o >= 0 && o < height;
            store_pair(target + s * S::kStageStride,
                       inside ? __fmul_rn(acc[0], inv) : 0.f,
                       inside ? __fmul_rn(acc[1], inv) : 0.f);
          });
    } else if (!in_a && jb >= S::kLag) {
      // B's V: ring B offset k is image row yb0 + k, so the window of
      // output row o starts at offset o - hb0
      const int first = (jb - S::kLag) * kBatch2;
      const int* arm = planes_b + 2 * S::kPlaneBWords + v_col;
      const int gw = w0 + v_col;
      const int rows = gw < width ? hb1 - (hb0 + first) : 0;
      T* target = out +
                  (static_cast<size_t>(hb0 + first) * width + gw) * d_pad +
                  d0 + group * kLpt;
      const size_t row_pitch = static_cast<size_t>(width) * d_pad;
      v_walk<R, kBatch2, S::kRingRows, S::kRingBStride, S::kPlaneBStride>(
          s_ring_b + v_col * kLanes2 + group * kLpt, first % S::kRingRows,
          arm, S::kPlaneBWords, radius,
          [&](int s, const float (&acc)[kLpt]) {
            const float inv = __int_as_float(
                arm[2 * S::kPlaneBWords + s * S::kPlaneBStride]);
            const float a = __fmul_rn(acc[0], inv);
            const float b = __fmul_rn(acc[1], inv);
            if (s < rows) store_pair(target, a, b);
            target += row_pitch;
          });
    }
  }
}

template <typename T, int R>
cudaError_t launch(const void* vol_in, void* vol_out, const int* arm_l,
                   const int* arm_r, const int* arm_u, const int* arm_d,
                   const float* inv, int height, int width, int d_pad,
                   int radius, int round_operand, cudaStream_t s) {
  using S = TwoShape<T, R>;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      cbca_two_round_kernel<T, R>, S::kSharedBytes, shared_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(d_pad / kLanes2, (width + kTileW - 1) / kTileW,
                  (height + kBandH - 1) / kBandH);
  cbca_two_round_kernel<T, R><<<grid, kThreads2, S::kSharedBytes, s>>>(
      static_cast<const T*>(vol_in), static_cast<T*>(vol_out), arm_l, arm_r,
      arm_u, arm_d, inv, height, width, d_pad, radius, round_operand);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_radius(const void* vol_in, void* vol_out, const int* al,
                          const int* ar, const int* au, const int* ad,
                          const float* inv, int height, int width, int d_pad,
                          int radius, int round_operand, cudaStream_t s) {
  return radius <= 13
      ? launch<T, 13>(vol_in, vol_out, al, ar, au, ad, inv, height, width,
                      d_pad, radius, round_operand, s)
      : launch<T, mccnn::kArmHalo>(vol_in, vol_out, al, ar, au, ad, inv,
                                   height, width, d_pad, radius,
                                   round_operand, s);
}

}  // namespace

extern "C" int mccnn_cbca_two_rounds(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    int bf16, int round_operand, void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo || vol_in == vol_out ||
      d_pad % kLanes2 || reinterpret_cast<size_t>(vol_in) % kPieceBytes ||
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
