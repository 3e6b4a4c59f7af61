// The one-pass walk of a cross-based cost-aggregation (CBCA) round, shared
// by K2 (cbca_round.cu: f32 and bf16 storage, the bf16-operand flag), K7
// (cbca_stencil.cu: exact f32), K4 (cbca_round_int8.cu: int8 storage, 16
// lanes a block) and K8 (cbca_rolling.cu: the row-rolling round, D in
// multiples of one lane chunk); K9 (cbca_two_round.cu) chains two of its
// walks from the pieces below the kernel (request_row, h_walk, v_walk):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// What the TPU kernels are for: the horizontal sums never travel through
// device memory. The volume comes in once (plus its halo, out of L2), the
// sums live in shared memory and registers, the result goes out once; no
// scratch volume exists.
//
// What bounds a round on this card. Not its bytes (4 per element in bf16,
// 8 in f32): the sums. Every output needs up to 2 x 2r adds of values that
// its neighbours need too; a kernel that fetches each of them from shared
// memory (54 four-byte loads per element and round at r = 13) is bound by
// the shared-memory pipe at about 2.9 ms per round at 1000 x 1504 x 256,
// which is where the first ports of K2 (two passes), K7 (tiles) and K8 (one
// row at a time) sat; all three now run this walk. So the walk goes after
// shared-memory traffic first:
//
//   * Register windows. A thread owns two neighbouring lanes and walks along
//     a row (horizontal sums) or down a column (vertical sums). It keeps the
//     last 2R + 1 operands in registers and loads ONE new value per step.
//     Both walks are fully unrolled, so the window's shift is a renaming and
//     every register index is static (nothing spills to local memory); R is
//     a template parameter, 13 (the paper's distance 14 and anything below)
//     or 16 (the largest radius the wrappers take). About 5 shared-memory
//     accesses per element and round are left: the operand, the horizontal
//     sum written and read back, the arms.
//   * What then bounds the kernel is instruction slots: 2 x 2R predicated
//     f32 adds per element plus one compare per pixel and offset (the arms
//     are per pixel, the two lanes share each compare). They are executed
//     only where the data needs them: the offsets come in groups of four,
//     and a group that no pixel of the warp reaches in a given sum is
//     skipped by one uniform branch (the warp's longest arm per sum is one
//     redux.sync.max, taken for all of a walk's sums before its first add,
//     so no sum waits on a load or a vote). Natural images under the
//     paper's thresholds have short arms almost everywhere; a constant image
//     is the worst case.
//
// Layout of the work. A block of kThreads owns a (32-column strip, one
// 32-byte lane chunk: 16 bf16 or 8 f32 lanes, band of kBand rows: 256
// unless an instantiation says otherwise) and walks down the band in steps
// of kBatch rows, as the TPU's row-rolling kernel walks single rows, so
// horizontal sums are formed once per strip (1.1 x with a 256-row band's
// halo), not once per haloed tile. Per step j:
//
//   1. the next step's kBatch haloed raw rows ((32 + 2R) columns x 32 bytes)
//      and its arm / 1-over-region planes are requested with cp.async
//      (16-byte and 4-byte pieces; rows and columns outside the image are
//      zero-filled by the copy itself, so they add 0.0 exactly as the plain
//      round's zero padding does) into the other of two stages, and stay in
//      flight while this step is summed (two barriers per step: after the
//      copies have landed, and between H and V);
//   2. H: thread = (row, column segment, lane pair) sums its segment of the
//      row out of the staged raw rows into a ring of f32 horizontal sums
//      (bf16 storage stays bf16 in the raw stage: half the bytes, exact on
//      conversion; with round_operand an f32 value is rounded to bf16 as it
//      enters the window);
//   3. V: thread = (column, row segment, lane pair) walks down the ring for
//      the kBatch output rows whose last needed row (o + R) has just been
//      written -- kLag steps behind H -- multiplies by 1 / region
//      (__fmul_rn) and stores 32-byte sectors.
//
// Sums are f32 in the plain round's order (ops/cbca.py: centre, +1, -1, +2,
// -2, ...), so a round of K2, K7 or K8 equals the plain round, and one
// another, bit for bit in every mode, and so do two rounds and a pass of K9.
// Out of place (the wrappers alternate two buffers).
//
// Budget per block, one block per SM: the ring holds (kLag + 1) x kBatch
// rows of 33 pixels of f32 sums (33 x 32 B a row in f32, 33 x 64 B in
// bf16), the raw stages 2 x kBatch rows of (33 + 2R) x 32 B, the planes 2 x
// 5 x kBatch x 33 x 4 B; every row is padded by one pixel, which makes the 4-
// and 8-byte accesses of a warp (4 or 8 rows x 32 bytes) conflict-free.
// Registers: two windows of (2R + 1) x 2 floats, never live together, and a
// walk's arms. Grid: lane chunk fastest, so the blocks in flight cover whole
// pixel rows. Occupancy is one block per SM by shared memory: the loads are
// a whole step ahead, and the unrolled walks give each thread many
// independent add chains, so latency is hidden inside the block rather than
// across blocks.
#pragma once

#include "cbca_arms.cuh"

namespace {

constexpr int kTileW = 32;       // columns per strip
constexpr int kBandH = 256;      // output rows per block, by default
constexpr int kLpt = 2;          // lanes per thread
constexpr int kPixelBytes = 32;  // one sector of a pixel's D-row per block
constexpr int kPieceBytes = 16;  // per cp.async of volume data
constexpr int kPlanes = 5;       // left, right, up, down, 1 / region
constexpr int kSkip = 4;         // offsets per skippable group of adds

template <typename T, int R, int kThreads, int kBatch,
          int kLanesPerBlock = kPixelBytes / sizeof(T)>
struct Shape {
  static constexpr int kLanes = kLanesPerBlock;
  static constexpr int kGroups = kLanes / kLpt;  // lane pairs per pixel
  static constexpr int kCols = kTileW + 2 * R;   // raw columns per row
  // row strides, each padded by one pixel
  static constexpr int kRawStride = (kCols + 1) * kLanes;     // in T
  static constexpr int kRingStride = (kTileW + 1) * kLanes;   // in float
  static constexpr int kPlaneStride = kTileW + 1;             // in words
  static constexpr int kPlaneWords = kBatch * kPlaneStride;
  // V runs kLag steps behind H; the ring holds what lies between
  static constexpr int kLag = (2 * R + kBatch - 1) / kBatch;
  static constexpr int kRingRows = (kLag + 1) * kBatch;
  // H items: (row, column segment, lane pair); V: (column, row segment, ...)
  static constexpr int kHSegs = kThreads / (kBatch * kGroups);
  static constexpr int kHSteps = kTileW / kHSegs;
  static constexpr int kVSegs = kThreads / (kTileW * kGroups);
  static constexpr int kVSteps = kBatch / kVSegs;
  static constexpr size_t kRingBytes =
      sizeof(float) * kRingRows * kRingStride;
  static constexpr size_t kRawBytes = sizeof(T) * 2 * kBatch * kRawStride;
  static constexpr size_t kSharedBytes =
      kRingBytes + kRawBytes + sizeof(int) * 2 * kPlanes * kPlaneWords;
  static_assert(kTileW == 32 && kHSegs >= 1 && kVSegs >= 1 &&
                    kTileW % kHSegs == 0 && kBatch % kVSegs == 0,
                "the block's threads must tile both walks");
  static_assert(kRingBytes % 16 == 0 && kRawBytes % 16 == 0,
                "16-byte copies need aligned stages");
  static_assert(kSharedBytes <= mccnn::kMaxSharedBytes,
                "more shared memory than a block has");
};

using mccnn::copy_async_16;
using mccnn::copy_async_4;

// two neighbouring lanes as the round's f32 operands
__device__ __forceinline__ void load_pair(const float* p, bool rounded,
                                          float (&v)[kLpt]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = mccnn::as_operand(q.x, rounded);
  v[1] = mccnn::as_operand(q.y, rounded);
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, bool,
                                          float (&v)[kLpt]) {
  const float2 q =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
// int8 storage (K4): sums of at most 27 x 27 values of |q| <= 127 are exact
// integers in f32, so the walk's f32 order changes nothing; the store rounds
// half to even, as cbca_round_int8_plain does
__device__ __forceinline__ void load_pair(const signed char* p, bool,
                                          float (&v)[kLpt]) {
  const char2 q = *reinterpret_cast<const char2*>(p);
  v[0] = static_cast<float>(q.x);
  v[1] = static_cast<float>(q.y);
}
__device__ __forceinline__ void store_pair(signed char* p, float a, float b) {
  *reinterpret_cast<char2*>(p) =
      make_char2(static_cast<signed char>(static_cast<int>(rintf(a))),
                 static_cast<signed char>(static_cast<int>(rintf(b))));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The adds of offsets kFirst .. kFirst + kSkip - 1 of one sum, then the
// groups beyond them. `far` is the longest arm that any pixel of the warp
// has in this sum, so a group that no pixel reaches costs one uniform
// branch, and the groups beyond it nothing.
template <int R, int kFirst>
__device__ __forceinline__ void add_groups(
    const float (&win)[2 * R + 1][kLpt], float (&acc)[kLpt], int neg, int pos,
    unsigned far) {
  if constexpr (kFirst <= R) {
    if (far >= kFirst) {
#pragma unroll
      for (int o = kFirst; o < kFirst + kSkip && o <= R; ++o) {
        if (o <= pos) {
#pragma unroll
          for (int l = 0; l < kLpt; ++l) acc[l] += win[R + o][l];
        }
        if (o <= neg) {
#pragma unroll
          for (int l = 0; l < kLpt; ++l) acc[l] += win[R - o][l];
        }
      }
      add_groups<R, kFirst + kSkip>(win, acc, neg, pos, far);
    }
  }
}

// kSteps arm-gated sums along a line of operands, one new operand per sum.
// next(v) yields the line's operands in order, starting R before the first
// centre; arms(s, neg, pos) the two arm lengths of sum s; emit(s, acc) takes
// the sum. Fully unrolled: the shift is a renaming, every index is static.
// The arms are read and reduced over the warp before the first sum, so no
// sum waits on a load or a vote. Every thread of a warp must call it
// together.
template <int R, int kSteps, typename Next, typename Arms, typename Emit>
__device__ __forceinline__ void walk(Next next, Arms arms, Emit emit) {
  int negs[kSteps], poss[kSteps];
  unsigned far[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    arms(s, negs[s], poss[s]);
    far[s] = __reduce_max_sync(
        0xffffffffu, static_cast<unsigned>(max(negs[s], poss[s])));
  }
  float win[2 * R + 1][kLpt];
#pragma unroll
  for (int p = 0; p < 2 * R; ++p) next(win[p + 1]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < 2 * R; ++k) {
#pragma unroll
      for (int l = 0; l < kLpt; ++l) win[k][l] = win[k + 1][l];
    }
    next(win[2 * R]);
    float acc[kLpt];
#pragma unroll
    for (int l = 0; l < kLpt; ++l) acc[l] = win[R][l];
    add_groups<R, 1>(win, acc, negs[s], poss[s], far[s]);
    emit(s, acc);
  }
}

// The pieces of a round, shared by the kernels that walk (K2, K7, K4 and,
// two rounds chained, K9).

// One row of `kCols` pixels (kLanes lanes each) from image column x0 by
// 16-byte cp.async into `dst`, zero where the row (row_ok) or the column
// lies outside the image. Called by the 32 lanes of one warp.
template <typename T, int kLanes, int kCols>
__device__ __forceinline__ void request_row(const T* vol, T* dst, int y,
                                            bool row_ok, int x0, int width,
                                            int d_pad, int d0, int lane) {
  constexpr int kPieceLanes = kPieceBytes / sizeof(T);
  constexpr int kPieces = kLanes / kPieceLanes;  // per pixel
  static_assert(kPieces >= 1 && kLanes % kPieceLanes == 0,
                "a pixel's lanes are whole 16-byte pieces");
  const T* src_row =
      vol + static_cast<size_t>(row_ok ? y : 0) * width * d_pad + d0;
  for (int p = lane; p < kCols * kPieces; p += 32) {
    const int x = x0 + p / kPieces;
    const bool valid = row_ok && x >= 0 && x < width;
    const T* src = valid ? src_row + static_cast<size_t>(x) * d_pad +
                               (p % kPieces) * kPieceLanes
                         : vol;
    copy_async_16(dst + p * kPieceLanes, src, valid);
  }
}

// H: the horizontal sums of kSteps neighbouring pixels of one row into
// `sums`, lane pair by lane pair. `operand` is the window's first pixel
// (R before the first centre), `arm` the first pixel's left arm, its right
// arm `right` words further on.
template <typename T, int R, int kSteps, int kLanes>
__device__ __forceinline__ void h_walk(const T* operand, const int* arm,
                                       int right, float* sums, int radius,
                                       bool rounded) {
  walk<R, kSteps>(
      [&](float (&v)[kLpt]) {
        load_pair(operand, rounded, v);
        operand += kLanes;
      },
      [&](int s, int& neg, int& pos) {
        neg = min(arm[s], radius);
        pos = min(arm[right + s], radius);
      },
      [&](int s, const float (&acc)[kLpt]) {
        store_pair(sums + s * kLanes, acc[0], acc[1]);
      });
}

// V: the vertical sums of kSteps rows of one column down a ring of
// kRingRows rows of horizontal sums (row stride kRingStride floats),
// starting at ring row `slot` (R before the first centre). `arm` is the
// first row's up arm, its down arm `down` words further on, rows
// kPlaneStride words apart; emit(s, acc) takes the sum of row s.
template <int R, int kSteps, int kRingRows, int kRingStride,
          int kPlaneStride, typename Emit>
__device__ __forceinline__ void v_walk(const float* column, int slot,
                                       const int* arm, int down, int radius,
                                       Emit emit) {
  walk<R, kSteps>(
      [&](float (&v)[kLpt]) {
        load_pair(column + slot * kRingStride, false, v);
        slot = slot + 1 == kRingRows ? 0 : slot + 1;
      },
      [&](int s, int& neg, int& pos) {
        neg = min(arm[s * kPlaneStride], radius);
        pos = min(arm[down + s * kPlaneStride], radius);
      },
      emit);
}

template <typename T, int R, int kThreads, int kBatch, int kLanes,
          int kBand>
__global__ void __launch_bounds__(kThreads, 1)
cbca_walk_kernel(const T* __restrict__ vol, T* __restrict__ out,
                  const int* __restrict__ arm_left,
                  const int* __restrict__ arm_right,
                  const int* __restrict__ arm_up,
                  const int* __restrict__ arm_down,
                  const float* __restrict__ inv_region, int height, int width,
                  int d_pad, int radius, int round_operand) {
  using S = Shape<T, R, kThreads, kBatch, kLanes>;
  extern __shared__ __align__(16) unsigned char s_bytes[];
  float* s_ring = reinterpret_cast<float*>(s_bytes);
  T* s_raw = reinterpret_cast<T*>(s_bytes + S::kRingBytes);
  int* s_planes = reinterpret_cast<int*>(s_bytes + S::kRingBytes +
                                         S::kRawBytes);

  const int d0 = blockIdx.x * S::kLanes;
  const int w0 = blockIdx.y * kTileW;
  const int hb0 = blockIdx.z * kBand;
  const int hb1 = min(hb0 + kBand, height);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const bool rounded = round_operand != 0;
  const int y_base = hb0 - R;  // the image row at ring offset 0
  const int steps = (hb1 - hb0 + kBatch - 1) / kBatch + S::kLag;

  // request step j's raw rows and planes (H's arms for those rows, V's arms
  // and 1 / region for the output rows kLag steps behind)
  auto request = [&](int j) {
    const int stage = j & 1;
    T* raw = s_raw + stage * kBatch * S::kRawStride;
    const int y0 = y_base + j * kBatch;
    const int y_end = min(height, hb1 + R);
    int* planes = s_planes + stage * kPlanes * S::kPlaneWords;
    const int o0 = hb0 + (j - S::kLag) * kBatch;
    // a warp takes whole rows: no division, one row test per row
    for (int row = warp; row < kBatch; row += kThreads / 32) {
      const int y = y0 + row;
      request_row<T, S::kLanes, S::kCols>(vol, raw + row * S::kRawStride, y,
                                          y >= 0 && y < y_end, w0 - R, width,
                                          d_pad, d0, lane);
      // one pixel of the strip per lane
      const int x = w0 + lane;
      int* at = planes + row * S::kPlaneStride + lane;
      const bool valid_h = x < width && y >= 0 && y < height;
      const size_t pix_h = valid_h ? static_cast<size_t>(y) * width + x : 0;
      copy_async_4(at, arm_left + pix_h, valid_h);
      copy_async_4(at + S::kPlaneWords, arm_right + pix_h, valid_h);
      const int o = o0 + row;
      const bool valid_v = x < width && o >= hb0 && o < hb1;
      const size_t pix_v = valid_v ? static_cast<size_t>(o) * width + x : 0;
      copy_async_4(at + 2 * S::kPlaneWords, arm_up + pix_v, valid_v);
      copy_async_4(at + 3 * S::kPlaneWords, arm_down + pix_v, valid_v);
      copy_async_4(at + 4 * S::kPlaneWords, inv_region + pix_v, valid_v);
    }
  };

  // the thread's items: lane pair fastest, so a warp's accesses are runs of
  // a pixel's bytes in several rows (H) or one run of whole pixels (V)
  const int h_group = tid % S::kGroups;
  const int h_row = (tid / S::kGroups) % kBatch;
  const int h_col0 = (tid / (S::kGroups * kBatch)) * S::kHSteps;
  const int v_group = tid % S::kGroups;
  const int v_col = (tid / S::kGroups) % kTileW;
  const int v_row0 = (tid / (S::kGroups * kTileW)) * S::kVSteps;

  request(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = 0; j < steps; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // step j's copies have landed, and everyone is done with step j - 1: its
    // stage may be overwritten, and so may the ring rows its V started from
    __syncthreads();
    if (j + 1 < steps) {
      request(j + 1);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    const int stage = j & 1;
    const int* planes = s_planes + stage * kPlanes * S::kPlaneWords;
    // H: raw column c is image column w0 - R + c, so the window of output
    // column h_col0 + s starts at raw column h_col0 + s
    h_walk<T, R, S::kHSteps, S::kLanes>(
        s_raw + stage * kBatch * S::kRawStride + h_row * S::kRawStride +
            h_col0 * S::kLanes + h_group * kLpt,
        planes + h_row * S::kPlaneStride + h_col0, S::kPlaneWords,
        s_ring + ((j % (S::kLag + 1)) * kBatch + h_row) * S::kRingStride +
            h_col0 * S::kLanes + h_group * kLpt,
        radius, rounded);
    __syncthreads();

    if (j >= S::kLag) {
      // V: ring offset k is image row y_base + k, so the window of output
      // row o starts at offset o - hb0
      const int first = (j - S::kLag) * kBatch + v_row0;
      const int* arm = planes + 2 * S::kPlaneWords +
                       v_row0 * S::kPlaneStride + v_col;
      const int gw = w0 + v_col;
      // the thread's rows that lie in the band (none outside the image)
      const int rows = gw < width ? hb1 - (hb0 + first) : 0;
      T* target = out +
                  (static_cast<size_t>(hb0 + first) * width + gw) * d_pad +
                  d0 + v_group * kLpt;
      const size_t row_pitch = static_cast<size_t>(width) * d_pad;
      v_walk<R, S::kVSteps, S::kRingRows, S::kRingStride, S::kPlaneStride>(
          s_ring + v_col * S::kLanes + v_group * kLpt, first % S::kRingRows,
          arm, S::kPlaneWords, radius,
          [&](int s, const float (&acc)[kLpt]) {
            const float inv = __int_as_float(
                arm[2 * S::kPlaneWords + s * S::kPlaneStride]);
            const float a = __fmul_rn(acc[0], inv);
            const float b = __fmul_rn(acc[1], inv);
            if (s < rows) store_pair(target, a, b);
            target += row_pitch;
          });
    }
  }
}

template <typename T, int R, int kThreads, int kBatch,
          int kLanes = kPixelBytes / sizeof(T), int kBand = kBandH>
cudaError_t launch_walk(const void* vol_in, void* vol_out, const int* arm_l,
                        const int* arm_r, const int* arm_u, const int* arm_d,
                        const float* inv, int height, int width, int d_pad,
                        int radius, int round_operand, cudaStream_t s) {
  using S = Shape<T, R, kThreads, kBatch, kLanes>;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      cbca_walk_kernel<T, R, kThreads, kBatch, kLanes, kBand>,
      S::kSharedBytes, shared_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(d_pad / S::kLanes, (width + kTileW - 1) / kTileW,
                  (height + kBand - 1) / kBand);
  cbca_walk_kernel<T, R, kThreads, kBatch, kLanes, kBand>
      <<<grid, kThreads, S::kSharedBytes, s>>>(
      static_cast<const T*>(vol_in), static_cast<T*>(vol_out), arm_l, arm_r,
      arm_u, arm_d, inv, height, width, d_pad, radius, round_operand);
  return cudaGetLastError();
}

}  // namespace
