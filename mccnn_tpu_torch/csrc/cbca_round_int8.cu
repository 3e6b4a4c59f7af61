// K4: one cross-based cost-aggregation (CBCA) round on int8 storage.
//
// Replaces mccnn_tpu/ops/cbca_fused.py::_round_kernel with
// int8_storage=True (cbca_fused(..., int8_storage=True), the "fused8" mode):
//
//   sum[h, w, d] = i32 sum of the i8 volume over the cross of (h, w)
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
// Design. A single pass, K7's scheme (cbca_stencil.cu) on packed bytes: one
// block per (16-row, 32-column, 32-lane) output tile, 256 threads; thread =
// (column, word), a word being 4 neighbouring disparities of one pixel, so
// a pixel's 32 lanes are one 32-byte sector. The haloed window streams
// through shared memory 8 rows at a time as 32-bit words; the horizontal
// sums (at most 27 x 127, so i16) of the tile's 16 + 2r rows stay in shared
// memory as short4 per word (15 + 86 KB with r = 13, two blocks per SM);
// the vertical sums run in i32 registers. A thread's arm lengths bound its
// loops, so they are requested 8 rows at a time, ahead of the window loads,
// to keep their latency off every row's critical path. Loads outside the
// image are predicated to 0 and never summed (arms are border-capped). The
// round reads neighbours, so it runs out of place.
//
// Bound: bytes on paper, 2 B per volume element per round (0.77 GB at
// 1000 x 1504 x 256); in practice the up to 54 shared-memory reads and
// integer adds per word. As in K7 the lane chunk is the fastest-varying
// block index, so that the blocks in flight cover whole pixel rows. dp4a
// on a 0/1 arm mask is the later work.
#include "common.cuh"

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kWords = 8;                    // 32 int8 lanes per block
constexpr int kThreads = kTileW * kWords;    // 256
constexpr int kBatch = 8;                    // window rows staged at a time
constexpr int kHalo = 16;                    // largest radius supported
static_assert(kTileH % kBatch == 0, "the vertical phase walks whole batches");

__device__ __forceinline__ void add_word(int4& acc, unsigned word) {
  acc.x += static_cast<signed char>(word & 0xffu);
  acc.y += static_cast<signed char>((word >> 8) & 0xffu);
  acc.z += static_cast<signed char>((word >> 16) & 0xffu);
  acc.w += static_cast<signed char>(word >> 24);
}

__device__ __forceinline__ void add_sums(int4& acc, short4 s) {
  acc.x += s.x;
  acc.y += s.y;
  acc.z += s.z;
  acc.w += s.w;
}

__device__ __forceinline__ unsigned average_byte(int sum, float inv) {
  const float mean = __fmul_rn(static_cast<float>(sum), inv);
  const int q = static_cast<int>(rintf(mean));
  return static_cast<unsigned>(q) & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
cbca_round_int8_kernel(const unsigned* __restrict__ vol,
                       unsigned* __restrict__ out,
                       const int* __restrict__ arm_left,
                       const int* __restrict__ arm_right,
                       const int* __restrict__ arm_up,
                       const int* __restrict__ arm_down,
                       const float* __restrict__ inv_region, int height,
                       int width, int d_words, int radius) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int win_cols = kTileW + 2 * radius;
  const int sum_rows = kTileH + 2 * radius;
  short4* s_sum = reinterpret_cast<short4*>(s_raw);        // [rows][32][8]
  unsigned* s_win = reinterpret_cast<unsigned*>(
      s_raw + static_cast<size_t>(sum_rows) * kTileW * kWords * sizeof(short4));
                                                           // [kBatch][cols][8]

  // the lane chunk varies fastest over the grid, so the blocks that run
  // together cover whole (H, W, D) pixel rows of few spatial tiles
  const int word0 = blockIdx.x * kWords;
  const int w0 = blockIdx.y * kTileW;
  const int h0 = blockIdx.z * kTileH;
  const int tid = threadIdx.x;
  const int word = tid % kWords;
  const int col = tid / kWords;
  const int gw = w0 + col;

  // ---- horizontal sums of rows h0 - r .. h0 + 15 + r, a batch at a time
  for (int y0 = 0; y0 < sum_rows; y0 += kBatch) {
    // this thread's arms for the batch's rows, all requested before the
    // window loads so that their latency is paid once per batch (-1: the
    // row or column lies outside the image)
    int left[kBatch], right[kBatch];
#pragma unroll
    for (int y = 0; y < kBatch; ++y) {
      const int gh = h0 - radius + y0 + y;
      const bool live =
          y0 + y < sum_rows && gh >= 0 && gh < height && gw < width;
      const size_t pix = live ? static_cast<size_t>(gh) * width + gw : 0;
      left[y] = live ? arm_left[pix] : -1;
      right[y] = live ? arm_right[pix] : -1;
    }
    const int words = kBatch * win_cols * kWords;
    for (int e = tid; e < words; e += kThreads) {
      const int q = e % kWords;
      const int x = (e / kWords) % win_cols;
      const int y = e / (kWords * win_cols);
      const int gh = h0 - radius + y0 + y;
      const int gx = w0 - radius + x;
      unsigned v = 0u;
      if (y0 + y < sum_rows && gh >= 0 && gh < height && gx >= 0 &&
          gx < width) {
        v = vol[(static_cast<size_t>(gh) * width + gx) * d_words + word0 + q];
      }
      s_win[e] = v;
    }
    __syncthreads();
#pragma unroll
    for (int y = 0; y < kBatch; ++y) {
      if (y0 + y >= sum_rows) break;
      int4 acc = make_int4(0, 0, 0, 0);
      if (left[y] >= 0) {
        const unsigned* centre =
            s_win + (y * win_cols + col + radius) * kWords + word;
        add_word(acc, centre[0]);
        const int reach = min(max(left[y], right[y]), radius);
        for (int o = 1; o <= reach; ++o) {
          // arms are border-capped; the bounds tests are a second guard
          if (o <= right[y] && gw + o < width) {
            add_word(acc, centre[o * kWords]);
          }
          if (o <= left[y] && gw - o >= 0) add_word(acc, centre[-o * kWords]);
        }
      }
      s_sum[((y0 + y) * kTileW + col) * kWords + word] =
          make_short4(static_cast<short>(acc.x), static_cast<short>(acc.y),
                      static_cast<short>(acc.z), static_cast<short>(acc.w));
    }
    __syncthreads();
  }

  // ---- vertical sums over the horizontal sums, average, round, store; the
  // arms and 1 / region of kBatch rows are requested together
  if (gw >= width) return;
  for (int hc = 0; hc < kTileH; hc += kBatch) {
    int up[kBatch], down[kBatch];
    float inv[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int gh = h0 + hc + i;
      const bool live = gh < height;
      const size_t pix = live ? static_cast<size_t>(gh) * width + gw : 0;
      up[i] = live ? arm_up[pix] : -1;
      down[i] = live ? arm_down[pix] : -1;
      inv[i] = live ? inv_region[pix] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (up[i] < 0) break;
      const int hl = hc + i;
      const int gh = h0 + hl;
      const short4* centre =
          s_sum + ((hl + radius) * kTileW + col) * kWords + word;
      int4 acc = make_int4(0, 0, 0, 0);
      add_sums(acc, centre[0]);
      const int reach = min(max(up[i], down[i]), radius);
      for (int o = 1; o <= reach; ++o) {
        if (o <= down[i] && gh + o < height) {
          add_sums(acc, centre[o * kTileW * kWords]);
        }
        if (o <= up[i] && gh - o >= 0) {
          add_sums(acc, centre[-o * kTileW * kWords]);
        }
      }
      out[(static_cast<size_t>(gh) * width + gw) * d_words + word0 + word] =
          average_byte(acc.x, inv[i]) | (average_byte(acc.y, inv[i]) << 8) |
          (average_byte(acc.z, inv[i]) << 16) |
          (average_byte(acc.w, inv[i]) << 24);
    }
  }
}

}  // namespace

extern "C" int mccnn_cbca_round_int8(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    void* stream) {
  constexpr int kLanes = 4 * kWords;
  if (radius < 0 || radius > kHalo || d_pad % kLanes ||
      (width + kTileW - 1) / kTileW > 65535 ||
      (height + kTileH - 1) / kTileH > 65535 || vol_in == vol_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      static_cast<size_t>(kTileH + 2 * radius) * kTileW * kWords *
          sizeof(short4) +
      static_cast<size_t>(kBatch) * (kTileW + 2 * radius) * kWords *
          sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_round_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d_pad / kLanes, (width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH);
  cbca_round_int8_kernel<<<grid, kThreads, shared,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(vol_in), static_cast<unsigned*>(vol_out),
      static_cast<const int*>(arm_left), static_cast<const int*>(arm_right),
      static_cast<const int*>(arm_up), static_cast<const int*>(arm_down),
      static_cast<const float*>(inv_region), height, width, d_pad / 4, radius);
  return static_cast<int>(cudaGetLastError());
}
