// K7: one cross-based cost-aggregation (CBCA) round, exact f32, single pass.
//
// Replaces mccnn_tpu/ops/cbca_pallas.py::_iteration_kernel (cbca_pallas):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// The horizontal sums never leave the chip: that is what separates it from
// K2 (cbca_round.cu), which passes them through an f32 scratch volume.
//
// Design. One block per (32-row, 32-column, 8-lane) output tile, 256
// threads: thread = (column, lane), so a warp covers 4 neighbouring pixels x
// 8 lanes = 32 consecutive shared-memory words (no bank conflicts) and every
// pixel's 8 lanes are one full 32-byte sector of the (H, W, D) volume. The
// tile needs the horizontal sums of its 32 + 2r rows. With r = 13 the raw
// haloed window (58 x 58 x 8 lanes) plus those sums would take 167 KB, one
// block per SM; so the window streams through shared memory 8 rows at a
// time (float4 loads) and only the sums stay: 15 + 59 KB, three blocks per
// SM. Then each thread walks its column's 32 rows over the sums, scales by
// 1 / region and stores. A thread's arm lengths bound its loops, so their
// loads would sit on the critical path of every row: they are requested 8
// rows at a time, ahead of the window loads. Sums are taken in the plain
// round's order (mccnn_tpu_torch/ops/cbca.py: centre, then +1, -1, +2, -2,
// ...; horizontal before vertical; one multiply) with plain f32 adds and
// __fmul_rn, so the round equals the plain round, and K2 in f32, bit for
// bit. The loops stop
// at the longer of the pixel's two arms: offsets beyond add nothing.
// Border-capped arms never reach outside the image, so there is no padded
// copy of the volume; loads outside it are predicated to 0 and never summed.
// The round reads neighbours, so it runs out of place (the wrapper
// ping-pongs two buffers).
//
// Bound: bytes. 8 B per volume element per round (one f32 read, one f32
// write; 3.08 GB at 1000 x 1504 x 256). A block touches one 32-byte sector
// of each pixel's D-row, so the lane chunk is the fastest-varying block
// index: the blocks in flight then cover whole pixel rows of a few tiles
// and device memory sees full lines (with the chunk slowest, each pass over
// the image read 32 bytes every 1 KB). The 58 x 58 window of a 32 x 32 tile
// still re-reads 3.3 x the volume through L2; rolling the rows instead of
// tiling them would cut that to 1.8 x and is later work.
#include "common.cuh"

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kLanes = 8;                    // disparities per block
constexpr int kThreads = kTileW * kLanes;    // 256
constexpr int kBatch = 8;                    // window rows staged at a time
constexpr int kHalo = 16;                    // largest radius supported
static_assert(kTileH % kBatch == 0, "the vertical phase walks whole batches");

__global__ void __launch_bounds__(kThreads)
cbca_stencil_kernel(const float* __restrict__ vol, float* __restrict__ out,
                    const int* __restrict__ arm_left,
                    const int* __restrict__ arm_right,
                    const int* __restrict__ arm_up,
                    const int* __restrict__ arm_down,
                    const float* __restrict__ inv_region, int height,
                    int width, int d_pad, int radius) {
  extern __shared__ __align__(16) float s_mem[];
  const int win_cols = kTileW + 2 * radius;
  const int sum_rows = kTileH + 2 * radius;
  float* s_win = s_mem;                                   // [kBatch][cols][8]
  float* s_sum = s_mem + kBatch * win_cols * kLanes;      // [rows][32][8]

  // the lane chunk varies fastest over the grid, so the blocks that run
  // together cover whole (H, W, D) pixel rows of few spatial tiles
  const int d0 = blockIdx.x * kLanes;
  const int w0 = blockIdx.y * kTileW;
  const int h0 = blockIdx.z * kTileH;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int col = tid / kLanes;
  const int gw = w0 + col;

  // ---- horizontal sums of rows h0 - r .. h0 + 31 + r, a batch at a time
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
    const int quads = kBatch * win_cols * (kLanes / 4);
    for (int e = tid; e < quads; e += kThreads) {
      const int q = e % (kLanes / 4);
      const int x = (e / (kLanes / 4)) % win_cols;
      const int y = e / ((kLanes / 4) * win_cols);
      const int gh = h0 - radius + y0 + y;
      const int gx = w0 - radius + x;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y0 + y < sum_rows && gh >= 0 && gh < height && gx >= 0 &&
          gx < width) {
        v = *reinterpret_cast<const float4*>(
            vol + (static_cast<size_t>(gh) * width + gx) * d_pad + d0 + 4 * q);
      }
      *reinterpret_cast<float4*>(s_win + (y * win_cols + x) * kLanes + 4 * q) =
          v;
    }
    __syncthreads();
#pragma unroll
    for (int y = 0; y < kBatch; ++y) {
      if (y0 + y >= sum_rows) break;
      float acc = 0.f;
      if (left[y] >= 0) {
        const float* centre =
            s_win + (y * win_cols + col + radius) * kLanes + lane;
        acc = centre[0];
        const int reach = min(max(left[y], right[y]), radius);
        for (int o = 1; o <= reach; ++o) {
          // arms are border-capped; the bounds tests are a second guard
          if (o <= right[y] && gw + o < width) acc += centre[o * kLanes];
          if (o <= left[y] && gw - o >= 0) acc += centre[-o * kLanes];
        }
      }
      s_sum[((y0 + y) * kTileW + col) * kLanes + lane] = acc;
    }
    __syncthreads();
  }

  // ---- vertical sums over the horizontal sums, scale, store; the arms
  // and 1 / region of kBatch rows are requested together
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
      const float* centre =
          s_sum + ((hl + radius) * kTileW + col) * kLanes + lane;
      float acc = centre[0];
      const int reach = min(max(up[i], down[i]), radius);
      for (int o = 1; o <= reach; ++o) {
        if (o <= down[i] && gh + o < height) {
          acc += centre[o * kTileW * kLanes];
        }
        if (o <= up[i] && gh - o >= 0) acc += centre[-o * kTileW * kLanes];
      }
      out[(static_cast<size_t>(gh) * width + gw) * d_pad + d0 + lane] =
          __fmul_rn(acc, inv[i]);
    }
  }
}

}  // namespace

extern "C" int mccnn_cbca_stencil_round(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    void* stream) {
  if (radius < 0 || radius > kHalo || d_pad % kLanes ||
      (width + kTileW - 1) / kTileW > 65535 ||
      (height + kTileH - 1) / kTileH > 65535 || vol_in == vol_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      (static_cast<size_t>(kBatch) * (kTileW + 2 * radius) * kLanes +
       static_cast<size_t>(kTileH + 2 * radius) * kTileW * kLanes) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d_pad / kLanes, (width + kTileW - 1) / kTileW,
                  (height + kTileH - 1) / kTileH);
  cbca_stencil_kernel<<<grid, kThreads, shared,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol_in), static_cast<float*>(vol_out),
      static_cast<const int*>(arm_left), static_cast<const int*>(arm_right),
      static_cast<const int*>(arm_up), static_cast<const int*>(arm_down),
      static_cast<const float*>(inv_region), height, width, d_pad, radius);
  return static_cast<int>(cudaGetLastError());
}
