// K8: one cross-based cost-aggregation (CBCA) round, rows rolled.
//
// Replaces mccnn_tpu/ops/cbca_rolling.py::_rolling_kernel
// (cbca_fused_rolling; cbca_impl "rolling" and, with the bf16-operand flag
// on f32 storage, "rolling16"):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// What the TPU kernel is for: every volume row is read once per column strip
// and its horizontal sums are formed once, instead of once per haloed row
// tile. What stays behind: the 0/1-mask matmuls, the ring-frame vertical
// masks, the pair-block schedule and the DMA semaphores.
//
// Design. One block owns a (32-column strip, lane chunk, 256-row band) and
// walks down the band's rows. Thread = (column, lane), the lane chunk one
// 32-byte sector of a pixel's D-row (8 f32 or 16 bf16 lanes). Per row the
// block stages the haloed row segment (32 + 2 r columns) in shared memory,
// each thread forms its pixel's horizontal arm sum and keeps it in a ring of
// the last 2 r + 1 rows; the vertical arm sum of the row r behind comes out
// of the ring, times 1 / region, stored. A thread reads only the ring
// entries it wrote itself, so the ring needs no barrier; the row segment is
// double-buffered, one barrier per row. The next row and the next rows' arm
// lengths (which bound the loops) are requested before the current row's
// sums. Rows and columns outside the image are predicated to 0 and never
// summed (no multiply by masks, no uninitialised ring slot: a band's first
// output row is produced only when all 2 r + 1 slots have been written).
// Sums run in the plain round's order (cbca_arms.cuh) with __fmul_rn, so the
// round equals the plain round, K2 and K7 bit for bit, in f32 and bf16
// storage. Out of place (the wrapper alternates two buffers).
//
// Bound: bytes, one read and one write of the volume per round (4 B per
// element in bf16, 8 in f32). The strip halo re-reads (32 + 2 r) / 32 = 1.8 x
// and the band halo (256 + 2 r) / 256 = 1.1 x of the volume, through L2. The
// lane chunk is the fastest-varying block index, so the blocks in flight
// cover whole pixel rows (K7's lesson, cbca_stencil.cu).
#include "cbca_arms.cuh"

namespace {

constexpr int kTileW = 32;    // columns per strip
constexpr int kBandH = 256;   // rows per band

template <typename T, int kLanes>
__global__ void __launch_bounds__(kTileW* kLanes)
cbca_rolling_kernel(const T* __restrict__ vol, T* __restrict__ out,
                    const int* __restrict__ arm_left,
                    const int* __restrict__ arm_right,
                    const int* __restrict__ arm_up,
                    const int* __restrict__ arm_down,
                    const float* __restrict__ inv_region, int height,
                    int width, int d_pad, int radius, int round_operand) {
  extern __shared__ __align__(16) float s_mem[];
  constexpr int kQuads = kLanes / 4;
  const int slots = 2 * radius + 1;
  const int raw_cols = kTileW + 2 * radius;
  float* s_raw = s_mem;                              // [2][raw_cols][lanes]
  float* s_ring = s_mem + 2 * raw_cols * kLanes;     // [slots][32][lanes]

  const int d0 = blockIdx.x * kLanes;
  const int w0 = blockIdx.y * kTileW;
  const int hb0 = blockIdx.z * kBandH;
  const int hb1 = min(hb0 + kBandH, height);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int col = tid / kLanes;
  const int gw = w0 + col;
  const bool rounded = round_operand != 0;

  // the thread's part in staging a row: quad lq of window column lx
  const int lx = tid / kQuads;
  const int lq = tid % kQuads;
  const int lgx = w0 - radius + lx;
  const bool loader = lx < raw_cols;
  const bool lcol_ok = loader && lgx >= 0 && lgx < width;

  auto fetch = [&](int y) -> float4 {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lcol_ok && y >= 0 && y < height) {
      v = mccnn::load_operand_quad(
          vol + (static_cast<size_t>(y) * width + lgx) * d_pad + d0 + 4 * lq,
          rounded);
    }
    return v;
  };
  auto stash = [&](int buf, float4 v) {
    if (loader) {
      *reinterpret_cast<float4*>(s_raw + (buf * raw_cols + lx) * kLanes +
                                 4 * lq) = v;
    }
  };
  // arm lengths clamped to the radius and the image; -1: no such pixel
  auto horizontal_arms = [&](int y, int& left, int& right) {
    left = right = -1;
    if (gw < width && y >= 0 && y < height) {
      mccnn::load_arms(arm_left, arm_right,
                       static_cast<size_t>(y) * width + gw, radius, gw,
                       width - 1 - gw, left, right);
    }
  };
  auto vertical_arms = [&](int o, int& up, int& down, float& inv) {
    up = down = -1;
    inv = 0.f;
    if (gw < width && o >= hb0 && o < hb1) {
      const size_t pix = static_cast<size_t>(o) * width + gw;
      mccnn::load_arms(arm_up, arm_down, pix, radius, o, height - 1 - o, up,
                       down);
      inv = inv_region[pix];
    }
  };

  const int y0 = hb0 - radius;
  const int y1 = hb1 - 1 + radius;
  int left, right, up, down;
  float inv;
  horizontal_arms(y0, left, right);
  vertical_arms(y0 - radius, up, down, inv);
  stash(0, fetch(y0));
  int buf = 0;
  int slot = 0;
  float* ring = s_ring + col * kLanes + lane;
  constexpr int kRingStride = kTileW * kLanes;

  for (int y = y0; y <= y1; ++y) {
    __syncthreads();
    // request the next row and the next rows' arms before this row's sums
    const float4 raw_next = fetch(y < y1 ? y + 1 : -1);
    int left_n, right_n, up_n, down_n;
    float inv_n;
    horizontal_arms(y + 1, left_n, right_n);
    vertical_arms(y + 1 - radius, up_n, down_n, inv_n);

    float horiz = 0.f;
    if (left >= 0) {
      horiz = mccnn::arm_sum(
          s_raw + (buf * raw_cols + col + radius) * kLanes + lane, kLanes,
          left, right);
    }
    ring[slot * kRingStride] = horiz;

    if (up >= 0) {
      const int o = y - radius;
      const int centre = slot >= radius ? slot - radius
                                        : slot - radius + slots;
      const float acc =
          mccnn::ring_sum(ring, kRingStride, slots, centre, up, down);
      out[(static_cast<size_t>(o) * width + gw) * d_pad + d0 + lane] =
          mccnn::from_f32<T>(__fmul_rn(acc, inv));
    }

    stash(buf ^ 1, raw_next);
    buf ^= 1;
    slot = slot + 1 == slots ? 0 : slot + 1;
    left = left_n;
    right = right_n;
    up = up_n;
    down = down_n;
    inv = inv_n;
  }
}

template <typename T, int kLanes>
cudaError_t launch(const void* vol_in, void* vol_out, const int* arm_l,
                   const int* arm_r, const int* arm_u, const int* arm_d,
                   const float* inv, int height, int width, int d_pad,
                   int radius, int round_operand, cudaStream_t s) {
  if (d_pad % kLanes) return cudaErrorInvalidValue;
  const size_t shared =
      (2 * static_cast<size_t>(kTileW + 2 * radius) * kLanes +
       static_cast<size_t>(2 * radius + 1) * kTileW * kLanes) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_rolling_kernel<T, kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid(d_pad / kLanes, (width + kTileW - 1) / kTileW,
                  (height + kBandH - 1) / kBandH);
  cbca_rolling_kernel<T, kLanes><<<grid, kTileW * kLanes, shared, s>>>(
      static_cast<const T*>(vol_in), static_cast<T*>(vol_out), arm_l, arm_r,
      arm_u, arm_d, inv, height, width, d_pad, radius, round_operand);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mccnn_cbca_rolling_round(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    int bf16, int round_operand, void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo || vol_in == vol_out ||
      (width + kTileW - 1) / kTileW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* al = static_cast<const int*>(arm_left);
  const int* ar = static_cast<const int*>(arm_right);
  const int* au = static_cast<const int*>(arm_up);
  const int* ad = static_cast<const int*>(arm_down);
  const float* inv = static_cast<const float*>(inv_region);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16, 16>(vol_in, vol_out, al, ar, au, ad, inv,
                                       height, width, d_pad, radius,
                                       round_operand, s)
           : launch<float, 8>(vol_in, vol_out, al, ar, au, ad, inv, height,
                              width, d_pad, radius, round_operand, s));
}
