// K9: two cross-based cost-aggregation (CBCA) rounds in one pass.
//
// Replaces mccnn_tpu/ops/cbca_fused2.py::_two_round_kernel (cbca_fused_two;
// cbca_impl "fused2" and, with the bf16-operand flag on f32 storage,
// "fused2_16"). Round A is evaluated on the region the output tile's arms
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
// Design. One block owns a (32-column, 8-lane, 256-row) output tile and
// streams its double-haloed window, (256 + 4 r) rows of (32 + 4 r) columns,
// through shared memory a row at a time, as K8 does (cbca_rolling.cu); a
// whole window of the tile would not fit (K7 already could not hold a
// 58 x 58 x 32-lane block). Two rolling stages are chained. Stage A: thread
// = (intermediate column, lane) over the 32 + 2 r columns round B can reach;
// it forms the row's horizontal arm sum into ring A (2 r + 1 rows), takes
// the vertical arm sum of the row r behind out of the ring, scales, rounds
// to the storage type and publishes that intermediate row in shared memory.
// Stage B: the 32 x 8 threads of the tile's own columns do the same on the
// intermediate rows through ring B and store the row 2 r behind. Both rings
// are private to the thread that writes them; the raw row and the
// intermediate row cost one barrier each per row. Round A needs all four
// arms and 1 / region at the intermediate pixels, not only at the tile's:
// every thread stays on one image column, so it loads that column's planes
// at rows y, y - r and y - 2 r, one iteration ahead. Intermediate pixels
// outside the image are exactly 0 (predicated, nothing is multiplied by a
// mask) and no real pixel's border-capped arm reaches them. Every shape
// runs the kernel: there is no narrow-shape fallback.
//
// Bound: bytes, one read and one write of the volume per two rounds. The
// window re-reads (32 + 4 r) / 32 = 2.6 x of the volume's columns through L2
// and round A is evaluated on (32 + 2 r) / 32 = 1.8 x the pixels.
#include "cbca_arms.cuh"

namespace {

constexpr int kTileW = 32;                            // output columns
constexpr int kBandH = 256;                           // output rows
constexpr int kLanes = 8;                             // disparities per block
constexpr int kColsMax = kTileW + 2 * mccnn::kArmHalo;  // stage-A columns
constexpr int kThreads = kColsMax * kLanes;           // 512
constexpr int kQuads = kLanes / 4;

// one thread's arm lengths and 1 / region for the four sums of one row step
struct Arms {
  int a_left, a_right, a_up, a_down, b_left, b_right, b_up, b_down;
  float a_inv, b_inv;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cbca_two_round_kernel(const T* __restrict__ vol, T* __restrict__ out,
                      const int* __restrict__ arm_left,
                      const int* __restrict__ arm_right,
                      const int* __restrict__ arm_up,
                      const int* __restrict__ arm_down,
                      const float* __restrict__ inv_region, int height,
                      int width, int d_pad, int radius, int round_operand) {
  extern __shared__ __align__(16) float s_mem[];
  const int slots = 2 * radius + 1;
  const int cols_a = kTileW + 2 * radius;   // intermediate columns
  const int raw_cols = kTileW + 4 * radius;
  float* s_raw = s_mem;                               // [raw_cols][lanes]
  float* s_val = s_raw + raw_cols * kLanes;           // [kColsMax][lanes]
  float* s_ring_a = s_val + kColsMax * kLanes;        // [slots][cols_a][lanes]
  float* s_ring_b = s_ring_a + slots * cols_a * kLanes;  // [slots][32][lanes]

  const int d0 = blockIdx.x * kLanes;
  const int w0 = blockIdx.y * kTileW;
  const int hb0 = blockIdx.z * kBandH;
  const int hb1 = min(hb0 + kBandH, height);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int ca = tid / kLanes;            // stage-A column
  const int gw = w0 - radius + ca;        // this thread's image column
  const bool rounded = round_operand != 0;
  const bool col_a = ca < cols_a && gw >= 0 && gw < width;
  const bool col_b = col_a && ca >= radius && ca < radius + kTileW;

  // the thread's part in staging a raw row: quad lq of window column lx
  const int lx = tid / kQuads;
  const int lq = tid % kQuads;
  const int lgx = w0 - 2 * radius + lx;
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
  auto stash = [&](float4 v) {
    if (loader) {
      *reinterpret_cast<float4*>(s_raw + lx * kLanes + 4 * lq) = v;
    }
  };
  // this column's arm lengths at a row, clamped to the radius and the
  // image; -1: no such pixel (or no such stage for this thread)
  auto horizontal_arms = [&](bool on, int row, int& left, int& right) {
    left = right = -1;
    if (on && row >= 0 && row < height) {
      mccnn::load_arms(arm_left, arm_right,
                       static_cast<size_t>(row) * width + gw, radius, gw,
                       width - 1 - gw, left, right);
    }
  };
  auto vertical_arms = [&](bool on, int row, int& up, int& down, float& inv) {
    up = down = -1;
    inv = 0.f;
    if (on && row >= 0 && row < height) {
      const size_t pix = static_cast<size_t>(row) * width + gw;
      mccnn::load_arms(arm_up, arm_down, pix, radius, row, height - 1 - row,
                       up, down);
      inv = inv_region[pix];
    }
  };
  // the four sums of iteration y: round A horizontal at row y and vertical
  // at row y - r (once ring A is full, y >= hb0); round B horizontal at the
  // same intermediate row and vertical at row y - 2 r (inside the band)
  auto arms_of = [&](int y) -> Arms {
    Arms s;
    const bool full = y >= hb0;
    const int o = y - 2 * radius;
    horizontal_arms(col_a, y, s.a_left, s.a_right);
    vertical_arms(col_a && full, y - radius, s.a_up, s.a_down, s.a_inv);
    horizontal_arms(col_b && full, y - radius, s.b_left, s.b_right);
    vertical_arms(col_b && o >= hb0 && o < hb1, o, s.b_up, s.b_down, s.b_inv);
    return s;
  };

  const int y0 = hb0 - 2 * radius;
  const int y1 = hb1 - 1 + 2 * radius;
  Arms arms = arms_of(y0);
  stash(fetch(y0));
  int slot = 0;
  const int stride_a = cols_a * kLanes;
  constexpr int kStrideB = kTileW * kLanes;
  // out-of-strip threads (ca >= cols_a) never touch a ring
  float* ring_a = s_ring_a + min(ca, cols_a - 1) * kLanes + lane;
  float* ring_b =
      s_ring_b + min(max(ca - radius, 0), kTileW - 1) * kLanes + lane;

  for (int y = y0; y <= y1; ++y) {
    __syncthreads();  // the raw row is staged; the last intermediate row read
    const float4 raw_next = fetch(y < y1 ? y + 1 : -1);
    const Arms next = arms_of(y + 1);
    const int centre = slot >= radius ? slot - radius : slot - radius + slots;

    // round A: horizontal sum of raw row y, vertical sum for row y - r
    if (ca < cols_a) {
      float horiz = 0.f;
      if (arms.a_left >= 0) {
        horiz = mccnn::arm_sum(s_raw + (ca + radius) * kLanes + lane, kLanes,
                               arms.a_left, arms.a_right);
      }
      ring_a[slot * stride_a] = horiz;
    }
    float value = 0.f;
    if (arms.a_up >= 0) {
      const float acc = mccnn::ring_sum(ring_a, stride_a, slots, centre,
                                        arms.a_up, arms.a_down);
      // the unfused round's store, then round B's operand
      value = mccnn::as_operand(
          mccnn::to_f32(mccnn::from_f32<T>(__fmul_rn(acc, arms.a_inv))),
          rounded);
    }
    s_val[ca * kLanes + lane] = value;
    __syncthreads();  // the intermediate row is published; raw row consumed

    // round B: horizontal sum of intermediate row y - r, vertical sum for
    // output row y - 2 r
    if (ca >= radius && ca < radius + kTileW) {
      float horiz = 0.f;
      if (arms.b_left >= 0) {
        horiz = mccnn::arm_sum(s_val + ca * kLanes + lane, kLanes,
                               arms.b_left, arms.b_right);
      }
      ring_b[slot * kStrideB] = horiz;
      if (arms.b_up >= 0) {
        const int o = y - 2 * radius;
        const float acc = mccnn::ring_sum(ring_b, kStrideB, slots, centre,
                                          arms.b_up, arms.b_down);
        out[(static_cast<size_t>(o) * width + gw) * d_pad + d0 + lane] =
            mccnn::from_f32<T>(__fmul_rn(acc, arms.b_inv));
      }
    }

    stash(raw_next);
    slot = slot + 1 == slots ? 0 : slot + 1;
    arms = next;
  }
}

template <typename T>
cudaError_t launch(const void* vol_in, void* vol_out, const int* arm_l,
                   const int* arm_r, const int* arm_u, const int* arm_d,
                   const float* inv, int height, int width, int d_pad,
                   int radius, int round_operand, cudaStream_t s) {
  const size_t slots = 2 * radius + 1;
  const size_t shared =
      ((kTileW + 4 * radius) + kColsMax + slots * (kTileW + 2 * radius) +
       slots * kTileW) *
      kLanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_two_round_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const dim3 grid(d_pad / kLanes, (width + kTileW - 1) / kTileW,
                  (height + kBandH - 1) / kBandH);
  cbca_two_round_kernel<T><<<grid, kThreads, shared, s>>>(
      static_cast<const T*>(vol_in), static_cast<T*>(vol_out), arm_l, arm_r,
      arm_u, arm_d, inv, height, width, d_pad, radius, round_operand);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mccnn_cbca_two_rounds(
    const void* vol_in, void* vol_out, const void* arm_left,
    const void* arm_right, const void* arm_up, const void* arm_down,
    const void* inv_region, int height, int width, int d_pad, int radius,
    int bf16, int round_operand, void* stream) {
  if (radius < 0 || radius > mccnn::kArmHalo || vol_in == vol_out ||
      d_pad % kLanes || (width + kTileW - 1) / kTileW > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* al = static_cast<const int*>(arm_left);
  const int* ar = static_cast<const int*>(arm_right);
  const int* au = static_cast<const int*>(arm_up);
  const int* ad = static_cast<const int*>(arm_down);
  const float* inv = static_cast<const float*>(inv_region);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(vol_in, vol_out, al, ar, au, ad, inv,
                                   height, width, d_pad, radius,
                                   round_operand, s)
           : launch<float>(vol_in, vol_out, al, ar, au, ad, inv, height,
                           width, d_pad, radius, round_operand, s));
}
