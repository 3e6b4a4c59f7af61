// K2: one cross-based cost-aggregation (CBCA) round.
//
// Replaces mccnn_tpu/ops/cbca_fused.py::_round_kernel (cbca_fused, the f32
// and bf16 storage modes):
//
//   horiz[h, w, d] = sum over w + o, o in [-left(h,w), right(h,w)] of vol
//   out[h, w, d]   = inv_region(h, w) *
//                    sum over h + o, o in [-up(h,w), down(h,w)] of horiz
//
// Design: two passes through an f32 scratch volume (the caller allocates it
// once per call). Pass 1 runs one block per (row, 32-column tile, 128-lane
// disparity chunk) and stages the haloed row segment (32 + 2 x radius
// columns x 128 lanes) in shared memory; pass 2 does the same per
// (32-row tile, column, chunk) over the scratch. Threads run along d, so
// every global read and write is a coalesced 128-lane run. Sums are f32 and
// taken in the order of the plain stencil (mccnn_tpu_torch/ops/cbca.py,
// itself JAX's ops/cbca.py): centre, then +1, -1, +2, -2, ...; so the kernel
// reproduces the plain round bit for bit. This is tighter than the TPU bf16
// mode, whose DEFAULT-precision phase 2 rounds the horizontal sums to bf16.
// With round_operand (cbca_fused(compute_dtype=bf16) on f32 storage, the
// "fused16" mode) every volume value is rounded to bf16 as it is staged for
// the horizontal sum; the sums and the scratch stay f32, and the rounding of
// the horizontal sums is left out here too.
// The round may run in place (vol_out == vol_in): pass 2 reads only the
// scratch.
//
// Bound: memory traffic. Per round and volume element it reads the storage
// once and writes the f32 scratch, then reads the scratch and writes the
// storage: 12 bytes per element in bf16 (4.6 GB per round at half
// resolution, 1000 x 1504 x 256), 16 in f32; the halo re-reads
// (2 x 13 of every 32 columns or rows) mostly hit L2. A fused single pass
// that keeps the horizontal sums in shared memory would drop the scratch's
// 8 bytes per element; that is later work.
#include "cbca_arms.cuh"

namespace {

constexpr int kChunkD = 128;  // threads per block
constexpr int kTile = 32;     // output columns (pass 1) or rows (pass 2)
constexpr int kHalo = 16;     // largest radius (distance - 1) supported

template <typename T>
__global__ void __launch_bounds__(kChunkD)
cbca_horizontal_kernel(const T* __restrict__ vol, float* __restrict__ horiz,
                       const int* __restrict__ arm_left,
                       const int* __restrict__ arm_right, int width, int d_pad,
                       int radius, int round_operand) {
  __shared__ float s_win[(kTile + 2 * kHalo) * kChunkD];
  __shared__ int s_left[kTile];
  __shared__ int s_right[kTile];

  const int w0 = blockIdx.x * kTile;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  const int d = blockIdx.z * kChunkD + threadIdx.x;
  const int t = threadIdx.x;

  for (int x = 0; x < kTile + 2 * radius; ++x) {
    const int gx = w0 - radius + x;
    s_win[x * kChunkD + t] = (gx >= 0 && gx < width)
        ? mccnn::as_operand(mccnn::to_f32(vol[(row + gx) * d_pad + d]),
                            round_operand != 0)
        : 0.f;
  }
  if (t < kTile) {
    const int gw = w0 + t;
    s_left[t] = gw < width ? arm_left[row + gw] : 0;
    s_right[t] = gw < width ? arm_right[row + gw] : 0;
  }
  __syncthreads();

  for (int wl = 0; wl < kTile; ++wl) {
    const int gw = w0 + wl;
    if (gw >= width) break;
    const float* centre = s_win + (wl + radius) * kChunkD + t;
    const int left = s_left[wl];
    const int right = s_right[wl];
    float acc = centre[0];
    for (int o = 1; o <= radius; ++o) {
      // arms are border-capped; the bounds tests are a second guard
      if (o <= right && gw + o < width) acc += centre[o * kChunkD];
      if (o <= left && gw - o >= 0) acc += centre[-o * kChunkD];
    }
    horiz[(row + gw) * d_pad + d] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kChunkD)
cbca_vertical_kernel(const float* __restrict__ horiz, T* __restrict__ out,
                     const int* __restrict__ arm_up,
                     const int* __restrict__ arm_down,
                     const float* __restrict__ inv_region, int height,
                     int width, int d_pad, int radius) {
  __shared__ float s_win[(kTile + 2 * kHalo) * kChunkD];
  __shared__ int s_up[kTile];
  __shared__ int s_down[kTile];
  __shared__ float s_inv[kTile];

  const int h0 = blockIdx.x * kTile;
  const int w = blockIdx.y;
  const int d = blockIdx.z * kChunkD + threadIdx.x;
  const int t = threadIdx.x;

  for (int y = 0; y < kTile + 2 * radius; ++y) {
    const int gh = h0 - radius + y;
    s_win[y * kChunkD + t] = (gh >= 0 && gh < height)
        ? horiz[(static_cast<size_t>(gh) * width + w) * d_pad + d]
        : 0.f;
  }
  if (t < kTile) {
    const int gh = h0 + t;
    const size_t pix = static_cast<size_t>(gh) * width + w;
    s_up[t] = gh < height ? arm_up[pix] : 0;
    s_down[t] = gh < height ? arm_down[pix] : 0;
    s_inv[t] = gh < height ? inv_region[pix] : 0.f;
  }
  __syncthreads();

  for (int hl = 0; hl < kTile; ++hl) {
    const int gh = h0 + hl;
    if (gh >= height) break;
    const float* centre = s_win + (hl + radius) * kChunkD + t;
    const int up = s_up[hl];
    const int down = s_down[hl];
    float acc = centre[0];
    for (int o = 1; o <= radius; ++o) {
      if (o <= down && gh + o < height) acc += centre[o * kChunkD];
      if (o <= up && gh - o >= 0) acc += centre[-o * kChunkD];
    }
    out[(static_cast<size_t>(gh) * width + w) * d_pad + d] =
        mccnn::from_f32<T>(__fmul_rn(acc, s_inv[hl]));
  }
}

template <typename T>
void launch_round(const void* vol_in, float* horiz, void* vol_out,
                  const int* arm_l, const int* arm_r, const int* arm_u,
                  const int* arm_d, const float* inv, int height, int width,
                  int d_pad, int radius, int round_operand, cudaStream_t s) {
  const dim3 grid1((width + kTile - 1) / kTile, height, d_pad / kChunkD);
  cbca_horizontal_kernel<T><<<grid1, kChunkD, 0, s>>>(
      static_cast<const T*>(vol_in), horiz, arm_l, arm_r, width, d_pad,
      radius, round_operand);
  const dim3 grid2((height + kTile - 1) / kTile, width, d_pad / kChunkD);
  cbca_vertical_kernel<T><<<grid2, kChunkD, 0, s>>>(
      horiz, static_cast<T*>(vol_out), arm_u, arm_d, inv, height, width,
      d_pad, radius);
}

}  // namespace

extern "C" int mccnn_cbca_round(const void* vol_in, void* horiz,
                                void* vol_out, const void* arm_left,
                                const void* arm_right, const void* arm_up,
                                const void* arm_down, const void* inv_region,
                                int height, int width, int d_pad, int radius,
                                int bf16, int round_operand, void* stream) {
  if (radius < 0 || radius > kHalo || d_pad % kChunkD || height > 65535 ||
      width > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* al = static_cast<const int*>(arm_left);
  const int* ar = static_cast<const int*>(arm_right);
  const int* au = static_cast<const int*>(arm_up);
  const int* ad = static_cast<const int*>(arm_down);
  const float* inv = static_cast<const float*>(inv_region);
  float* scratch = static_cast<float*>(horiz);
  if (bf16) {
    launch_round<__nv_bfloat16>(vol_in, scratch, vol_out, al, ar, au, ad, inv,
                                height, width, d_pad, radius, round_operand,
                                s);
  } else {
    launch_round<float>(vol_in, scratch, vol_out, al, ar, au, ad, inv, height,
                        width, d_pad, radius, round_operand, s);
  }
  return static_cast<int>(cudaGetLastError());
}
