// K5: both sides of the band cost volume in one launch, finalized.
//
// Replaces mccnn_tpu/ops/cost_volume_pallas.py::_band_kernel_mxu
// (band_pair_pallas(sides="both", finalize_ndisp=ndisp)).
//
//   left[h, w, d]  = -<fL(h, w), fR(h, w - d)>
//   right[h, w, d] = -<fR(h, w), fL(h, w + d)>
//
// with 0 where the correspondence falls outside the image and BIG_COST in
// the pad lanes d >= ndisp, written directly in the storage type.
//
// Design. K1's tile scheme (band.cu), both sides in one block: one block per
// (image row, 32-column tile, 128-disparity chunk) with 256 threads; warps
// 0-3 own the left band's disparity d0 + t, warps 4-7 the right band's, so
// the side is uniform within a warp. Each image's 32 x 64 tile is the anchor
// of its own band; the (32 + 127)-column context window of the other image
// is staged channel-major with a row stride of 159 words (conflict-free
// reads across a warp, as in K1). Two anchors and two contexts need 97.7 KB,
// over the 48 KB static limit, so the shared memory is dynamic
// (cudaFuncAttributeMaxDynamicSharedMemorySize); two blocks fit an SM, 16
// warps, K1's occupancy. The f32 accumulation runs over the channels in
// K1's order with the same fmaf chain, so one launch equals two K1 launches
// bit for bit.
//
// Bound. 64 FMAs per real output, 2 x 2 x 64 x H x W x ndisp operations per
// pair (77 GFLOP at 1000 x 1504 x 200), against two (H, W, 64) reads and two
// (H, W, D_pad) writes; like K1 it is limited by its shared-memory reads
// (about 1.25 loads per FMA), not by the f32 peak or the bytes. Register
// blocking over neighbouring diagonals or wgmma is the later work.
#include "common.cuh"

namespace {

constexpr int kChannels = 64;
constexpr int kTileW = 32;
constexpr int kChunkD = 128;                  // disparities per block
constexpr int kThreads = 2 * kChunkD;         // one half per side
constexpr int kCtx = kTileW + kChunkD - 1;    // context columns (159)
constexpr int kAnchorWords = kTileW * kChannels;
constexpr int kCtxWords = kChannels * kCtx;
constexpr size_t kSharedBytes =
    2 * (kAnchorWords + kCtxWords) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_pair_kernel(const T* __restrict__ feat_left,
                 const T* __restrict__ feat_right, T* __restrict__ out_left,
                 T* __restrict__ out_right, int width, int d_pad, int ndisp) {
  extern __shared__ __align__(16) float s_mem[];
  float* s_anchor_l = s_mem;                       // fL tile, [wl][c]
  float* s_anchor_r = s_mem + kAnchorWords;        // fR tile, [wl][c]
  float* s_ctx_r = s_mem + 2 * kAnchorWords;       // fR window, [c][x]
  float* s_ctx_l = s_ctx_r + kCtxWords;            // fL window, [c][x]

  const int w0 = blockIdx.x * kTileW;
  const int d0 = blockIdx.z * kChunkD;
  const int tid = threadIdx.x;
  const int right = tid >= kChunkD;   // warp-uniform
  const int t = tid - right * kChunkD;
  const int d = d0 + t;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  T* __restrict__ out = right ? out_right : out_left;

  if (d0 >= ndisp) {  // the whole chunk is pad lanes
    for (int wl = 0; wl < kTileW && w0 + wl < width; ++wl) {
      out[(row + w0 + wl) * d_pad + d] = mccnn::from_f32<T>(mccnn::kBigCost);
    }
    return;
  }

  for (int e = tid; e < kAnchorWords; e += kThreads) {
    const int gw = w0 + e / kChannels;
    const size_t at = (row + gw) * kChannels + e % kChannels;
    s_anchor_l[e] = gw < width ? mccnn::to_f32(feat_left[at]) : 0.f;
    s_anchor_r[e] = gw < width ? mccnn::to_f32(feat_right[at]) : 0.f;
  }
  // context column x holds column base + x of the other image: the left
  // band reads fR at w - d, the right band fL at w + d
  const int base_r = w0 - d0 - (kChunkD - 1);
  const int base_l = w0 + d0;
  for (int e = tid; e < kCtx * kChannels; e += kThreads) {
    const int x = e / kChannels;
    const int c = e % kChannels;
    const int gr = base_r + x;
    const int gl = base_l + x;
    s_ctx_r[c * kCtx + x] = (gr >= 0 && gr < width)
        ? mccnn::to_f32(feat_right[(row + gr) * kChannels + c])
        : 0.f;
    s_ctx_l[c * kCtx + x] = (gl >= 0 && gl < width)
        ? mccnn::to_f32(feat_left[(row + gl) * kChannels + c])
        : 0.f;
  }
  __syncthreads();

  const float* s_anchor = right ? s_anchor_r : s_anchor_l;
  const float* s_ctx = right ? s_ctx_l : s_ctx_r;
  for (int wl = 0; wl < kTileW; ++wl) {
    const int gw = w0 + wl;
    if (gw >= width) break;
    float v;
    if (d >= ndisp) {
      v = mccnn::kBigCost;
    } else {
      const int src = right ? gw + d : gw - d;
      if (src < 0 || src >= width) {
        v = 0.f;  // no correspondence: the border fills overwrite it
      } else {
        const int x = right ? wl + t : wl - t + (kChunkD - 1);
        const float4* a =
            reinterpret_cast<const float4*>(s_anchor + wl * kChannels);
        float acc = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < kChannels / 4; ++c4) {
          const float4 av = a[c4];
          const float* col = s_ctx + 4 * c4 * kCtx + x;
          acc = fmaf(av.x, col[0], acc);
          acc = fmaf(av.y, col[kCtx], acc);
          acc = fmaf(av.z, col[2 * kCtx], acc);
          acc = fmaf(av.w, col[3 * kCtx], acc);
        }
        v = -acc;
      }
    }
    out[(row + gw) * d_pad + d] = mccnn::from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* feat_left, const void* feat_right,
                   void* out_left, void* out_right, int height, int width,
                   int d_pad, int ndisp, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      band_pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((width + kTileW - 1) / kTileW, height, d_pad / kChunkD);
  band_pair_kernel<T><<<grid, kThreads, kSharedBytes, s>>>(
      static_cast<const T*>(feat_left), static_cast<const T*>(feat_right),
      static_cast<T*>(out_left), static_cast<T*>(out_right), width, d_pad,
      ndisp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mccnn_band_pair(const void* feat_left, const void* feat_right,
                               void* out_left, void* out_right, int height,
                               int width, int channels, int d_pad, int ndisp,
                               int bf16, void* stream) {
  if (channels != kChannels || d_pad % kChunkD || height > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(feat_left, feat_right, out_left, out_right,
                                   height, width, d_pad, ndisp, s)
           : launch<float>(feat_left, feat_right, out_left, out_right, height,
                           width, d_pad, ndisp, s));
}
