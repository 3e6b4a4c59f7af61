// K6: both raw score bands by shifted multiply-add, f32.
//
// Replaces mccnn_tpu/ops/cost_volume_pallas.py::_band_kernel
// (band_pair_pallas(use_mxu=False), the bitwise-f32 path):
//
//   left[h, w, d]  = <fL(h, w), fR(h, w - d)>
//   right[h, w, d] = <fR(h, w), fL(h, w + d)>
//
// 0 where the correspondence falls outside the image; scores, not costs: no
// negation and no BIG_COST lanes (those are K1's and K5's finalized form).
// The descriptors are f32; the output type may be f32 or bf16 (the TPU
// kernel's out_dtype cast on the store). What stays behind from the TPU
// kernel: the channel-major zero-padded copies of the features, the
// per-disparity lane shifts, and the (H, D, W) output with its transpose:
// this kernel writes (H, W, D) directly, and any depth.
//
// Design. The two-sided tile scheme of band_tile.cuh, as K5 (band_pair.cu):
// the same staging and the same fmaf chain over the channels, so on f32
// descriptors -K6 equals K5(ndisp = d_pad) bit for bit.
//
// Bound. 64 FMAs per in-range output against two (H, W, 64) reads and two
// (H, W, D) writes; limited, like K5, by its shared-memory reads (about 1.25
// loads per FMA), not by the f32 peak or the bytes.
#include "band_tile.cuh"

namespace {

using namespace mccnn::band;

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_scores_kernel(const float* __restrict__ feat_left,
                   const float* __restrict__ feat_right,
                   T* __restrict__ out_left, T* __restrict__ out_right,
                   int width, int depth) {
  extern __shared__ __align__(16) float s_mem[];
  const Tiles tiles = carve(s_mem);
  const int w0 = blockIdx.x * kTileW;
  const int d0 = blockIdx.z * kChunkD;
  const int right = threadIdx.x >= kChunkD;   // warp-uniform
  const int t = threadIdx.x - right * kChunkD;
  const int d = d0 + t;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  T* __restrict__ out = right ? out_right : out_left;

  stage(tiles, feat_left, feat_right, row, w0, d0, width);
  if (d >= depth) return;  // a ragged last chunk

  for (int wl = 0; wl < kTileW; ++wl) {
    const int gw = w0 + wl;
    if (gw >= width) break;
    const int src = right ? gw + d : gw - d;
    // no correspondence: the score is 0
    const float v =
        (src < 0 || src >= width) ? 0.f : score(tiles, right, wl, t);
    out[(row + gw) * depth + d] = mccnn::from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(const void* feat_left, const void* feat_right,
                   void* out_left, void* out_right, int height, int width,
                   int depth, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      band_scores_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((width + kTileW - 1) / kTileW, height,
                  (depth + kChunkD - 1) / kChunkD);
  band_scores_kernel<T><<<grid, kThreads, kSharedBytes, s>>>(
      static_cast<const float*>(feat_left),
      static_cast<const float*>(feat_right), static_cast<T*>(out_left),
      static_cast<T*>(out_right), width, depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mccnn_band_scores(const void* feat_left,
                                 const void* feat_right, void* out_left,
                                 void* out_right, int height, int width,
                                 int channels, int depth, int out_bf16,
                                 void* stream) {
  if (channels != kChannels || depth < 1 || height > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_bf16 ? launch<__nv_bfloat16>(feat_left, feat_right, out_left,
                                       out_right, height, width, depth, s)
               : launch<float>(feat_left, feat_right, out_left, out_right,
                               height, width, depth, s));
}
