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
// Design. The two-sided tile scheme of band_tile.cuh (K1's scheme, band.cu,
// with both sides in one block, K1's occupancy): one launch equals two K1
// launches bit for bit. A chunk that holds only pad lanes is filled without
// staging anything.
//
// Bound. 64 FMAs per real output, 2 x 2 x 64 x H x W x ndisp operations per
// pair (77 GFLOP at 1000 x 1504 x 200), against two (H, W, 64) reads and two
// (H, W, D_pad) writes; like K1 it is limited by its shared-memory reads
// (about 1.25 loads per FMA), not by the f32 peak or the bytes. Register
// blocking over neighbouring diagonals or wgmma is the later work.
#include "band_tile.cuh"

namespace {

using namespace mccnn::band;

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_pair_kernel(const T* __restrict__ feat_left,
                 const T* __restrict__ feat_right, T* __restrict__ out_left,
                 T* __restrict__ out_right, int width, int d_pad, int ndisp) {
  extern __shared__ __align__(16) float s_mem[];
  const Tiles tiles = carve(s_mem);
  const int w0 = blockIdx.x * kTileW;
  const int d0 = blockIdx.z * kChunkD;
  const int right = threadIdx.x >= kChunkD;   // warp-uniform
  const int t = threadIdx.x - right * kChunkD;
  const int d = d0 + t;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  T* __restrict__ out = right ? out_right : out_left;

  if (d0 >= ndisp) {  // the whole chunk is pad lanes
    for (int wl = 0; wl < kTileW && w0 + wl < width; ++wl) {
      out[(row + w0 + wl) * d_pad + d] = mccnn::from_f32<T>(mccnn::kBigCost);
    }
    return;
  }
  stage(tiles, feat_left, feat_right, row, w0, d0, width);

  for (int wl = 0; wl < kTileW; ++wl) {
    const int gw = w0 + wl;
    if (gw >= width) break;
    float v;
    if (d >= ndisp) {
      v = mccnn::kBigCost;
    } else {
      const int src = right ? gw + d : gw - d;
      // no correspondence: 0, the border fills overwrite it
      v = (src < 0 || src >= width) ? 0.f : -score(tiles, right, wl, t);
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
