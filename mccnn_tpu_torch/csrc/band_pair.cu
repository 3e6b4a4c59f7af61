// K5: both sides of the band cost volume in one launch, finalized.
//
// Replaces mccnn_tpu/ops/cost_volume_pallas.py::_band_kernel_mxu
// (band_pair_pallas(sides="both", finalize_ndisp=ndisp)).
//
//   left[h, w, d]  = -<fL(h, w), fR(h, w - d)>
//   right[h, w, d] = -<fR(h, w), fL(h, w + d)>
//
// with 0 where the correspondence falls outside the image and BIG_COST in
// the pad lanes d >= ndisp, written directly in the storage type (f32 or
// bf16, from descriptors of that type).
//
// Design. The block routine of band_tile.cuh with an epilogue that
// negates, writes 0 out of range and BIG_COST on the pad lanes: one
// correlation tile per block serves both bands (right[w - d, d] is
// left[w, d]), register tiles along the band's diagonals, channel slices in
// flight by cp.async, the left band stored in 16-byte pieces of whole
// 128-lane runs and the right band off the tile's diagonals. No
// multiply-adds at d >= ndisp, and a chunk that holds only pad lanes stages
// nothing. The fmaf chain is K1's f32 route's, so in f32 one launch equals
// two K1 launches bit for bit; TF32 or the tensor cores would sum in
// another order.
//
// Bound. 64 multiply-adds per real dot product, each computed once for
// both bands (2 x 64 x H x sum over d < ndisp of (W - d): 36.0 GFLOP at
// 1000 x 1504 x 200, 0.54 ms at the f32 rate), against two (H, W, 64)
// reads and two (H, W, D_pad) writes (3.85 GB in f32, 1.15 ms; 1.92 GB in
// bf16, 0.57 ms): the bytes. What holds it above them is the shared-memory
// pipe of the multiply-adds (23 float4 loads per 256 multiply-adds a
// thread) and the right band's stores, runs of up to 64 lanes that start
// anywhere in a pixel's 128 (PERF.md).
#include "band_tile.cuh"

namespace {

using namespace mccnn::band;

template <typename T>
struct Finalized {
  T* left;
  T* right;
  int d_pad;
  int ndisp;
  __device__ int compute_end() const { return ndisp; }
  __device__ int depth() const { return d_pad; }
  __device__ float value(float score, int d, bool matched) const {
    // no correspondence: 0, the border fills overwrite it
    return d >= ndisp ? mccnn::kBigCost : matched ? -score : 0.f;
  }
};

template <typename T, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
band_pair_kernel(const T* __restrict__ feat_left,
                 const T* __restrict__ feat_right, T* __restrict__ out_left,
                 T* __restrict__ out_right, int width, int d_pad, int ndisp) {
  band_block<T, T, S>(feat_left, feat_right, width,
                      Finalized<T>{out_left, out_right, d_pad, ndisp});
}

template <typename T, class S>
cudaError_t launch_pair(const void* feat_left, const void* feat_right,
                        void* out_left, void* out_right, int height,
                        int width, int d_pad, int ndisp, cudaStream_t s) {
  constexpr size_t kBytes = Layout<T, T, S>::kBytes;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      band_pair_kernel<T, S>, kBytes, shared_allowed);
  if (err != cudaSuccess) return err;
  band_pair_kernel<T, S><<<grid<S>(height, width, d_pad), S::kThreads,
                           kBytes, s>>>(
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
  if (channels != kChannels || d_pad % kChunkD || height > 65535 ||
      !mccnn::aligned_16(feat_left, feat_right, out_left, out_right)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_pair<__nv_bfloat16, ShippedTile>(
                 feat_left, feat_right, out_left, out_right, height, width,
                 d_pad, ndisp, s)
           : launch_pair<float, ShippedTile>(feat_left, feat_right,
                                             out_left, out_right, height,
                                             width, d_pad, ndisp, s));
}
