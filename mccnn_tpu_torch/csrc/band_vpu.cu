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
// Design. The block routine of band_tile.cuh, as K5 (band_pair.cu), with an
// epilogue that stores the raw score and stops at `depth`: the same
// correlation tile for both bands, the same register tiles and the same
// fmaf chain over the channels, so on f32 descriptors -K6 equals
// K5(ndisp = d_pad) bit for bit. A ragged last chunk does no multiply-adds
// past `depth`; a depth that is no multiple of a 16-byte piece stores the
// left band value by value.
//
// Bound. 64 multiply-adds per in-range dot product on every lane, once for
// both bands (45.1 GFLOP at 1000 x 1504 x 256, 0.67 ms at the f32 rate),
// against two (H, W, 64) reads and two (H, W, D) writes (3.85 GB with f32
// out, 1.15 ms; 2.31 GB with bf16 out, 0.69 ms): the bytes, as for K5,
// with the same shared-memory pipe and right-band stores above them.
#include "band_tile.cuh"

namespace {

using namespace mccnn::band;

template <typename T>
struct RawScores {
  T* left;
  T* right;
  int depth_;
  __device__ int compute_end() const { return depth_; }
  __device__ int depth() const { return depth_; }
  __device__ float value(float score, int, bool matched) const {
    return matched ? score : 0.f;  // no correspondence: the score is 0
  }
};

template <typename T, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
band_scores_kernel(const float* __restrict__ feat_left,
                   const float* __restrict__ feat_right,
                   T* __restrict__ out_left, T* __restrict__ out_right,
                   int width, int depth) {
  band_block<float, T, S>(feat_left, feat_right, width,
                          RawScores<T>{out_left, out_right, depth});
}

template <typename T, class S>
cudaError_t launch_scores(const void* feat_left, const void* feat_right,
                          void* out_left, void* out_right, int height,
                          int width, int depth, cudaStream_t s) {
  constexpr size_t kBytes = Layout<float, T, S>::kBytes;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      band_scores_kernel<T, S>, kBytes, shared_allowed);
  if (err != cudaSuccess) return err;
  band_scores_kernel<T, S><<<grid<S>(height, width, depth), S::kThreads,
                             kBytes, s>>>(
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
  if (channels != kChannels || depth < 1 || height > 65535 ||
      !mccnn::aligned_16(feat_left, feat_right, out_left, out_right)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_bf16 ? launch_scores<__nv_bfloat16, ShippedTile>(
                     feat_left, feat_right, out_left, out_right, height,
                     width, depth, s)
               : launch_scores<float, ShippedTile>(feat_left, feat_right,
                                                   out_left, out_right,
                                                   height, width, depth, s));
}
