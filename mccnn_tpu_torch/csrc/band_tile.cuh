// The tile scheme shared by the two-sided band kernels (K5 band_pair.cu,
// K6 band_vpu.cu): one block per (image row, 32-column tile, 128-disparity
// chunk) with 256 threads; warps 0-3 own the left band's disparity d0 + t,
// warps 4-7 the right band's, so the side is uniform within a warp. Each
// image's 32 x 64 tile is the anchor of its own band; the (32 + 127)-column
// context window of the other image is staged channel-major with a row
// stride of 159 words (conflict-free reads across a warp, as in K1). Two
// anchors and two contexts need 97.7 KB, over the 48 KB static limit, so the
// shared memory is dynamic; two blocks fit an SM. The f32 accumulation runs
// over the channels in K1's order with the same fmaf chain, so K5 equals two
// K1 launches and -K6 equals K5 bit for bit.
#pragma once

#include "common.cuh"

namespace mccnn {
namespace band {

constexpr int kChannels = 64;
constexpr int kTileW = 32;
constexpr int kChunkD = 128;                  // disparities per block
constexpr int kThreads = 2 * kChunkD;         // one half per side
constexpr int kCtx = kTileW + kChunkD - 1;    // context columns (159)
constexpr int kAnchorWords = kTileW * kChannels;
constexpr int kCtxWords = kChannels * kCtx;
constexpr size_t kSharedBytes =
    2 * (kAnchorWords + kCtxWords) * sizeof(float);

// The block's four staged tiles, carved out of its dynamic shared memory.
struct Tiles {
  float* anchor_l;  // fL tile, [wl][c]
  float* anchor_r;  // fR tile, [wl][c]
  float* ctx_r;     // fR window, [c][x]
  float* ctx_l;     // fL window, [c][x]
};

__device__ __forceinline__ Tiles carve(float* s_mem) {
  return {s_mem, s_mem + kAnchorWords, s_mem + 2 * kAnchorWords,
          s_mem + 2 * kAnchorWords + kCtxWords};
}

// Stage both anchors and both context windows of row `row` (an offset in
// pixels), columns w0.., disparities d0..; columns outside the image are 0.
// Ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage(const Tiles& s,
                                      const T* __restrict__ feat_left,
                                      const T* __restrict__ feat_right,
                                      size_t row, int w0, int d0, int width) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kAnchorWords; e += kThreads) {
    const int gw = w0 + e / kChannels;
    const size_t at = (row + gw) * kChannels + e % kChannels;
    s.anchor_l[e] = gw < width ? to_f32(feat_left[at]) : 0.f;
    s.anchor_r[e] = gw < width ? to_f32(feat_right[at]) : 0.f;
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
    s.ctx_r[c * kCtx + x] = (gr >= 0 && gr < width)
        ? to_f32(feat_right[(row + gr) * kChannels + c])
        : 0.f;
    s.ctx_l[c * kCtx + x] = (gl >= 0 && gl < width)
        ? to_f32(feat_left[(row + gl) * kChannels + c])
        : 0.f;
  }
  __syncthreads();
}

// <anchor(w0 + wl), other(w0 + wl -+ (d0 + t))> for the thread's side
__device__ __forceinline__ float score(const Tiles& s, bool right, int wl,
                                       int t) {
  const float* s_ctx = right ? s.ctx_l : s.ctx_r;
  const int x = right ? wl + t : wl - t + (kChunkD - 1);
  const float4* a = reinterpret_cast<const float4*>(
      (right ? s.anchor_r : s.anchor_l) + wl * kChannels);
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
  return acc;
}

}  // namespace band
}  // namespace mccnn
