// The block routine of the two-sided band kernels (K5 band_pair.cu, K6
// band_vpu.cu), templated on the tile shape and on an epilogue that turns a
// score into the stored value. The two bands hold the same dot products:
//
//   left[w, d] = <fL(w), fR(w - d)> = right[w - d, d]
//
// so one block per (image row, kTileW-column tile, 128-disparity chunk)
// computes the correlation tile t[w][d] = <fL(w), fR(w - d)> once and
// stores it twice: row w of the tile is the left band's pixel w, its
// diagonal w - d = const the right band's pixel w - d. Every value is one
// 64-term fmaf chain over the channels in order, starting from 0.f, as
// K1's f32 route (band.cu) runs it on either side (a product of two floats
// is the same in either order): so K5 equals two K1 f32 launches bit for
// bit, and -K6 equals K5 with ndisp = d_pad. The grid runs column tiles up
// to w = width + d_max, so that every right pixel's lanes are covered;
// a block whose left and right pixels all lie past the image returns.
//
// Register tile. A thread owns Bw columns x Bd disparities at a stride of
// kLanes in both: lane (h, p, q) holds columns wc + h Bw kLanes + p + 4 i
// and disparities wd + q + 4 j. Then output (i, j) reads context column
// xb + 4 (i - j + Bd - 1): outputs on one diagonal share it, so per
// channel a thread reads Bw anchor values and Bw + Bd - 1 context values
// for Bw x Bd multiply-adds (8 + 15 for 64 at the shipped 8 x 8). The
// loop runs channels outer and outputs inner, so each output's chain keeps
// the channel order. A quarter warp (8 lanes) reads 4 distinct anchor pixels
// and 5 consecutive context pixels per float4 load, which the row padding
// below spreads over distinct banks.
//
// Staging. The channels come in slices of 16, pixel-major as device memory
// holds them (rows of 20 words: 16-byte reads of neighbouring pixels fall
// in different banks), by zero-filling 16-byte cp.async: anchor columns
// w0.. of fL and the (kTileW + 127)-column context window of fR. Two slice
// buffers: slice s + 1 is in flight while slice s is multiplied, one
// barrier per slice. bf16 descriptors (K5 in bf16) land raw and are
// widened to f32 (exact) in one pass per slice before the multiply-adds.
//
// Epilogue. After the last slice every thread writes its values, turned
// into the output type by the epilogue, into the tile in the same shared
// memory (rows of 4 words past a multiple of 32). Then the block stores
// the left band as whole 128-lane runs of each pixel in 16-byte pieces,
// and the right band one warp per pixel, 32 lanes of its run a store, the
// run read off the tile's diagonal (reads step 133 words: distinct banks).
// A thread whose tile lies wholly past the image, wholly out of range or
// wholly past the epilogue's compute end does no multiply-adds (its sums
// stay 0); a block with no real match before the compute end (K5's
// pad-only chunks, tiles past the image) stages nothing.
//
// Budget at the shipped 8 x 8 tile and 64 columns: 128 threads (four
// warps of 64 columns x 32 disparities), 64 accumulators and 32 anchor
// registers a thread, 128 registers with four blocks per SM; shared
// memory 40,800 bytes with f32 descriptors (two slices of 255 pixels),
// 36,720 with bf16 ones (one f32 slice and two raw slices of 8,160 bytes),
// the tile (33,792 bytes in f32) overlaid.
#pragma once

#include "common.cuh"

namespace mccnn {
namespace band {

constexpr int kChannels = 64;
constexpr int kChunkD = 128;                 // disparities per block
constexpr int kLanes = 4;                    // a half warp's lanes along w, d
constexpr int kSliceC = 16;                  // channels per staged slice
constexpr int kSlices = kChannels / kSliceC;
constexpr int kRowWords = kSliceC + 4;       // f32 words per staged pixel
// the shipped register tile and column tile
constexpr int kBw = 8;
constexpr int kBd = 8;
constexpr int kTileW = 64;

template <int Bw, int Bd, int TileW>
struct Tile {
  static constexpr int kBw = Bw;
  static constexpr int kBd = Bd;
  static constexpr int kTileW = TileW;
  static constexpr int kHalfW = kLanes * Bw;  // columns of a half warp
  static constexpr int kWarpW = 2 * kHalfW;   // columns of a warp
  static constexpr int kWarpD = kLanes * Bd;  // disparities of a warp
  static constexpr int kWarpsW = TileW / kWarpW;
  static constexpr int kThreads = 32 * kWarpsW * (kChunkD / kWarpD);
  // 128 registers a thread: as many blocks as the register file holds
  static constexpr int kMinBlocks = kThreads < 512 ? 512 / kThreads : 1;
  static constexpr int kCtx = TileW + kChunkD - 1;  // context columns
  static constexpr int kPixels = TileW + kCtx;      // anchor, then context
  static_assert(TileW % kWarpW == 0 && kChunkD % kWarpD == 0,
                "the warps must tile the block");
};

// the tile the kernels ship; tools/time_band_variants.py rebuilds them at
// other shapes by defining the three macros (nvcc splits a -D value at
// commas)
#ifdef MCCNN_BAND_TILE_W
using ShippedTile =
    Tile<MCCNN_BAND_TILE_BW, MCCNN_BAND_TILE_BD, MCCNN_BAND_TILE_W>;
#else
using ShippedTile = Tile<kBw, kBd, kTileW>;
#endif

// Shared memory of one block: the slice buffers (two f32 buffers; for bf16
// descriptors two raw buffers and one f32 buffer), then reused as the
// correlation tile [w][d] of the output type.
template <typename Tin, typename Tout, class S>
struct Layout {
  static constexpr bool kWiden = sizeof(Tin) == 2;
  static constexpr int kF32Bytes = S::kPixels * kRowWords * 4;  // a slice
  static constexpr int kRawBytes = S::kPixels * kSliceC * 2;
  static constexpr int kStageBytes =
      kWiden ? kF32Bytes + 2 * kRawBytes : 2 * kF32Bytes;
  // tile rows: kChunkD values and 4 words, 4 words past a multiple of 32
  static constexpr int kBandRow = kChunkD + 16 / sizeof(Tout);
  static constexpr int kBandBytes = S::kTileW * kBandRow * sizeof(Tout);
  static constexpr size_t kBytes =
      kStageBytes > kBandBytes ? kStageBytes : kBandBytes;
};

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Request slice `slice` of the anchor columns (fL) and the context window
// (fR) into `dst`: f32 lands in the padded rows the multiply-adds read,
// bf16 raw and packed (kSliceC values a pixel). Columns outside the image
// are zeros.
template <typename Tin, class S>
__device__ __forceinline__ void request_slice(
    unsigned char* dst, const Tin* __restrict__ feat_left,
    const Tin* __restrict__ feat_right, size_t row, int w0, int d0,
    int width, int slice) {
  constexpr int kPieces = kSliceC * sizeof(Tin) / 16;  // per pixel
  constexpr int kPixelBytes =
      sizeof(Tin) == 4 ? kRowWords * 4 : kSliceC * 2;
  // context column x holds fR column w0 - d0 - 127 + x: output (w, d)
  // reads x = w - w0 - (d - d0) + 127
  const int base = w0 - d0 - (kChunkD - 1);
  for (int e = threadIdx.x; e < S::kPixels * kPieces; e += S::kThreads) {
    const int piece = e % kPieces;
    const int px = e / kPieces;
    const bool anchor = px < S::kTileW;
    const int gx = anchor ? w0 + px : base + px - S::kTileW;
    const bool valid = gx >= 0 && gx < width;
    const Tin* src = (anchor ? feat_left : feat_right) +
                     (valid ? (row + gx) * kChannels + slice * kSliceC +
                                  piece * (16 / sizeof(Tin))
                            : 0);
    copy_async_16(dst + px * kPixelBytes + piece * 16, src, valid);
  }
  commit_copies();
}

// bf16 slice (packed) -> f32 slice (padded rows); bf16 -> f32 is exact
template <class S>
__device__ __forceinline__ void widen_slice(float* dst,
                                            const unsigned char* raw) {
  constexpr int kHalves = kSliceC / 8;  // 16-byte pieces of a raw pixel
  for (int e = threadIdx.x; e < S::kPixels * kHalves; e += S::kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + e * 16);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    float* f = dst + e / kHalves * kRowWords + e % kHalves * 8;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      *reinterpret_cast<float4*>(f + 4 * k) = make_float4(
          __uint_as_float(w[2 * k] << 16),
          __uint_as_float(w[2 * k] & 0xffff0000u),
          __uint_as_float(w[2 * k + 1] << 16),
          __uint_as_float(w[2 * k + 1] & 0xffff0000u));
    }
  }
}

// The thread's multiply-adds over one staged slice: `anchor` is its first
// anchor pixel, `ctx` its first context pixel (xb); output (i, j) reads
// context pixel xb + 4 (i - j + Bd - 1).
template <int Bw, int Bd>
__device__ __forceinline__ void accumulate(float (&acc)[Bw][Bd],
                                           const float* anchor,
                                           const float* ctx) {
#pragma unroll
  for (int g = 0; g < kSliceC / 4; ++g) {
    float4 a[Bw];
#pragma unroll
    for (int i = 0; i < Bw; ++i) {
      a[i] = *reinterpret_cast<const float4*>(
          anchor + kLanes * i * kRowWords + 4 * g);
    }
#pragma unroll
    for (int m = 0; m < Bw + Bd - 1; ++m) {
      const float4 c = *reinterpret_cast<const float4*>(
          ctx + kLanes * m * kRowWords + 4 * g);
#pragma unroll
      for (int i = 0; i < Bw; ++i) {
        const int j = i - m + Bd - 1;
        if (j >= 0 && j < Bd) {
          acc[i][j] = fmaf(a[i].x, c.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, c.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, c.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, c.w, acc[i][j]);
        }
      }
    }
  }
}

// The whole block: blockIdx.x the column tile, .y the image row, .z the
// disparity chunk. Its correlation tile t[w][d] = <fL(w), fR(w - d)> is
// the left band at (w, d) and the right band at (w - d, d). The grid runs
// column tiles up to w = width + d_max so that every right pixel's lanes
// are covered. The epilogue gives
//   compute_end(): no multiply-adds at d >= it,
//   depth():       the output's lanes per pixel (its row stride),
//   left, right:   the two outputs,
//   value(score, d, matched): the stored value, as f32;
// lanes d >= depth() are not stored.
template <typename Tin, typename Tout, class S, class Epilogue>
__device__ __forceinline__ void band_block(const Tin* __restrict__ feat_left,
                                           const Tin* __restrict__ feat_right,
                                           int width, const Epilogue& ep) {
  using L = Layout<Tin, Tout, S>;
  extern __shared__ __align__(16) unsigned char s_mem[];
  const int w0 = blockIdx.x * S::kTileW;
  const int d0 = blockIdx.z * kChunkD;
  // neither a left pixel (w < width) nor a right one (w - d < width)
  if (w0 >= width + d0 + kChunkD - 1) return;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int p = lane % kLanes;
  const int q = lane / kLanes % kLanes;
  const int col0 = warp % S::kWarpsW * S::kWarpW + lane / 16 * S::kHalfW + p;
  const int dmin = warp / S::kWarpsW * S::kWarpD + q;
  // local context column of output (i, j) = xb + 4 (i - j + Bd - 1)
  const int xb = col0 - dmin + (kChunkD - 1) - kLanes * (S::kBd - 1);

  float acc[S::kBw][S::kBd];
#pragma unroll
  for (int i = 0; i < S::kBw; ++i) {
#pragma unroll
    for (int j = 0; j < S::kBd; ++j) acc[i][j] = 0.f;
  }

  const int end = ep.compute_end();
  // block-uniform: some output of the tile is a real match before the end
  if (d0 < end && w0 < width && w0 + S::kTileW - 1 >= d0) {
    const int gw = w0 + col0;
    const int gd = d0 + dmin;
    const bool active =
        gw < width && gd < end && gw + kLanes * (S::kBw - 1) >= gd;
    float* f32 = reinterpret_cast<float*>(s_mem);
    unsigned char* raw = s_mem + (L::kWiden ? L::kF32Bytes : 0);
    constexpr int kRawStride = L::kWiden ? L::kRawBytes : L::kF32Bytes;
    request_slice<Tin, S>(raw, feat_left, feat_right, row, w0, d0, width,
                          0);
    for (int s = 0; s < kSlices; ++s) {
      wait_copies();
      // slice s is visible; every thread is done with slice s - 1
      __syncthreads();
      if (s + 1 < kSlices) {
        request_slice<Tin, S>(raw + (s + 1) % 2 * kRawStride, feat_left,
                              feat_right, row, w0, d0, width, s + 1);
      }
      const float* slice;
      if constexpr (L::kWiden) {
        widen_slice<S>(f32, raw + s % 2 * kRawStride);
        __syncthreads();
        slice = f32;
      } else {
        slice = f32 + s % 2 * (kRawStride / 4);
      }
      if (active) {
        accumulate<S::kBw, S::kBd>(acc, slice + col0 * kRowWords,
                                   slice + (S::kTileW + xb) * kRowWords);
      }
    }
    __syncthreads();  // the tile overwrites the slices
  }

  // the tile's values: a match is real on both sides when 0 <= w - d and
  // w < width; else the correspondence falls outside the image
  Tout* tile = reinterpret_cast<Tout*>(s_mem);
#pragma unroll
  for (int i = 0; i < S::kBw; ++i) {
#pragma unroll
    for (int j = 0; j < S::kBd; ++j) {
      const int c = col0 + kLanes * i;
      const int dl = dmin + kLanes * j;
      const int w = w0 + c;
      const int d = d0 + dl;
      tile[c * L::kBandRow + dl] =
          from_f32<Tout>(ep.value(acc[i][j], d, w >= d && w < width));
    }
  }
  __syncthreads();

  const int depth = ep.depth();
  const int lanes = min(kChunkD, depth - d0);
  // left band: pixel w0 + c takes tile row c, in 16-byte pieces (a depth
  // that is no multiple of a piece, K6's, value by value)
  constexpr int kVec = 16 / sizeof(Tout);
  constexpr int kRuns = kChunkD / kVec;
  const bool whole = depth % kVec == 0;
  for (int e = threadIdx.x; e < S::kTileW * kRuns; e += S::kThreads) {
    const int dl = e % kRuns * kVec;
    const int c = e / kRuns;
    if (w0 + c >= width || dl >= lanes) continue;
    const Tout* from = tile + c * L::kBandRow + dl;
    Tout* to = ep.left + (row + w0 + c) * depth + d0 + dl;
    if (whole) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      for (int k = 0; k < kVec && dl + k < lanes; ++k) to[k] = from[k];
    }
  }
  // right band: pixel w0 - d0 - 127 + r takes the tile's diagonal r,
  // lanes lo <= dl < hi at tile row r - 127 + dl, a run of at most kTileW
  // lanes; a warp stores it 32 lanes a store from lo on (the reads step
  // kBandRow + 1 values: distinct banks)
  constexpr int kWarps = S::kThreads / 32;
  constexpr int kDiag = L::kBandRow + 1;  // tile step along a diagonal
  // offsets of this lane's lane 0 of pixel r in the tile and the output,
  // stepped with r
  int from = (warp - (kChunkD - 1)) * L::kBandRow + lane * kDiag;
  long long to =
      (static_cast<long long>(row) + w0 - d0 - (kChunkD - 1) + warp) *
          depth +
      d0 + lane;
  for (int r = warp; r < S::kCtx;
       r += kWarps, from += kWarps * L::kBandRow, to += kWarps * depth) {
    const int wr = w0 - d0 - (kChunkD - 1) + r;
    if (wr < 0 || wr >= width) continue;
    const int lo = max(0, kChunkD - 1 - r);
    const int hi = min(lanes, kChunkD - 1 - r + S::kTileW) - lane;
#pragma unroll
    for (int k = 0; k < S::kTileW / 32; ++k) {
      const int dl = lo + 32 * k;
      if (dl < hi) ep.right[to + dl] = tile[from + dl * kDiag];
    }
  }
}

// column tiles up to width + d_max (the right band's last lanes), rows,
// chunks
template <class S>
inline dim3 grid(int height, int width, int depth) {
  const int chunks = (depth + kChunkD - 1) / kChunkD;
  return dim3((width + chunks * kChunkD - 1 + S::kTileW - 1) / S::kTileW,
              height, chunks);
}

}  // namespace band
}  // namespace mccnn
