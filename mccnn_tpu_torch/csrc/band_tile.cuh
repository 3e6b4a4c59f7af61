// The block routine of the band kernels, templated on the tile shape, on
// a direction and on an epilogue that turns a score into the stored
// value: K5 (band_pair.cu) and K6 (band_vpu.cu) store both bands off one
// tile, K1's f32 route (band.cu) one band. The two bands hold the same dot
// products:
//
//   left[w, d] = <fL(w), fR(w - d)> = right[w - d, d]
//
// so a block of K5 or K6 per (image row, kTileW-column tile, 128-disparity
// chunk) computes the correlation tile t[w][d] = <fL(w), fR(w - d)> once
// and stores it twice: row w of the tile is the left band's pixel w, its
// diagonal w - d = const the right band's pixel w - d. The grid runs their
// column tiles up to w = width + d_max, so that every right pixel's lanes
// are covered; a block whose left and right pixels all lie past the image
// returns. K1 stores one side, rows only, and its grid stops at width: on
// the left it runs that same tile, on the right the tile of the other
// direction, t[w][d] = <fR(w), fL(w + d)>. Every value is one 64-term fmaf
// chain over the channels in order, starting from 0.f, whichever direction
// computes it (a product of two floats is the same in either order): so K5
// equals two K1 f32 launches bit for bit, and -K6 equals K5 with
// ndisp = d_pad.
//
// Register tile. A thread owns Bw columns x Bd disparities at a stride of
// kLanes in both: lane (h, p, q) holds columns wc + h Bw kLanes + p + 4 i
// and disparities wd + q + 4 j. Along the diagonals (the left direction)
// output (i, j) then reads context column xb + 4 (i - j + Bd - 1), along
// the anti-diagonals (the right direction) xb + 4 (i + j): outputs on one
// diagonal share it, so per channel a thread reads Bw anchor values and
// Bw + Bd - 1 context values for Bw x Bd multiply-adds (8 + 15 for 64 at
// K5's and K6's 8 x 8, 4 + 19 at K1's 4 x 16). The right direction holds
// its disparities in reverse (accumulator j is disparity wd + q +
// 4 (Bd - 1 - j)), which gives it the left direction's reads: one
// multiply-add loop serves both. The loop runs channels outer and outputs
// inner, so each output's chain keeps the channel order. A quarter warp
// (8 lanes) reads 4 distinct anchor pixels and 5 consecutive context
// pixels per float4 load in either direction (p - q or p + q), which the
// row padding below spreads over distinct banks.
//
// Staging. The channels come in slices of 16, pixel-major as device memory
// holds them (rows of 20 words: 16-byte reads of neighbouring pixels fall
// in different banks), by zero-filling 16-byte cp.async: anchor columns
// w0.. and the (kTileW + 127)-column context window of the other image,
// from w0 - d0 - 127 on the left, from w0 + d0 on the right. Two slice
// buffers: slice s + 1 is in flight while slice s is multiplied, one
// barrier per slice. bf16 descriptors (K5 in bf16) land raw and are
// widened to f32 (exact) in one pass per slice before the multiply-adds.
//
// Epilogue. After the last slice every thread writes its values, turned
// into the output type by the epilogue, into the tile in the same shared
// memory (rows of 4 words past a multiple of 32). Then the block stores
// the left band (K1: its one band) as whole 128-lane runs of each pixel in
// 16-byte pieces, and K5 and K6 the right band one warp per pixel, 32
// lanes of its run a store, the run read off the tile's diagonal (reads
// step 133 words: distinct banks). A thread whose tile lies wholly past
// the image, wholly out of range or wholly past the epilogue's compute end
// does no multiply-adds (its sums stay 0); a block with no real match
// before the compute end (pad-only chunks, tiles past the image, K1's
// left tiles with w0 + kTileW - 1 < d0 and right tiles with
// w0 + d0 >= width) stages nothing, and K1's chunk of pad lanes only
// writes its fill in 16-byte pieces with no tile.
//
// Budget at K5's and K6's 8 x 8 tile and 64 columns: 128 threads (four
// warps of 64 columns x 32 disparities), 64 accumulators and 32 anchor
// registers a thread, 128 registers with four blocks per SM; shared
// memory 40,800 bytes with f32 descriptors (two slices of 255 pixels),
// 36,720 with bf16 ones (one f32 slice and two raw slices of 8,160 bytes),
// the tile (33,792 bytes in f32) overlaid. K1's 4 x 16 tile at 64 columns
// (band.cu) has the same 128 threads (four warps of 32 columns x 64
// disparities), 64 accumulators, the same f32 shared bytes, and 16 anchor
// registers; it runs at 128 registers with 60 bytes spilled, four blocks
// per SM (three blocks and no spill were slower: PERF.md §6). What
// bounds them: the staging of the context windows (a block reads
// 2 kTileW + 127 pixels for kTileW columns, from L2), the shared-memory
// pipe of the multiply-adds (23 float4 loads per 256 a thread) and the
// stores, one after the other within a block. K5's right band, runs that
// start anywhere in a pixel's 128 lanes, and its column tiles past the
// image add about a quarter to K1's time at the same tile (PERF.md
// §6).
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

// The direction of a tile: kLeft, t[w][d] = <anchor(w), context(w - d)>
// (the left band; K5's and K6's tile with anchor fL and context fR), read
// along diagonals; kRight, t[w][d] = <anchor(w), context(w + d)> (the
// right band with anchor fR and context fL), read along anti-diagonals.
enum class Side { kLeft, kRight };

// whether output (w, d), w < width, has a correspondence in the image
template <Side D>
__device__ __forceinline__ bool matched(int w, int d, int width) {
  return D == Side::kLeft ? w >= d : w + d < width;
}

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

// Request slice `slice` of the anchor columns and the context window into
// `dst`: f32 lands in the padded rows the multiply-adds read, bf16 raw and
// packed (kSliceC values a pixel). Columns outside the image are zeros.
template <typename Tin, class S, Side D>
__device__ __forceinline__ void request_slice(
    unsigned char* dst, const Tin* __restrict__ anchor,
    const Tin* __restrict__ context, size_t row, int w0, int d0, int width,
    int slice) {
  constexpr int kPieces = kSliceC * sizeof(Tin) / 16;  // per pixel
  constexpr int kPixelBytes =
      sizeof(Tin) == 4 ? kRowWords * 4 : kSliceC * 2;
  // context column x holds fR column w0 - d0 - 127 + x (kLeft) or fL
  // column w0 + d0 + x (kRight): output (w, d) reads
  // x = w - w0 - (d - d0) + 127, or x = w - w0 + d - d0
  const int base = D == Side::kLeft ? w0 - d0 - (kChunkD - 1) : w0 + d0;
  for (int e = threadIdx.x; e < S::kPixels * kPieces; e += S::kThreads) {
    const int piece = e % kPieces;
    const int px = e / kPieces;
    const bool is_anchor = px < S::kTileW;
    const int gx = is_anchor ? w0 + px : base + px - S::kTileW;
    const bool valid = gx >= 0 && gx < width;
    const Tin* src = (is_anchor ? anchor : context) +
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
// anchor pixel, `ctx` its first context pixel (xb); accumulator (i, j)
// reads context pixel xb + 4 (i - j + Bd - 1) in either direction (`Lane`
// says which output it holds).
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

// A thread's place in its block: its first column col0 and disparity dmin
// (local), its first context column xb, and the local disparity that
// accumulator (i, j) holds, at column col0 + 4 i. Along the diagonals
// (kLeft) that is dmin + 4 j, reading context column
// xb + 4 (i - j + Bd - 1) = col0 - dl + 127; along the anti-diagonals
// (kRight) it is dmin + 4 (Bd - 1 - j), reading col0 + 4 i + dl =
// xb + 4 (i + Bd - 1 - j) with xb = col0 + dmin: the same reads as the
// left direction's, so both run one `accumulate`.
template <class S, Side D>
struct Lane {
  int col0, dmin, xb;
  __device__ Lane() {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int p = lane % kLanes;
    const int q = lane / kLanes % kLanes;
    col0 = warp % S::kWarpsW * S::kWarpW + lane / 16 * S::kHalfW + p;
    dmin = warp / S::kWarpsW * S::kWarpD + q;
    xb = D == Side::kLeft
             ? col0 - dmin + (kChunkD - 1) - kLanes * (S::kBd - 1)
             : col0 + dmin;
  }
  __device__ int disparity(int j) const {
    return dmin + kLanes * (D == Side::kLeft ? j : S::kBd - 1 - j);
  }
};

// The multiply-adds of one block into the thread's register tile: the
// slices staged two in flight, each multiplied when it lands; no sums
// unless `active`. Ends with a barrier: the shared memory is free.
template <typename Tin, class S, Side D>
__device__ __forceinline__ void correlate(float (&acc)[S::kBw][S::kBd],
                                          unsigned char* s_mem,
                                          const Tin* __restrict__ anchor,
                                          const Tin* __restrict__ context,
                                          size_t row, int w0, int d0,
                                          int width, const Lane<S, D>& at,
                                          bool active) {
  using L = Layout<Tin, float, S>;
  float* f32 = reinterpret_cast<float*>(s_mem);
  unsigned char* raw = s_mem + (L::kWiden ? L::kF32Bytes : 0);
  constexpr int kRawStride = L::kWiden ? L::kRawBytes : L::kF32Bytes;
  request_slice<Tin, S, D>(raw, anchor, context, row, w0, d0, width, 0);
  for (int s = 0; s < kSlices; ++s) {
    wait_copies();
    // slice s is visible; every thread is done with slice s - 1
    __syncthreads();
    if (s + 1 < kSlices) {
      request_slice<Tin, S, D>(raw + (s + 1) % 2 * kRawStride, anchor,
                               context, row, w0, d0, width, s + 1);
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
      accumulate<S::kBw, S::kBd>(acc, slice + at.col0 * kRowWords,
                                 slice + (S::kTileW + at.xb) * kRowWords);
    }
  }
  __syncthreads();  // the tile overwrites the slices
}

// The register tile's values, turned into the output type by the
// epilogue, into the block's tile [w][d] in shared memory.
template <typename Tout, class S, Side D, class Epilogue>
__device__ __forceinline__ void write_tile(
    Tout* tile, const float (&acc)[S::kBw][S::kBd], const Lane<S, D>& at,
    int w0, int d0, int width, const Epilogue& ep) {
  constexpr int kBandRow = Layout<float, Tout, S>::kBandRow;
#pragma unroll
  for (int i = 0; i < S::kBw; ++i) {
#pragma unroll
    for (int j = 0; j < S::kBd; ++j) {
      const int c = at.col0 + kLanes * i;
      const int dl = at.disparity(j);
      const int w = w0 + c;
      const int d = d0 + dl;
      tile[c * kBandRow + dl] = from_f32<Tout>(
          ep.value(acc[i][j], d, w < width && matched<D>(w, d, width)));
    }
  }
}

// Pixel w0 + c of `out` (row stride `depth`) takes tile row c: whole
// 128-lane runs in 16-byte pieces (a depth that is no multiple of a piece,
// K6's, value by value).
template <typename Tout, class S>
__device__ __forceinline__ void store_rows(const Tout* tile, Tout* out,
                                           size_t row, int w0, int d0,
                                           int width, int depth) {
  constexpr int kBandRow = Layout<float, Tout, S>::kBandRow;
  constexpr int kVec = 16 / sizeof(Tout);
  constexpr int kRuns = kChunkD / kVec;
  const int lanes = min(kChunkD, depth - d0);
  const bool whole = depth % kVec == 0;
  for (int e = threadIdx.x; e < S::kTileW * kRuns; e += S::kThreads) {
    const int dl = e % kRuns * kVec;
    const int c = e / kRuns;
    if (w0 + c >= width || dl >= lanes) continue;
    const Tout* from = tile + c * kBandRow + dl;
    Tout* to = out + (row + w0 + c) * depth + d0 + dl;
    if (whole) {
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    } else {
      for (int k = 0; k < kVec && dl + k < lanes; ++k) to[k] = from[k];
    }
  }
}

// The two-sided block (K5, K6): blockIdx.x the column tile, .y the image
// row, .z the disparity chunk. Its correlation tile
// t[w][d] = <fL(w), fR(w - d)> is the left band at (w, d) and the right
// band at (w - d, d). The grid runs column tiles up to w = width + d_max
// so that every right pixel's lanes are covered. The epilogue gives
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
  const Lane<S, Side::kLeft> at;

  float acc[S::kBw][S::kBd];
#pragma unroll
  for (int i = 0; i < S::kBw; ++i) {
#pragma unroll
    for (int j = 0; j < S::kBd; ++j) acc[i][j] = 0.f;
  }

  const int end = ep.compute_end();
  // block-uniform: some output of the tile is a real match before the end
  if (d0 < end && w0 < width && w0 + S::kTileW - 1 >= d0) {
    const int gw = w0 + at.col0;
    const int gd = d0 + at.dmin;
    const bool active =
        gw < width && gd < end && gw + kLanes * (S::kBw - 1) >= gd;
    correlate<Tin, S, Side::kLeft>(acc, s_mem, feat_left, feat_right, row,
                                   w0, d0, width, at, active);
  }

  // the tile's values: a match is real on both sides when 0 <= w - d and
  // w < width; else the correspondence falls outside the image
  Tout* tile = reinterpret_cast<Tout*>(s_mem);
  write_tile<Tout, S>(tile, acc, at, w0, d0, width, ep);
  __syncthreads();

  const int depth = ep.depth();
  const int lanes = min(kChunkD, depth - d0);
  store_rows<Tout, S>(tile, ep.left, row, w0, d0, width, depth);
  // right band: pixel w0 - d0 - 127 + r takes the tile's diagonal r,
  // lanes lo <= dl < hi at tile row r - 127 + dl, a run of at most kTileW
  // lanes; a warp stores it 32 lanes a store from lo on (the reads step
  // kBandRow + 1 values: distinct banks)
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
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

// a 16-byte piece of four copies of `v` (the one-sided routine's pad
// fill; it is instantiated on f32 output only)
__device__ __forceinline__ uint4 splat16(float v) {
  const unsigned u = __float_as_uint(v);
  return make_uint4(u, u, u, u);
}

// The one-sided block (K1's f32 route): the tile of direction D of
// `anchor` against `context`, t[w][d] = <anchor(w), context(w -+ d)>,
// stored as the rows of `ep.out` only; the grid's column tiles stop at
// width. A chunk at or past the compute end holds pad lanes only: it is
// filled with value(0, d0, false), the same on every lane past the end,
// in 16-byte pieces with no tile. The epilogue gives compute_end(),
// depth() (a multiple of kChunkD), out and value(score, d, matched).
template <typename Tin, typename Tout, class S, Side D, class Epilogue>
__device__ __forceinline__ void band_side_block(
    const Tin* __restrict__ anchor, const Tin* __restrict__ context,
    int width, const Epilogue& ep) {
  extern __shared__ __align__(16) unsigned char s_mem[];
  const int w0 = blockIdx.x * S::kTileW;
  const int d0 = blockIdx.z * kChunkD;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  const int end = ep.compute_end();
  if (d0 >= end) {
    constexpr int kVec = 16 / sizeof(Tout);
    constexpr int kRuns = kChunkD / kVec;
    const uint4 piece = splat16(from_f32<Tout>(ep.value(0.f, d0, false)));
    for (int e = threadIdx.x; e < S::kTileW * kRuns; e += S::kThreads) {
      const int c = e / kRuns;
      if (w0 + c >= width) continue;
      *reinterpret_cast<uint4*>(ep.out + (row + w0 + c) * ep.depth() + d0 +
                                e % kRuns * kVec) = piece;
    }
    return;
  }
  const Lane<S, D> at;

  float acc[S::kBw][S::kBd];
#pragma unroll
  for (int i = 0; i < S::kBw; ++i) {
#pragma unroll
    for (int j = 0; j < S::kBd; ++j) acc[i][j] = 0.f;
  }

  // block-uniform: some output of the tile is a real match
  const bool real = D == Side::kLeft ? w0 + S::kTileW - 1 >= d0
                                     : w0 + d0 < width;
  if (real) {
    // whether the thread's tile holds a match before the end: its lowest
    // disparity and its highest column (left) or lowest column (right)
    // decide
    const int gw = w0 + at.col0;
    const int gd = d0 + at.dmin;
    const bool active =
        gw < width && gd < end &&
        (D == Side::kLeft ? gw + kLanes * (S::kBw - 1) >= gd
                          : gw + gd < width);
    correlate<Tin, S, D>(acc, s_mem, anchor, context, row, w0, d0, width,
                         at, active);
  }
  Tout* tile = reinterpret_cast<Tout*>(s_mem);
  write_tile<Tout, S>(tile, acc, at, w0, d0, width, ep);
  __syncthreads();
  store_rows<Tout, S>(tile, ep.out, row, w0, d0, width, ep.depth());
}

// column tiles up to width + d_max (the right band's last lanes), rows,
// chunks
template <class S>
inline dim3 grid(int height, int width, int depth) {
  const int chunks = (depth + kChunkD - 1) / kChunkD;
  return dim3((width + chunks * kChunkD - 1 + S::kTileW - 1) / S::kTileW,
              height, chunks);
}

// one side's grid: column tiles up to width, rows, chunks
template <class S>
inline dim3 side_grid(int height, int width, int depth) {
  return dim3((width + S::kTileW - 1) / S::kTileW, height,
              (depth + kChunkD - 1) / kChunkD);
}

}  // namespace band
}  // namespace mccnn
