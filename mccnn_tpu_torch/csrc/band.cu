// K1: one side of the band cost volume, finalized.
//
// Replaces mccnn_tpu/ops/cost_volume_pallas.py::_band_kernel_mxu_one
// (band_pair_pallas(sides="left"|"right", finalize_ndisp=ndisp)).
//
//   left:  out[h, w, d] = -<fL(h, w), fR(h, w - d)>
//   right: out[h, w, d] = -<fR(h, w), fL(h, w + d)>
//
// with 0 where the correspondence falls outside the image and BIG_COST in
// the pad lanes d >= ndisp, written directly in the storage type (no
// epilogue pass over the volume).
//
// Bound: bytes. A half-resolution side (1000 x 1504 x 256, bf16) writes
// 0.77 GB and reads 0.39 GB of descriptors; its 49 GFLOP are 0.05 ms at the
// bf16 tensor rate. One output a thread, each of its 64 scalar FMAs fed
// by a shared-memory load (the first port of both routes), is bound by the
// shared-memory pipe at six to ten times the byte bound: both routes reuse
// each staged operand across many outputs.
//
// bf16 descriptors (the serving path): the tensor cores. One block of four
// warps per (image row, 64-column tile, 128-disparity chunk). The anchor
// tile (64 x 64) and the (64 + 128)-column context window of the other
// image come in with 16-byte cp.async copies, zero-filled outside the image,
// and stay bf16, pixel-major as in device memory: that is already the
// row-major A and the column-major B of mma.sync.m16n8k16 (bf16 in, f32
// accumulate), so nothing is transposed. Rows are padded to 72 values (36
// words), which spreads the eight rows of a fragment load over all banks.
// Warp m owns anchor rows 16 m .. 16 m + 15: their band lies in context
// columns 16 m .. 16 m + 143 (w - d + 127 on the left side, whose context
// starts 127 columns before the tile, and w + d on the right), 18 n-tiles of
// 8, four k-steps each. The accumulators are not read along diagonals in
// registers: each is negated, replaced by 0 where the match falls outside
// the image and by BIG_COST on lanes d >= ndisp, and scattered as bf16 into
// a (64 x 128) band tile in shared memory at [w][d]; every band element is
// hit exactly once. The warp then stores its 16 rows with 16 bytes a
// thread, 256-byte runs per pixel. Only the warp itself reads what it
// scattered, so the kernel has one block barrier, after the copies land.
// Products of bf16 values are exact in f32; only the order of the 64-term
// sum differs from the plain version's, so the stored bf16 value is within
// one ulp (2^-8 at |cost| <= 1).
// Budget: shared memory 9,216 (anchor) + 27,648 (context) + 17,408 (band,
// rows padded to 136 values) = 54,272 bytes, dynamic, four blocks per SM;
// 16 + 4 + 2 fragment and accumulator registers live in the inner loop.
//
// f32 descriptors (the exact-f32 schedules): the block routine of K5 and
// K6 (band_tile.cuh), one-sided. One block of 128 threads per (image row,
// 64-column tile, 128-disparity chunk), column tiles up to width only;
// each thread holds a register tile of 4 columns x 16 disparities at a
// stride of 4, read along the correlation tile's diagonals on the left
// (context fR from w0 - d0 - 127) and its anti-diagonals on the right
// (context fL from w0 + d0), so 4 anchor and 19 context float4 loads feed
// 256 multiply-adds. Channel slices of 16 come in by cp.async two in
// flight (40,800 bytes of shared memory), the band tile (33,792 bytes)
// overlays them, and the block stores whole 128-lane runs of each pixel
// in 16-byte pieces; a chunk of pad lanes only is written with BIG_COST
// and nothing staged. 128 registers with 60 bytes spilled, four blocks
// per SM. Each output is one 64-term fmaf chain in channel order from
// 0.f, as K5 and K6 run it, so K5 in f32 equals two of these launches bit
// for bit; TF32 or the tensor cores would sum in another order. Bound:
// bytes (two (H, W, 64) f32 reads and one (H, W, D_pad) f32 write, 2.31
// GB at 1000 x 1504 x 256: 0.69 ms; its 36.0 GFLOP at ndisp 200 take
// 0.54 ms at the f32 rate). It takes about 2.5 x that: a block stages 191
// context pixels beside its 64 anchor pixels (3.1 GB read from L2 a
// side), multiplies, then stores, one after the other (PERF.md §6).
#include "band_tile.cuh"

namespace {

constexpr int kChannels = 64;
constexpr int kChunkD = 128;  // disparities per block

// ---- f32: the one-sided block routine of band_tile.cuh ----

namespace band = mccnn::band;

// the register tile and column tile of this route, the fastest of
// tools/time_band_variants.py's shapes on the card (PERF.md §6): a
// thread's 4 columns x 16 disparities, 64 columns a block. The tool's
// macros set every band kernel's tile at once.
constexpr int kSideBw = 4;
constexpr int kSideBd = 16;
constexpr int kSideTileW = 64;
#ifdef MCCNN_BAND_TILE_W
using SideTile = band::ShippedTile;
#else
using SideTile = band::Tile<kSideBw, kSideBd, kSideTileW>;
#endif

struct FinalizedSide {
  float* out;
  int d_pad;
  int ndisp;
  __device__ int compute_end() const { return ndisp; }
  __device__ int depth() const { return d_pad; }
  __device__ float value(float score, int d, bool matched) const {
    // no correspondence: 0, the border fills overwrite it
    return d >= ndisp ? mccnn::kBigCost : matched ? -score : 0.f;
  }
};

template <band::Side D, class S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
band_side_f32_kernel(const float* __restrict__ anchor,
                     const float* __restrict__ other,
                     float* __restrict__ out, int width, int d_pad,
                     int ndisp) {
  band::band_side_block<float, float, S, D>(
      anchor, other, width, FinalizedSide{out, d_pad, ndisp});
}

template <band::Side D, class S>
cudaError_t launch_side_f32(const void* anchor, const void* other,
                            void* out, int height, int width, int d_pad,
                            int ndisp, cudaStream_t s) {
  constexpr size_t kBytes = band::Layout<float, float, S>::kBytes;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      band_side_f32_kernel<D, S>, kBytes, shared_allowed);
  if (err != cudaSuccess) return err;
  band_side_f32_kernel<D, S>
      <<<band::side_grid<S>(height, width, d_pad), S::kThreads, kBytes, s>>>(
          static_cast<const float*>(anchor), static_cast<const float*>(other),
          static_cast<float*>(out), width, d_pad, ndisp);
  return cudaGetLastError();
}

// ---- bf16: mma.sync ----

constexpr int kMmaTileW = 64;                    // anchor columns per block
constexpr int kMmaThreads = 128;                 // one warp per 16 rows
constexpr int kMmaCtx = kMmaTileW + kChunkD;     // context columns (192)
constexpr int kRowPad = kChannels + 8;           // values per staged pixel
constexpr int kBandPad = kChunkD + 8;            // values per band row
constexpr int kNTiles = (16 + kChunkD) / 8;      // n-tiles per warp (18)
constexpr size_t kMmaSharedBytes =
    sizeof(__nv_bfloat16) *
    (kMmaTileW * kRowPad + kMmaCtx * kRowPad + kMmaTileW * kBandPad);

using mccnn::copy_async_16;

__device__ __forceinline__ unsigned load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// D (16 x 8, f32) += A (16 x 16, row-major) x B (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads)
band_side_bf16_kernel(const __nv_bfloat16* __restrict__ anchor,
                      const __nv_bfloat16* __restrict__ other,
                      __nv_bfloat16* __restrict__ out, int width, int d_pad,
                      int ndisp, int right) {
  extern __shared__ __align__(16) __nv_bfloat16 s_tiles[];
  __nv_bfloat16* s_anchor = s_tiles;                       // [64][72]
  __nv_bfloat16* s_ctx = s_anchor + kMmaTileW * kRowPad;   // [192][72]
  __nv_bfloat16* s_band = s_ctx + kMmaCtx * kRowPad;       // [64][136]

  const int w0 = blockIdx.x * kMmaTileW;
  const int d0 = blockIdx.z * kChunkD;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * width;
  constexpr int kGroups = kChunkD / 8;  // 16-byte runs per band row

  if (d0 >= ndisp) {  // the whole chunk is pad lanes
    const __nv_bfloat162 big = __float2bfloat162_rn(mccnn::kBigCost);
    const unsigned word = *reinterpret_cast<const unsigned*>(&big);
    const uint4 run = make_uint4(word, word, word, word);
    for (int e = tid; e < kMmaTileW * kGroups; e += kMmaThreads) {
      const int gw = w0 + e / kGroups;
      if (gw < width) {
        *reinterpret_cast<uint4*>(out + (row + gw) * d_pad + d0 +
                                  8 * (e % kGroups)) = run;
      }
    }
    return;
  }

  // context column x holds other-image column base + x: the left band reads
  // columns w - d (so its context starts 127 columns before the tile and
  // runs backwards in d), the right band w + d
  const int base = right ? w0 + d0 : w0 - d0 - (kChunkD - 1);
  constexpr int kPieces = kChannels / 8;  // 16-byte pieces per pixel
  for (int e = tid; e < (kMmaTileW + kMmaCtx) * kPieces; e += kMmaThreads) {
    const int piece = e % kPieces;
    const int x = e / kPieces;
    const bool is_anchor = x < kMmaTileW;
    const int gx = is_anchor ? w0 + x : base + x - kMmaTileW;
    const bool valid = gx >= 0 && gx < width;
    const __nv_bfloat16* src =
        (is_anchor ? anchor : other) +
        (valid ? (row + gx) * kChannels + 8 * piece : 0);
    // the context follows the anchor in shared memory, same row stride
    copy_async_16(s_anchor + x * kRowPad + 8 * piece, src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = tid % 32;
  const int m0 = (tid / 32) * 16;  // the warp's anchor rows
  const int g = lane / 4;          // fragment row (A, C) or column (B)
  const int t = lane % 4;
  unsigned a[kChannels / 16][4];
#pragma unroll
  for (int ks = 0; ks < kChannels / 16; ++ks) {
    const __nv_bfloat16* p = s_anchor + (m0 + g) * kRowPad + 16 * ks + 2 * t;
    a[ks][0] = load_u32(p);
    a[ks][1] = load_u32(p + 8 * kRowPad);
    a[ks][2] = load_u32(p + 8);
    a[ks][3] = load_u32(p + 8 * kRowPad + 8);
  }
  for (int nt = 0; nt < kNTiles; ++nt) {
    const int n0 = m0 + 8 * nt;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kChannels / 16; ++ks) {
      const __nv_bfloat16* q = s_ctx + (n0 + g) * kRowPad + 16 * ks + 2 * t;
      mma_bf16(c, a[ks], load_u32(q), load_u32(q + 8));
    }
    // c[i] = <anchor(wl), context(x)>: rows g and g + 8, columns 2 t, 2 t + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int wl = m0 + g + 8 * (i / 2);
      const int x = n0 + 2 * t + i % 2;
      const int dl = right ? x - wl : wl - x + (kChunkD - 1);
      if (dl >= 0 && dl < kChunkD) {
        const int gw = w0 + wl;
        const int d = d0 + dl;
        const int src = right ? gw + d : gw - d;
        // no correspondence: 0, the border fills overwrite it
        const float v = d >= ndisp ? mccnn::kBigCost
                        : (src < 0 || src >= width) ? 0.f
                                                    : -c[i];
        s_band[wl * kBandPad + dl] = __float2bfloat16_rn(v);
      }
    }
  }
  __syncwarp();  // the warp reads only the 16 band rows it scattered

  for (int e = lane; e < 16 * kGroups; e += 32) {
    const int wl = m0 + e / kGroups;
    const int gw = w0 + wl;
    if (gw < width) {
      *reinterpret_cast<uint4*>(out + (row + gw) * d_pad + d0 +
                                8 * (e % kGroups)) =
          *reinterpret_cast<const uint4*>(s_band + wl * kBandPad +
                                          8 * (e % kGroups));
    }
  }
}

}  // namespace

extern "C" int mccnn_band_side(const void* anchor, const void* other,
                               void* out, int height, int width, int channels,
                               int d_pad, int ndisp, int right, int bf16,
                               void* stream) {
  if (channels != kChannels || d_pad % kChunkD || height > 65535 ||
      !mccnn::aligned_16(anchor, other, out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    using S = SideTile;
    return static_cast<int>(
        right ? launch_side_f32<band::Side::kRight, S>(
                    anchor, other, out, height, width, d_pad, ndisp, s)
              : launch_side_f32<band::Side::kLeft, S>(
                    anchor, other, out, height, width, d_pad, ndisp, s));
  }
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      band_side_bf16_kernel, kMmaSharedBytes, shared_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kMmaTileW - 1) / kMmaTileW, height,
                  d_pad / kChunkD);
  band_side_bf16_kernel<<<grid, kMmaThreads, kMmaSharedBytes, s>>>(
      static_cast<const __nv_bfloat16*>(anchor),
      static_cast<const __nv_bfloat16*>(other),
      static_cast<__nv_bfloat16*>(out), width, d_pad, ndisp, right);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mccnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
