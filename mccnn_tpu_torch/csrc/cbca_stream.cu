// K10: identity copy of a cost volume with a CBCA round kernel's traffic.
//
// Replaces tools/bench_cbca_stream.py::_stream_kernel, the probe that
// measures what a round's tiling costs with the arithmetic removed: per
// (tile_h x tile_w x tile_d) tile the haloed window ((tile_h + 2 x 16) x
// (tile_w + 2 x 16) x tile_d, bases clamped into the volume as in the TPU
// probe, so every tile reads a full window) goes into on-chip memory and the
// centre tile is written out. The output equals the input exactly. Two
// layouts: flat (H, W, D), where a pixel's tile_d lanes are one short run,
// and dsplit (D / tile_d, H, W, tile_d), where a window row is one long run.
//
// Design: the Tensor Memory Accelerator moves every byte. One warp per
// (lane chunk, column tile, row tile) block, the lane chunk fastest over the
// grid, so the next column tile's blocks find this strip's halo columns in
// L2; its first lane issues the copies and no thread moves data. The window
// is cut into boxes: bands of `rows` rows (a divisor of tile_h and of 16, so
// a band lies wholly in the halo rows or wholly in the centre rows), each
// band cut into halo boxes of `halo_cols` (<= 16) columns left and right of
// the centre and centre boxes of `centre_cols` columns (a divisor of
// tile_w). Halo boxes start at the window's left edge or end at its right
// edge, so they may overlap the centre where the halo is not a multiple of
// their width: that costs bytes, not the copy. Each box is loaded by
// cp.async.bulk.tensor into one slot of a ring of kStages slots, completed
// on the slot's mbarrier (expect_tx); a centre box of a centre band is
// written back from its slot by a bulk tensor store, and a slot is refilled
// once the store that reads it has read it (bulk_group wait). The maps see
// the volume as 32-bit words in five dimensions, innermost first. TMA
// requests memory one run of the first dimension at a time, so that
// dimension is made as long as the layout allows: where a pixel is one
// chunk (dsplit, or flat with one chunk) a window row is one run and the
// maps are (W x chunk words, 1, 1, H, chunks), a box's columns and lanes in
// its first dimension ("row runs"); flat with several chunks is (words of a
// piece, pieces of a pixel, W, H, 1), chunk c's pieces at c x (pieces of a
// chunk) along dimension 1, each pixel's chunk a run of its own (K2's
// tiling: 32 bytes). Boxes shrink (rows, then columns, then pieces) until
// the larger fits kSlotBytes, and every box dimension stays within TMA's
// 256. The tensor maps are encoded per launch through the driver's entry
// point (cudaGetDriverEntryPoint), so nothing links libcuda.
// What stays behind from the TPU probe: the two-slot DMA buffers with their
// semaphores and the sequential grid.
//
// Bound: bytes, one read and one write of the volume. The window re-reads
// (1 + 32 / tile_h)(1 + 32 / tile_w) x the volume, mostly through L2.
#include <cuda.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kHalo = 16;
constexpr int kThreads = 32;  // one warp; its first lane issues every copy
#ifdef MCCNN_STREAM_STAGES
constexpr int kStages = MCCNN_STREAM_STAGES;
#else
constexpr int kStages = 8;  // ring slots, each one box
#endif
#ifdef MCCNN_STREAM_SLOT_BYTES
constexpr int kSlotBytes = MCCNN_STREAM_SLOT_BYTES;
#else
constexpr int kSlotBytes = 16384;  // the largest box
#endif
#ifdef MCCNN_STREAM_PROMOTION
constexpr int kPromotion = MCCNN_STREAM_PROMOTION;
#else
constexpr int kPromotion = 2;  // CUtensorMapL2promotion: 0 none ... 3 256 B
#endif
#ifdef MCCNN_STREAM_ROW_RUNS
constexpr int kRowRuns = MCCNN_STREAM_ROW_RUNS;
#else
constexpr int kRowRuns = 1;  // 0: one run per pixel's chunk in every layout
#endif
constexpr int kMaxBox = 256;    // TMA: elements per box dimension
constexpr int kWord = 4;        // bytes per map element
constexpr int kSlotAlign = 128; // TMA: shared-memory box address

// One launch's boxes, chosen on the host (make_plan) and walked by every
// block.
struct Plan {
  int height, width, tile_h, tile_w;
  int rows;             // rows of every box
  int centre_cols;      // columns of a centre box
  int halo_cols;        // columns of a halo box
  int pieces;           // pieces of a box along its chunk
  int chunk_boxes;      // boxes across one pixel's chunk
  int col_words;        // dimension-0 coordinate of column x: x x this
  int col_step;         // dimension-2 coordinate of column x: x x this
  int chunk_step_flat;  // dimension-1 offset of chunk c: c x this (flat)
  int chunk_step_split; // dimension-4 offset of chunk c: c x this (dsplit)
  unsigned centre_bytes, halo_bytes;
  int slot_bytes;
};

struct Box {
  int c0, c1, c2, c3;  // map coordinates; the fifth is the block's chunk
  bool centre;         // a centre-column box (else a halo box)
  bool stored;         // a centre box in a centre band
};

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long map_address(
    const CUtensorMap* map) {
  return reinterpret_cast<unsigned long long>(map);
}

__device__ __forceinline__ void wait_full(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box from global into a slot, counted on the slot's barrier.
__device__ __forceinline__ void load_box(const CUtensorMap* map,
                                         unsigned slot, unsigned bar,
                                         unsigned bytes, const Box& b,
                                         int chunk) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(slot),
      "l"(map_address(map)), "r"(b.c0), "r"(b.c1), "r"(b.c2), "r"(b.c3),
      "r"(chunk), "r"(bar)
      : "memory");
}

// A box from a slot to global, as its own bulk group.
__device__ __forceinline__ void store_box(const CUtensorMap* map,
                                          unsigned slot, const Box& b,
                                          int chunk) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(map_address(map)),
      "r"(slot), "r"(b.c0), "r"(b.c1), "r"(b.c2), "r"(b.c3), "r"(chunk)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the `Pending` newest stores have read their slots.
template <int Pending>
__device__ __forceinline__ void stores_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(Pending)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
cbca_stream_kernel(const __grid_constant__ CUtensorMap in_centre,
                   const __grid_constant__ CUtensorMap in_halo,
                   const __grid_constant__ CUtensorMap out_centre,
                   const Plan plan) {
  extern __shared__ unsigned char s_raw[];
  __shared__ __align__(8) unsigned long long s_full[kStages];
  if (threadIdx.x != 0) return;

  const unsigned ring =
      (shared_address(s_raw) + kSlotAlign - 1) & ~(kSlotAlign - 1u);
  const int span_h = plan.tile_h + 2 * kHalo;
  const int span_w = plan.tile_w + 2 * kHalo;
  const int chunk = blockIdx.x;
  const int col0 = blockIdx.y * plan.tile_w;
  const int row0 = blockIdx.z * plan.tile_h;
  const int col_base = min(max(col0 - kHalo, 0), plan.width - span_w);
  const int row_base = min(max(row0 - kHalo, 0), plan.height - span_h);
  const int col_end = col_base + span_w;
  const int hc = plan.halo_cols;
  const int n_left = (col0 - col_base + hc - 1) / hc;
  const int n_centre = plan.tile_w / plan.centre_cols;
  const int n_cols =
      n_left + n_centre + (col_end - col0 - plan.tile_w + hc - 1) / hc;
  const int per_band = n_cols * plan.chunk_boxes;
  const int count = span_h / plan.rows * per_band;
  const int piece0 = chunk * plan.chunk_step_flat;
  const int chunk4 = chunk * plan.chunk_step_split;

  // box n of the window: bands top to bottom, columns left to right, the
  // chunk's pieces innermost
  auto box_at = [&](int n) {
    Box b;
    const int band = n / per_band;
    const int rest = n - band * per_band;
    const int col = rest / plan.chunk_boxes;
    const int y = row_base + band * plan.rows;
    int x;
    b.centre = col >= n_left && col < n_left + n_centre;
    if (col < n_left) {
      x = max(min(col_base + col * hc, col0 - hc), col_base);
    } else if (b.centre) {
      x = col0 + (col - n_left) * plan.centre_cols;
    } else {
      x = min(col0 + plan.tile_w + (col - n_left - n_centre) * hc,
              col_end - hc);
    }
    b.c0 = x * plan.col_words;
    b.c1 = piece0 + (rest - col * plan.chunk_boxes) * plan.pieces;
    b.c2 = x * plan.col_step;
    b.c3 = y;
    b.stored = b.centre && y >= row0 && y < row0 + plan.tile_h;
    return b;
  };
  auto issue = [&](int n) {
    const Box b = box_at(n);
    const int slot = n % kStages;
    load_box(b.centre ? &in_centre : &in_halo, ring + slot * plan.slot_bytes,
             shared_address(&s_full[slot]),
             b.centre ? plan.centre_bytes : plan.halo_bytes, b, chunk4);
  };

  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     shared_address(&s_full[s])),
                 "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int n = 0; n < min(kStages, count); ++n) issue(n);
  bool stored_last = false;
  for (int n = 0; n < count; ++n) {
    const int slot = n % kStages;
    wait_full(shared_address(&s_full[slot]), (n / kStages) & 1);
    const Box b = box_at(n);
    if (b.stored) {
      store_box(&out_centre, ring + slot * plan.slot_bytes, b, chunk4);
    }
    // refill the slot of box n - 1 once its store (if any) has read it;
    // box n's store may still be reading its own slot
    if (n > 0 && n - 1 + kStages < count) {
      if (stored_last) {
        if (b.stored) {
          stores_read<1>();
        } else {
          stores_read<0>();
        }
      }
      issue(n - 1 + kStages);
    }
    stored_last = b.stored;
  }
  stores_read<0>();  // the ring lives as long as the block
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The largest divisor of n that is at most cap and a multiple of step (n is
// one); step if there is none larger.
int divisor_at_most(int n, int cap, int step) {
  for (int d = std::min(n, cap) / step * step; d > step; d -= step) {
    if (n % d == 0) return d;
  }
  return step;
}

// col_cap: the most columns a box may hold (TMA's 256 elements of its first
// dimension, which holds them with the chunk's words where rows are runs)
Plan make_plan(int height, int width, int tile_h, int tile_w, int words,
               int piece_words, int col_cap) {
  Plan p{};
  p.height = height;
  p.width = width;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  const int chunk_pieces = words / piece_words;
  p.rows = gcd(tile_h, kHalo);
  p.centre_cols = divisor_at_most(tile_w, col_cap, 1);
  p.halo_cols = std::min(kHalo, col_cap);
  p.pieces = divisor_at_most(chunk_pieces, kMaxBox, 1);
  auto bytes = [&](int cols) {
    return static_cast<long long>(kWord) * piece_words * p.pieces * cols *
           p.rows;
  };
  while (std::max(bytes(p.centre_cols), bytes(p.halo_cols)) > kSlotBytes) {
    if (p.rows > 1) {
      p.rows /= 2;
    } else if (p.centre_cols > 1 && p.centre_cols >= p.halo_cols) {
      p.centre_cols = divisor_at_most(tile_w, p.centre_cols - 1, 1);
    } else if (p.halo_cols > 1) {
      p.halo_cols /= 2;
    } else if (p.pieces > 1) {
      p.pieces = divisor_at_most(chunk_pieces, p.pieces - 1, 1);
    } else {
      break;  // one piece of one pixel: at most 1 KB, which always fits
    }
  }
  p.chunk_boxes = chunk_pieces / p.pieces;
  p.centre_bytes = static_cast<unsigned>(bytes(p.centre_cols));
  p.halo_bytes = static_cast<unsigned>(bytes(p.halo_cols));
  p.slot_bytes = static_cast<int>(
      (std::max(p.centre_bytes, p.halo_bytes) + kSlotAlign - 1) /
      kSlotAlign * kSlotAlign);
  return p;
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, looked up once.
cudaError_t tensor_map_encoder(EncodeTiled* encode) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(fn);
  }
  *encode = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" int mccnn_cbca_stream(const void* vol_in, void* vol_out,
                                 int height, int width, int n_chunks,
                                 int tile_h, int tile_w, int chunk_bytes,
                                 long long pixel_stride,
                                 long long chunk_stride, void* stream) {
  const int span_h = tile_h + 2 * kHalo;
  const int span_w = tile_w + 2 * kHalo;
  constexpr int kPiece = 16;  // bytes: a chunk's and a stride's multiple
  if (tile_h < 1 || tile_w < 1 || n_chunks < 1 || chunk_bytes < kPiece ||
      chunk_bytes % kPiece || pixel_stride % kPiece || chunk_stride % kPiece ||
      height % tile_h || width % tile_w || height < span_h ||
      width < span_w || vol_in == vol_out || width / tile_w > 65535 ||
      height / tile_h > 65535 || !mccnn::aligned_16(vol_in, vol_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = chunk_bytes / kWord;
  // flat: a pixel's chunks side by side; dsplit: chunk planes. Where a
  // pixel is one chunk, a window row is one run (row runs).
  const bool flat = chunk_stride == chunk_bytes;
  const bool row_runs =
      kRowRuns && pixel_stride == chunk_bytes && words <= kMaxBox;
  const int piece_words =
      row_runs ? words : divisor_at_most(words, kMaxBox, kPiece / kWord);
  if (flat && pixel_stride % (kWord * piece_words)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan = make_plan(height, width, tile_h, tile_w, words, piece_words,
                        row_runs ? kMaxBox / words : kMaxBox);
  plan.col_words = row_runs ? words : 0;
  plan.col_step = row_runs ? 0 : 1;
  plan.chunk_step_flat = flat && !row_runs ? words / piece_words : 0;
  plan.chunk_step_split = flat ? 0 : 1;

  EncodeTiled encode = nullptr;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cuuint64_t row = static_cast<cuuint64_t>(pixel_stride) * width;
  const cuuint64_t chunks = flat ? 1 : n_chunks;
  const cuuint64_t plane = flat ? row * height : chunk_stride;
  // row runs: (W x words, 1, 1, H, chunks); else (piece words, pieces, W,
  // H, chunks)
  const cuuint64_t dims[5] = {
      row_runs ? static_cast<cuuint64_t>(width) * words
               : static_cast<cuuint64_t>(piece_words),
      row_runs ? 1
               : static_cast<cuuint64_t>(flat ? pixel_stride /
                                                    (kWord * piece_words)
                                              : words / piece_words),
      row_runs ? 1 : static_cast<cuuint64_t>(width),
      static_cast<cuuint64_t>(height), chunks};
  const cuuint64_t strides[4] = {
      row_runs ? row : static_cast<cuuint64_t>(kWord * piece_words),
      row_runs ? row : static_cast<cuuint64_t>(pixel_stride), row, plane};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  auto make_map = [&](CUtensorMap* map, const void* base, int cols) {
    const cuuint32_t box[5] = {
        static_cast<cuuint32_t>(row_runs ? cols * words : piece_words),
        static_cast<cuuint32_t>(plan.pieces),
        static_cast<cuuint32_t>(row_runs ? 1 : cols),
        static_cast<cuuint32_t>(plan.rows), 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 5,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  static_cast<CUtensorMapL2promotion>(kPromotion),
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  CUtensorMap in_centre, in_halo, out_centre;
  if (!make_map(&in_centre, vol_in, plan.centre_cols) ||
      !make_map(&in_halo, vol_in, plan.halo_cols) ||
      !make_map(&out_centre, vol_out, plan.centre_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  constexpr size_t kMaxShared = kStages * kSlotBytes + kSlotAlign;
  static_assert(kMaxShared <= mccnn::kMaxSharedBytes,
                "the ring must fit one block's shared memory");
  static bool shared_allowed[mccnn::kMaxDevices];
  err = mccnn::allow_shared_once(cbca_stream_kernel, kMaxShared,
                                 shared_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks, width / tile_w, height / tile_h);
  cbca_stream_kernel<<<grid, kThreads,
                       kStages * plan.slot_bytes + kSlotAlign,
                       static_cast<cudaStream_t>(stream)>>>(
      in_centre, in_halo, out_centre, plan);
  return static_cast<int>(cudaGetLastError());
}
