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
// Design. One block of 256 threads per (lane chunk, column tile, row tile);
// the lane chunk varies fastest over the grid. The element type does not
// matter to a copy, so the kernel moves 16-byte pieces: a pixel's chunk is
// tile_d x itemsize bytes, addressed by a pixel stride and a chunk stride in
// bytes (which is all that differs between the layouts). A whole window does
// not fit shared memory at the tile shapes of interest (64 x 64 x 128 lanes
// of bf16 is 1 MB), so the window streams through a ring of three stages of
// about 24 KB (runs of window pixels in row-major order) filled with
// cp.async: while stage g's centre pixels are written to the output, stages
// g + 1 and g + 2 are in flight. What stays behind from the TPU probe: the
// two-slot DMA buffers with their semaphores and the sequential grid.
//
// Bound: bytes, one read and one write of the volume. The window re-reads
// (1 + 32 / tile_h)(1 + 32 / tile_w) x the volume, mostly through L2.
#include "common.cuh"

namespace {

constexpr int kHalo = 16;
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPiece = 16;                 // bytes per cp.async
constexpr size_t kStageBytes = 24 * 1024;  // target size of one stage
constexpr size_t kMaxShared = 200 * 1024;

__device__ __forceinline__ void copy_async_16(void* shared,
                                              const void* global) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(global));
}

__global__ void __launch_bounds__(kThreads)
cbca_stream_kernel(const char* __restrict__ vol, char* __restrict__ out,
                   int height, int width, int tile_h, int tile_w,
                   int chunk_bytes, long long pixel_stride,
                   long long chunk_stride, int stage_pixels) {
  extern __shared__ __align__(16) char s_win[];
  const int span_h = tile_h + 2 * kHalo;
  const int span_w = tile_w + 2 * kHalo;
  const int pieces = chunk_bytes / kPiece;   // per pixel
  const int window = span_h * span_w;        // pixels, row-major
  const size_t stage_bytes = static_cast<size_t>(stage_pixels) * chunk_bytes;
  const int stages = (window + stage_pixels - 1) / stage_pixels;

  const long long chunk_at = blockIdx.x * chunk_stride;
  const int col0 = blockIdx.y * tile_w;
  const int row0 = blockIdx.z * tile_h;
  const int col_base = min(max(col0 - kHalo, 0), width - span_w);
  const int row_base = min(max(row0 - kHalo, 0), height - span_h);
  const int col_off = col0 - col_base;
  const int row_off = row0 - row_base;
  const int tid = threadIdx.x;

  // the device address of window pixel p's chunk, relative to the volume
  auto address = [&](int p) -> long long {
    const long long pix =
        static_cast<long long>(row_base + p / span_w) * width + col_base +
        p % span_w;
    return chunk_at + pix * pixel_stride;
  };
  auto prefetch = [&](int g) {
    if (g < stages) {
      char* stage = s_win + (g % kStages) * stage_bytes;
      const int first = g * stage_pixels;
      const int count = min(stage_pixels, window - first) * pieces;
      for (int e = tid; e < count; e += kThreads) {
        copy_async_16(stage + static_cast<size_t>(e) * kPiece,
                      vol + address(first + e / pieces) +
                          (e % pieces) * kPiece);
      }
    }
    // an empty group keeps the count of groups in flight uniform
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int g = 0; g < kStages - 1; ++g) prefetch(g);
  for (int g = 0; g < stages; ++g) {
    prefetch(g + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncthreads();
    const char* stage = s_win + (g % kStages) * stage_bytes;
    const int first = g * stage_pixels;
    const int count = min(stage_pixels, window - first) * pieces;
    for (int e = tid; e < count; e += kThreads) {
      const int p = first + e / pieces;
      const int y = p / span_w - row_off;
      const int x = p % span_w - col_off;
      if (y >= 0 && y < tile_h && x >= 0 && x < tile_w) {  // the centre tile
        *reinterpret_cast<uint4*>(out + address(p) + (e % pieces) * kPiece) =
            *reinterpret_cast<const uint4*>(
                stage + static_cast<size_t>(e) * kPiece);
      }
    }
    __syncthreads();  // before stage g's buffer is refilled
  }
}

}  // namespace

extern "C" int mccnn_cbca_stream(const void* vol_in, void* vol_out,
                                 int height, int width, int n_chunks,
                                 int tile_h, int tile_w, int chunk_bytes,
                                 long long pixel_stride,
                                 long long chunk_stride, void* stream) {
  const int span_h = tile_h + 2 * kHalo;
  const int span_w = tile_w + 2 * kHalo;
  if (tile_h < 1 || tile_w < 1 || n_chunks < 1 || chunk_bytes < kPiece ||
      chunk_bytes % kPiece || pixel_stride % kPiece || chunk_stride % kPiece ||
      height % tile_h || width % tile_w || height < span_h ||
      width < span_w || vol_in == vol_out || width / tile_w > 65535 ||
      height / tile_h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long stage_pixels = static_cast<long long>(kStageBytes) / chunk_bytes;
  if (stage_pixels < 1) stage_pixels = 1;
  if (stage_pixels > static_cast<long long>(span_h) * span_w) {
    stage_pixels = static_cast<long long>(span_h) * span_w;
  }
  const size_t shared = kStages * stage_pixels * chunk_bytes;
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cbca_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks, width / tile_w, height / tile_h);
  cbca_stream_kernel<<<grid, kThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(vol_in), static_cast<char*>(vol_out), height,
      width, tile_h, tile_w, chunk_bytes, pixel_stride, chunk_stride,
      static_cast<int>(stage_pixels));
  return static_cast<int>(cudaGetLastError());
}
