// K11: the border fill of one cost volume, in place, one launch a side.
//
// Replaces no TPU kernel: the JAX package runs the fills as an XLA
// lax.scan (mccnn_tpu/ops/cost_volume.py::_border_fill_left/_right), and
// the port ran them as ndisp - 1 dependent torch-op steps a side, seven
// device operations each in bf16, every one paced by the host. The
// recurrence, on an (H, W, D_pad) volume, for d = ndisp-1 .. 1:
//
//   left:  column d-1 takes, on lanes [d, ndisp), the mean of columns
//          d .. min(d+2, W-1)
//   right: column W-d takes, on lanes [d, ndisp), the mean of columns
//          max(W-d-3, 0) .. W-d-1
//
// Lane k is written only by the steps d <= k, and each step reads the same
// lane of the columns beside it, so every (row, lane) is an independent
// chain. Lane 0 and the lanes >= ndisp are never written.
//
// Design. One thread is one (row, lane k), 1 <= k < ndisp; a warp holds 32
// consecutive lanes of one row. A thread loads its first step's window of
// three columns once and keeps it in registers; the warp then walks the
// columns one step at a time (left from column ndisp-2 down to 0, right from
// column W-ndisp+1 up to W-1), a thread active where the step covers its
// lane. It stores the new value and shifts it into its window, so nothing is
// read back from memory and every store of a step goes to one column on
// consecutive lanes. No scratch memory.
//
// Rounding: that of ops/cost_volume.py::_fill_mean as torch runs it on the
// card, so the kernel equals the torch-op loop bit for bit. The sum of the
// `count` columns a, b, c in f32 from 0: (a + b) + c (torch's reduction
// over dim 1, one thread an output), but (a + c) + b at the first step,
// d = ndisp-1, whose slice is one lane wide (torch then reduces along the
// columns, two threads: a + c on one, b on the other); in bf16 that sum
// rounded to bf16 and widened back; then the product with the f32
// reciprocal of `count` (torch divides by a CPU scalar as a * (1 / b)),
// stored in the volume's type. `count` is 3, or fewer where the window is
// clipped at the image edge (W < ndisp + 2).
//
// Bound: the no-correspondence triangle, H x ndisp (ndisp - 1) / 2 values
// written once a side (41 MB in bf16 at 1024 x 1536, ndisp 200: 12 us at
// 3.35 TB/s; 327 MB at 2048 x 3072, ndisp 400: 98 us), and about a dozen
// instructions a value for a warp step.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// 1 / count in f32, correctly rounded, for the window sizes 1 to 3
__device__ __forceinline__ float inverse_count(int count) {
  return count == 3 ? 1.f / 3.f : (count == 2 ? 0.5f : 1.f);
}

template <typename T, bool kRight>
__global__ void __launch_bounds__(kThreads)
border_fill_kernel(T* __restrict__ volume, int height, int width, int d_pad,
                   int ndisp, int chunks) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int row = static_cast<int>(warp / chunks);
  const int lane0 = static_cast<int>(warp % chunks) * kWarp;
  const int k = lane0 + static_cast<int>(threadIdx.x % kWarp);
  if (row >= height || k < 1 || k >= ndisp) return;
  const int top = min(lane0 + kWarp - 1, ndisp - 1);  // the warp's first step
  T* const lane = volume + static_cast<size_t>(row) * width * d_pad + k;
  // window[i]: left, column d + i; right, column W - d - 3 + i; loaded for
  // this thread's first step, d = k (columns off the image stay unread)
  float window[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int col = kRight ? width - k - 3 + i : k + i;
    if (col >= 0 && col < width) {
      window[i] = mccnn::to_f32(lane[static_cast<size_t>(col) * d_pad]);
    }
  }
  // every thread of the warp takes every step, so a step's stores go to
  // one column together; a thread writes from its own lane's first step on
  for (int d = top; d >= 1; --d) {
    if (k < d) continue;
    const int count = min(3, width - d);
    const int first = kRight ? 3 - count : 0;  // the window's first column
    float total = 0.f;  // torch's reduction starts from 0
    if (d == ndisp - 1 && count == 3) {  // the one-lane slice: (a + c) + b
      total = __fadd_rn(__fadd_rn(__fadd_rn(total, window[0]), window[2]),
                        window[1]);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i >= first && i < first + count) {
          total = __fadd_rn(total, window[i]);
        }
      }
    }
    total = mccnn::to_f32(mccnn::from_f32<T>(total));
    const T value =
        mccnn::from_f32<T>(__fmul_rn(total, inverse_count(count)));
    const int col = kRight ? width - d : d - 1;
    lane[static_cast<size_t>(col) * d_pad] = value;
    if (kRight) {
      window[0] = window[1];
      window[1] = window[2];
      window[2] = mccnn::to_f32(value);
    } else {
      window[2] = window[1];
      window[1] = window[0];
      window[0] = mccnn::to_f32(value);
    }
  }
}

template <typename T>
cudaError_t launch_fill(void* volume, int height, int width, int d_pad,
                        int ndisp, bool right, cudaStream_t s) {
  const int chunks = (ndisp + kWarp - 1) / kWarp;
  const long long threads = static_cast<long long>(height) * chunks * kWarp;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  T* const v = static_cast<T*>(volume);
  if (right) {
    border_fill_kernel<T, true><<<blocks, kThreads, 0, s>>>(
        v, height, width, d_pad, ndisp, chunks);
  } else {
    border_fill_kernel<T, false><<<blocks, kThreads, 0, s>>>(
        v, height, width, d_pad, ndisp, chunks);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mccnn_border_fill(void* volume, int height, int width,
                                 int d_pad, int ndisp, int side, int is_bf16,
                                 void* stream) {
  if (height < 1 || ndisp < 2 || ndisp > width || ndisp > d_pad ||
      (side != 0 && side != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_fill<__nv_bfloat16>(volume, height, width, d_pad,
                                           ndisp, side == 1, s)
              : launch_fill<float>(volume, height, width, d_pad, ndisp,
                                   side == 1, s));
}
