// K3: one semi-global-matching (SGM) directional sweep.
//
// Replaces mccnn_tpu/ops/sgm_pallas.py::_sweep_kernel (+ _dp_chunk) and the
// XLA scan it mirrors, mccnn_tpu/ops/sgm.py::_sweep. Per line along the
// sweep, for every position p and disparity d:
//
//   L(d) = (C(d) + min(L'(d), min(L'(d-1), L'(d+1)) + P1 s, min L' + P2 s))
//          - min L'
//
// where L' is the previous line (kept in f32 registers, never re-read from
// the storage volume), L'(-1) = L'(D_pad) = BIG_COST, and the penalty scale
// s is 1, 1/Q1 or 1/Q2 when both, one or neither of the gradient tests are
// small: D1 from the sweep image's plane at the pixel itself, D2 from the
// other image's plane at column w - d (left volume) or w + d (right volume),
// an out-of-range probe counting as small. The first line is kept. The sum
// keeps JAX's association (cur + candidate) - min_prev, and the products
// use __fmul_rn so no FMA contraction changes a rounding: the kernel agrees
// bit for bit with the plain sweep in mccnn_tpu_torch/ops/sgm.py.
//
// Design. One warp owns one perpendicular position's D-fibre and walks the
// sweep axis sequentially; lane l holds disparities [l R, l R + R) with
// R = D_pad / 32, so a line is one contiguous, vectorized 32 x R-element
// read and write per warp. d +- 1 across lanes come from two shuffles and
// min_d from a 5-step xor-shuffle reduction. Volumes are addressed as
// (H, W, D) for both orientations (vertical sweeps walk h, horizontal ones
// walk w), so no transposes are needed. The next line is loaded before the
// current one is computed, to keep a read in flight. The penalty planes are
// (H, W) uint8 masks; no (H, W, D) penalty volume is built. With a code
// volume (the TPU kernel's own interface, sweep_pallas(volume, scale_u8):
// uint8 0 / 1 / 2 for the scales 1, 1 / Q1, 1 / Q2, in the sweep-leading
// (S, P, D) layout) the kernel reads one byte per element instead of
// deriving the scale from the two planes; the result is the same. In place
// (vol_out == vol_in) for the chained mode; out of place (the first line
// copied) for the paper mode.
//
// Bound: latency of the sequential line chain. A half-resolution sweep has
// only 1000 or 1504 fibres (one warp each, 8-11 warps per SM), so each
// line step waits on its global read; the arithmetic is ~20 f32 ops per
// element. Several lines in flight per warp (deeper prefetch) or fibres
// split across a block's warps is the later work.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int R>
__device__ __forceinline__ void load_line(const float* p, float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x;
    v[i + 1] = q.y;
    v[i + 2] = q.z;
    v[i + 3] = q.w;
  }
}

template <int R>
__device__ __forceinline__ void load_line(const __nv_bfloat16* p,
                                          float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = b.x;
    v[i + 3] = b.y;
  }
}

template <int R>
__device__ __forceinline__ void store_line(float* p, const float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int R>
__device__ __forceinline__ void store_line(__nv_bfloat16* p,
                                           const float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[i], v[i + 1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[i + 2], v[i + 3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p + i) = q;
  }
}

// R penalty codes of one lane, four to a 32-bit word
template <int R>
__device__ __forceinline__ void load_codes(const unsigned char* p,
                                           unsigned (&c)[R / 4]) {
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    c[i] = *reinterpret_cast<const unsigned*>(p + 4 * i);
  }
}

template <typename T, int R, bool kCodes>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sgm_sweep_kernel(const T* vol_in, T* vol_out,
                 const unsigned char* __restrict__ small_self,
                 const unsigned char* __restrict__ small_other,
                 const unsigned char* __restrict__ codes, int height,
                 int width, int vertical, int forward, int left_volume,
                 int oor_lo, int oor_hi, float p1_base, float p2_base,
                 float inv_q1, float inv_q2) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int size = vertical ? height : width;
  const int perp = vertical ? width : height;
  if (p >= perp) return;  // uniform per warp
  const int d_pad = 32 * R;
  const int step = forward ? 1 : -1;

  int s = forward ? 0 : size - 1;
  auto pixel = [&](int line) -> size_t {
    return vertical ? static_cast<size_t>(line) * width + p
                    : static_cast<size_t>(p) * width + line;
  };

  float prev[R];
  load_line<R>(vol_in + pixel(s) * d_pad + lane * R, prev);
  if (vol_in != vol_out) store_line<R>(vol_out + pixel(s) * d_pad + lane * R, prev);

  float cur[R];
  if (size > 1) load_line<R>(vol_in + pixel(s + step) * d_pad + lane * R, cur);
  // the code volume is sweep-leading: line s, position p, lane d
  auto codes_at = [&](int line) -> const unsigned char* {
    return codes + (static_cast<size_t>(line) * perp + p) * d_pad + lane * R;
  };
  unsigned code[R / 4] = {};
  if (kCodes && size > 1) load_codes<R>(codes_at(s + step), code);

  for (int n = 1; n < size; ++n) {
    s += step;
    const size_t pix = pixel(s);
    float next[R] = {};
    unsigned code_next[R / 4] = {};
    if (n + 1 < size) {
      load_line<R>(vol_in + pixel(s + step) * d_pad + lane * R, next);
      if (kCodes) load_codes<R>(codes_at(s + step), code_next);
    }
    const int w = vertical ? p : s;
    const size_t row = pix - w;  // h * width
    const bool b1 = kCodes ? false : small_self[pix] != 0;

    float min_prev = prev[0];
#pragma unroll
    for (int i = 1; i < R; ++i) min_prev = fminf(min_prev, prev[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      min_prev = fminf(min_prev, __shfl_xor_sync(kFull, min_prev, o));
    }
    const float below_in = __shfl_up_sync(kFull, prev[R - 1], 1);
    const float above_in = __shfl_down_sync(kFull, prev[0], 1);

    float out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float scale;
      if (kCodes) {
        const unsigned c = (code[i / 4] >> (8 * (i % 4))) & 0xffu;
        scale = c == 0 ? 1.f : (c == 1 ? inv_q1 : inv_q2);
      } else {
        const int d = lane * R + i;
        const int probe = left_volume ? w - d : w + d;
        const bool oor = left_volume ? probe < oor_lo : probe >= oor_hi;
        const bool b2 = oor || small_other[row + probe] != 0;
        scale = (b1 && b2) ? 1.f : ((b1 || b2) ? inv_q1 : inv_q2);
      }
      const float p1 = __fmul_rn(p1_base, scale);
      const float p2 = __fmul_rn(p2_base, scale);
      const float below =
          i > 0 ? prev[i - 1] : (lane == 0 ? mccnn::kBigCost : below_in);
      const float above =
          i < R - 1 ? prev[i + 1] : (lane == 31 ? mccnn::kBigCost : above_in);
      const float neighbor = __fadd_rn(fminf(below, above), p1);
      const float candidate =
          fminf(fminf(prev[i], neighbor), __fadd_rn(min_prev, p2));
      out[i] = __fsub_rn(__fadd_rn(cur[i], candidate), min_prev);
    }
    store_line<R>(vol_out + pix * d_pad + lane * R, out);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      prev[i] = out[i];
      cur[i] = next[i];
    }
#pragma unroll
    for (int i = 0; i < R / 4; ++i) code[i] = code_next[i];
  }
}

template <typename T, int R>
void launch_sweep(const void* vin, void* vout, const unsigned char* ss,
                  const unsigned char* so, const unsigned char* codes,
                  int height, int width, int vertical,
                  int forward, int left_volume, int oor_lo, int oor_hi,
                  float p1, float p2, float iq1, float iq2, cudaStream_t s) {
  const int fibres = vertical ? width : height;
  const int blocks = (fibres + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (codes) {
    sgm_sweep_kernel<T, R, true><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const T*>(vin), static_cast<T*>(vout), ss, so, codes,
        height, width, vertical, forward, left_volume, oor_lo, oor_hi, p1, p2,
        iq1, iq2);
  } else {
    sgm_sweep_kernel<T, R, false><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const T*>(vin), static_cast<T*>(vout), ss, so, codes,
        height, width, vertical, forward, left_volume, oor_lo, oor_hi, p1, p2,
        iq1, iq2);
  }
}

template <typename T>
int dispatch_depth(int d_pad, const void* vin, void* vout,
                   const unsigned char* ss, const unsigned char* so,
                   const unsigned char* codes, int height, int width,
                   int vertical, int forward, int left_volume, int oor_lo,
                   int oor_hi, float p1, float p2,
                   float iq1, float iq2, cudaStream_t s) {
  switch (d_pad) {
    case 128:
      launch_sweep<T, 4>(vin, vout, ss, so, codes, height, width,
                         vertical, forward, left_volume, oor_lo, oor_hi,
                         p1, p2, iq1, iq2, s);
      return 0;
    case 256:
      launch_sweep<T, 8>(vin, vout, ss, so, codes, height, width,
                         vertical, forward, left_volume, oor_lo, oor_hi,
                         p1, p2, iq1, iq2, s);
      return 0;
    case 384:
      launch_sweep<T, 12>(vin, vout, ss, so, codes, height, width,
                         vertical, forward, left_volume, oor_lo, oor_hi,
                         p1, p2, iq1, iq2, s);
      return 0;
    case 512:
      launch_sweep<T, 16>(vin, vout, ss, so, codes, height, width,
                         vertical, forward, left_volume, oor_lo, oor_hi,
                         p1, p2, iq1, iq2, s);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mccnn_sgm_sweep(const void* vol_in, void* vol_out,
                               const void* small_self, const void* small_other,
                               const void* codes, int height, int width,
                               int d_pad, int vertical, int forward,
                               int left_volume, int oor_lo,
                               int oor_hi, float p1_base, float p2_base,
                               float inv_q1, float inv_q2, int bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ss = static_cast<const unsigned char*>(small_self);
  const auto* so = static_cast<const unsigned char*>(small_other);
  const auto* cd = static_cast<const unsigned char*>(codes);
  const int rc = bf16
      ? dispatch_depth<__nv_bfloat16>(d_pad, vol_in, vol_out, ss, so, cd,
                                      height, width, vertical, forward,
                                      left_volume,
                                      oor_lo, oor_hi, p1_base, p2_base, inv_q1,
                                      inv_q2, s)
      : dispatch_depth<float>(d_pad, vol_in, vol_out, ss, so, cd, height,
                              width, vertical, forward, left_volume, oor_lo,
                              oor_hi,
                              p1_base, p2_base, inv_q1, inv_q2, s);
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
