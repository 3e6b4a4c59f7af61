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
// with the plain sweep in mccnn_tpu_torch/ops/sgm.py value for value.
//
// What bounds it on this card. Not the arithmetic (about 16 instructions
// per element). A sweep has only as many independent fibres as the image has
// rows or columns (1000 or 1504 at half resolution: 8-12 warps per SM), and
// line n + 1 of a fibre cannot start before line n is done; with one line
// read ahead per warp, as the first port had it, the card keeps well under a
// megabyte in flight and each step waits on device memory (1.31 ms per
// sweep at 1000 x 1504 x 256 in bf16). With the ring below, the traffic
// bounds it: in the development loop (not kept), on an H100, a copy of the
// kernel that did no arithmetic took as long as the sweep and one that
// stored nothing far less, while deeper or shallower rings, 2 or 8 warps per
// block, 16-byte or streaming stores moved nothing. One read and one write
// of the volume is 0.46 ms at 3.35 TB/s; chip_smoke.py times the sweep.
//
// Design. One warp owns one perpendicular position's D-fibre and walks the
// sweep axis; lane l holds disparities [l R, l R + R) with R = D_pad / 32,
// so d +- 1 across lanes are two shuffles. Volumes are addressed as (H, W,
// D) for both orientations (vertical sweeps walk h, horizontal ones walk
// w), so no transposes are needed.
//
//   * A ring of kLines lines per warp in shared memory (kRingBytes of
//     volume: 16 lines in bf16 at D_pad 256, 8 in f32), filled by 16-byte
//     cp.async kLines - 1 lines ahead of the line being computed, one commit
//     group per line; a line's group is waited for (wait_group kLines - 1)
//     and made visible to the warp by __syncwarp. About 6-12 MB are in
//     flight across the card instead of 0.5-0.8.
//   * The penalty inputs ride in the same ring, so no global load is left
//     on the chain. The wrapper hands the kernel two padded planes: D1
//     (row pitch a multiple of 16) and D2 shifted by D_pad columns with
//     every out-of-range probe column set to "small" (row pitch a multiple
//     of 16, D_pad columns of margin on both sides), so a probe needs no
//     bounds test and every 16-byte copy stays inside the plane. A vertical
//     sweep reaches a new image row on every line: its slot holds the
//     16-byte-aligned window of D_pad + 16 D2 bytes that covers the line's
//     probe run and the 16-byte chunk of D1 that holds the pixel. A
//     horizontal sweep stays on one image row: its warp stages the row of
//     both planes once, with the first line's group. With a code volume (the
//     TPU kernel's own interface, sweep_pallas(volume, scale_u8): uint8
//     0 / 1 / 2 for the scales 1, 1 / Q1, 1 / Q2, sweep-leading (S, P, D))
//     the slot holds the line's D_pad code bytes instead.
//   * A shorter chain per line: min over d is a lane-local fminf over R
//     values and one __reduce_min_sync over an order-preserving u32 image
//     of the f32 bits, in place of five dependent xor-shuffles; it is taken,
//     with the two neighbour shuffles, before the line's data is waited for.
//     The three values of P1 s and of min L' + P2 s are formed once per line;
//     on the gradient planes D1 (one bit per line) narrows them to two and
//     D2 picks one per element, on codes the code picks one of three.
//
// The order of min over d is exact for non-NaN values; the reduction may
// pick -0 where the plain version's amin picks +0 (or the reverse) when a
// line's minimum is an exact zero, which can change the sign of a zero
// result and never a value. In place (vol_out == vol_in, the chained
// mode) a warp reads line n + kLines - 1 before it writes it (kLines - 1
// lines later, after the read's group has been waited for), and fibres are
// disjoint, so the prefetch adds no hazard; out of place (the paper mode)
// the first line is copied.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // fibres (one warp each) per block
constexpr int kRingBytes = 8192;   // volume bytes of one warp's ring
constexpr int kMaxLines = 16;      // lines per ring at most ...
constexpr int kMinLines = 4;       // ... and at least
constexpr int kChunk = 16;         // bytes per cp.async
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int R, bool kVertical, bool kCodes>
struct Ring {
  static constexpr int kDepth = 32 * R;  // D_pad
  static constexpr int kLineBytes = kDepth * static_cast<int>(sizeof(T));
  static constexpr int kLines =
      kRingBytes / kLineBytes > kMaxLines
          ? kMaxLines
          : (kRingBytes / kLineBytes < kMinLines ? kMinLines
                                                 : kRingBytes / kLineBytes);
  // a vertical sweep's D2 window: D_pad bytes from any column, aligned down
  static constexpr int kRunBytes = kDepth + kChunk;
  static constexpr int kPenaltyBytes =
      kCodes ? kDepth : (kVertical ? kRunBytes + kChunk : 0);
  static constexpr int kSlotBytes = kLineBytes + kPenaltyBytes;
  static_assert(kLineBytes % kChunk == 0 && kSlotBytes % kChunk == 0,
                "16-byte copies need 16-byte slots");
};

template <typename T, int R, bool kVertical, bool kCodes>
size_t warp_bytes(int pitch1, int pitch2) {
  using G = Ring<T, R, kVertical, kCodes>;
  return static_cast<size_t>(G::kLines) * G::kSlotBytes +
         (kVertical || kCodes ? 0 : pitch1 + pitch2);
}

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

// f32 bits -> u32 in the same order (negatives reversed below positives)
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the value of a three-way table at a penalty code 0 / 1 / 2
__device__ __forceinline__ float pick(unsigned code, float a, float b,
                                      float c) {
  return code == 0 ? a : (code == 1 ? b : c);
}

template <typename T, int R, bool kVertical, bool kCodes>
__global__ void __launch_bounds__(32 * kWarps)
sgm_sweep_kernel(const T* vol_in, T* vol_out,
                 const unsigned char* __restrict__ small_self,
                 const unsigned char* __restrict__ small_other,
                 const unsigned char* __restrict__ codes, int height,
                 int width, int pitch1, int pitch2, int forward,
                 int left_volume, int warp_stride, float p1_base,
                 float p2_base, float inv_q1, float inv_q2) {
  using G = Ring<T, R, kVertical, kCodes>;
  constexpr int D = G::kDepth;
  extern __shared__ __align__(16) unsigned char s_bytes[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  const int size = kVertical ? height : width;
  const int perp = kVertical ? width : height;
  if (p >= perp) return;  // uniform per warp
  unsigned char* ring = s_bytes + static_cast<size_t>(warp) * warp_stride;
  // a horizontal sweep's staged plane rows (image row p), after the ring
  const unsigned char* row1 = ring + G::kLines * G::kSlotBytes;
  const unsigned char* row2 = row1 + pitch1;
  const int step = forward ? 1 : -1;
  const int first = forward ? 0 : size - 1;

  auto pixel = [&](int line) -> size_t {
    return kVertical ? static_cast<size_t>(line) * width + p
                     : static_cast<size_t>(p) * width + line;
  };
  // column of the line's probe run in the D2 plane: the run of pixel w is
  // D2 columns w + D - d (left) or w + D + d (right), d in [0, D); a
  // vertical sweep's slot holds it from column `run_base` on
  auto run_base = [&]() { return (left_volume ? p + 1 : p + D) & ~15; };

  // request the n-th line of the sweep into `slot`
  auto request = [&](int n, int slot) {
    const int s = first + n * step;
    unsigned char* dst = ring + slot * G::kSlotBytes;
    const auto* src = reinterpret_cast<const unsigned char*>(
        vol_in + pixel(s) * D);
#pragma unroll
    for (int c = lane; c < G::kLineBytes / kChunk; c += 32) {
      mccnn::copy_async_16(dst + c * kChunk, src + c * kChunk, true);
    }
    dst += G::kLineBytes;
    if constexpr (kCodes) {
      // the code volume is sweep-leading: line s, position p, lane d
      const unsigned char* line =
          codes + (static_cast<size_t>(s) * perp + p) * D;
#pragma unroll
      for (int c = lane; c < D / kChunk; c += 32) {
        mccnn::copy_async_16(dst + c * kChunk, line + c * kChunk, true);
      }
    } else if constexpr (kVertical) {
      // image row s: the D2 window, then D1's chunk that holds column p
      const unsigned char* run =
          small_other + static_cast<size_t>(s) * pitch2 + run_base();
      const unsigned char* own =
          small_self + static_cast<size_t>(s) * pitch1 + (p & ~15);
#pragma unroll
      for (int c = lane; c <= G::kRunBytes / kChunk; c += 32) {
        mccnn::copy_async_16(dst + c * kChunk,
                             c < G::kRunBytes / kChunk ? run + c * kChunk
                                                       : own,
                             true);
      }
    }
  };

  // stage a horizontal sweep's plane rows with the first lines
  if constexpr (!kVertical && !kCodes) {
    const unsigned char* src1 = small_self + static_cast<size_t>(p) * pitch1;
    const unsigned char* src2 = small_other + static_cast<size_t>(p) * pitch2;
    unsigned char* dst1 = ring + G::kLines * G::kSlotBytes;
    for (int c = lane; c < pitch1 / kChunk; c += 32) {
      mccnn::copy_async_16(dst1 + c * kChunk, src1 + c * kChunk, true);
    }
    for (int c = lane; c < pitch2 / kChunk; c += 32) {
      mccnn::copy_async_16(dst1 + pitch1 + c * kChunk, src2 + c * kChunk,
                           true);
    }
  }
  for (int n = 0; n < G::kLines - 1; ++n) {
    if (n < size) request(n, n);
    commit_group();
  }
  // one more group per line: line n's group is complete once no more than
  // kLines - 1 are pending. Slot (n - 1) mod kLines is refilled only after
  // every lane has read it (the __syncwarp that opens a step).
  auto advance = [&](int n, int slot) {
    __syncwarp();
    const int ahead = n + G::kLines - 1;
    if (ahead < size) request(ahead, slot == 0 ? G::kLines - 1 : slot - 1);
    commit_group();
  };
  auto arrive = [&]() {
    wait_group<G::kLines - 1>();
    __syncwarp();
  };

  float prev[R];
  advance(0, 0);
  arrive();
  load_line<R>(reinterpret_cast<const T*>(ring) + lane * R, prev);
  if (vol_in != vol_out) {
    store_line<R>(vol_out + pixel(first) * D + lane * R, prev);
  }

  // the three values of P1 s for s = 1, 1 / Q1, 1 / Q2
  const float p1_of[3] = {p1_base, __fmul_rn(p1_base, inv_q1),
                          __fmul_rn(p1_base, inv_q2)};
  const float p2_of[3] = {p2_base, __fmul_rn(p2_base, inv_q1),
                          __fmul_rn(p2_base, inv_q2)};
  int slot = 1;
  for (int n = 1; n < size; ++n) {
    advance(n, slot);
    // min over d of the previous line, and its neighbours across lanes,
    // before this line's data is waited for
    float lane_min = prev[0];
#pragma unroll
    for (int i = 1; i < R; ++i) lane_min = fminf(lane_min, prev[i]);
    const float min_prev =
        unordered(__reduce_min_sync(kFull, ordered(lane_min)));
    const float below_in = __shfl_up_sync(kFull, prev[R - 1], 1);
    const float above_in = __shfl_down_sync(kFull, prev[0], 1);
    const float m2_of[3] = {__fadd_rn(min_prev, p2_of[0]),
                            __fadd_rn(min_prev, p2_of[1]),
                            __fadd_rn(min_prev, p2_of[2])};
    arrive();

    const int s = first + n * step;
    const unsigned char* data = ring + slot * G::kSlotBytes;
    float cur[R];
    load_line<R>(reinterpret_cast<const T*>(data) + lane * R, cur);
    const unsigned char* penalty = data + G::kLineBytes;
    // P1 s and min L' + P2 s of element i (codes 0, 1, 2: s = 1, 1 / Q1,
    // 1 / Q2; on the planes a small D1 leaves 1 or 1 / Q1 to D2, a large
    // one 1 / Q1 or 1 / Q2)
    float p1v[R], m2v[R];
    if constexpr (kCodes) {
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const unsigned word =
            *reinterpret_cast<const unsigned*>(penalty + lane * R + i);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned c = (word >> (8 * j)) & 0xffu;
          p1v[i + j] = pick(c, p1_of[0], p1_of[1], p1_of[2]);
          m2v[i + j] = pick(c, m2_of[0], m2_of[1], m2_of[2]);
        }
      }
    } else {
      const int w = kVertical ? p : s;
      // D1 at the pixel and the D2 run, indexed by D2 column
      const unsigned b1 = kVertical ? penalty[G::kRunBytes + (p & 15)]
                                    : row1[s];
      const unsigned char* run = kVertical ? penalty : row2;
      const int c0 = (left_volume ? w + D - lane * R : w + D + lane * R) -
                     (kVertical ? run_base() : 0);
      const float p1_small = b1 ? p1_of[0] : p1_of[1];
      const float p1_large = b1 ? p1_of[1] : p1_of[2];
      const float m2_small = b1 ? m2_of[0] : m2_of[1];
      const float m2_large = b1 ? m2_of[1] : m2_of[2];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const bool b2 = run[left_volume ? c0 - i : c0 + i] != 0;
        p1v[i] = b2 ? p1_small : p1_large;
        m2v[i] = b2 ? m2_small : m2_large;
      }
    }

    float out[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float below =
          i > 0 ? prev[i - 1] : (lane == 0 ? mccnn::kBigCost : below_in);
      const float above =
          i < R - 1 ? prev[i + 1] : (lane == 31 ? mccnn::kBigCost : above_in);
      const float neighbor = __fadd_rn(fminf(below, above), p1v[i]);
      const float candidate = fminf(fminf(prev[i], neighbor), m2v[i]);
      out[i] = __fsub_rn(__fadd_rn(cur[i], candidate), min_prev);
    }
    store_line<R>(vol_out + pixel(s) * D + lane * R, out);
#pragma unroll
    for (int i = 0; i < R; ++i) prev[i] = out[i];
    slot = slot + 1 == G::kLines ? 0 : slot + 1;
  }
}

template <typename T, int R, bool kVertical, bool kCodes>
cudaError_t launch_sweep(const void* vin, void* vout, const unsigned char* ss,
                         const unsigned char* so, const unsigned char* codes,
                         int height, int width, int pitch1, int pitch2,
                         int forward, int left_volume, float p1, float p2,
                         float iq1, float iq2, cudaStream_t s) {
  constexpr size_t kMax = mccnn::kMaxSharedBytes;
  static bool shared_allowed[mccnn::kMaxDevices];
  const cudaError_t err = mccnn::allow_shared_once(
      sgm_sweep_kernel<T, R, kVertical, kCodes>, kMax, shared_allowed);
  if (err != cudaSuccess) return err;
  const size_t per_warp = warp_bytes<T, R, kVertical, kCodes>(pitch1, pitch2);
  const int warps =
      static_cast<int>(per_warp * kWarps <= kMax ? kWarps : kMax / per_warp);
  if (warps == 0) return cudaErrorInvalidValue;  // a row beyond ~100k pixels
  const int fibres = kVertical ? width : height;
  const int blocks = (fibres + warps - 1) / warps;
  sgm_sweep_kernel<T, R, kVertical, kCodes>
      <<<blocks, 32 * warps, per_warp * warps, s>>>(
      static_cast<const T*>(vin), static_cast<T*>(vout), ss, so, codes,
      height, width, pitch1, pitch2, forward, left_volume,
      static_cast<int>(per_warp), p1, p2, iq1, iq2);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_mode(int vertical, bool coded, const void* vin, void* vout,
                        const unsigned char* ss, const unsigned char* so,
                        const unsigned char* codes, int height, int width,
                        int pitch1, int pitch2, int forward, int left_volume,
                        float p1, float p2, float iq1, float iq2,
                        cudaStream_t s) {
  if (vertical) {
    return coded ? launch_sweep<T, R, true, true>(
                       vin, vout, ss, so, codes, height, width, pitch1,
                       pitch2, forward, left_volume, p1, p2, iq1, iq2, s)
                 : launch_sweep<T, R, true, false>(
                       vin, vout, ss, so, codes, height, width, pitch1,
                       pitch2, forward, left_volume, p1, p2, iq1, iq2, s);
  }
  return coded ? launch_sweep<T, R, false, true>(
                     vin, vout, ss, so, codes, height, width, pitch1, pitch2,
                     forward, left_volume, p1, p2, iq1, iq2, s)
               : launch_sweep<T, R, false, false>(
                     vin, vout, ss, so, codes, height, width, pitch1, pitch2,
                     forward, left_volume, p1, p2, iq1, iq2, s);
}

template <typename T>
cudaError_t dispatch_depth(int d_pad, int vertical, bool coded,
                           const void* vin, void* vout,
                           const unsigned char* ss, const unsigned char* so,
                           const unsigned char* codes, int height, int width,
                           int pitch1, int pitch2, int forward,
                           int left_volume, float p1, float p2, float iq1,
                           float iq2, cudaStream_t s) {
  switch (d_pad) {
    case 128:
      return launch_mode<T, 4>(vertical, coded, vin, vout, ss, so, codes,
                               height, width, pitch1, pitch2, forward,
                               left_volume, p1, p2, iq1, iq2, s);
    case 256:
      return launch_mode<T, 8>(vertical, coded, vin, vout, ss, so, codes,
                               height, width, pitch1, pitch2, forward,
                               left_volume, p1, p2, iq1, iq2, s);
    case 384:
      return launch_mode<T, 12>(vertical, coded, vin, vout, ss, so, codes,
                                height, width, pitch1, pitch2, forward,
                                left_volume, p1, p2, iq1, iq2, s);
    case 512:
      return launch_mode<T, 16>(vertical, coded, vin, vout, ss, so, codes,
                                height, width, pitch1, pitch2, forward,
                                left_volume, p1, p2, iq1, iq2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// small_self: (H, pitch1) uint8 D1 plane; small_other: (H, pitch2) uint8 D2
// plane shifted by d_pad columns, out-of-range probe columns set (both
// planes' pitches multiples of 16; see ops/sgm.py::kernel_planes). With
// `codes` ((S, P, d_pad) uint8) the planes are not read.
extern "C" int mccnn_sgm_sweep(const void* vol_in, void* vol_out,
                               const void* small_self, const void* small_other,
                               const void* codes, int height, int width,
                               int d_pad, int vertical, int forward,
                               int left_volume, int pitch1, int pitch2,
                               float p1_base, float p2_base, float inv_q1,
                               float inv_q2, int bf16, void* stream) {
  const bool coded = codes != nullptr;
  if (height < 1 || width < 1 ||
      (!coded && (pitch1 < width || pitch1 % kChunk ||
                  pitch2 < width + 2 * d_pad || pitch2 % kChunk)) ||
      reinterpret_cast<size_t>(vol_in) % kChunk ||
      reinterpret_cast<size_t>(vol_out) % kChunk ||
      reinterpret_cast<size_t>(small_self) % kChunk ||
      reinterpret_cast<size_t>(small_other) % kChunk ||
      reinterpret_cast<size_t>(codes) % kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ss = static_cast<const unsigned char*>(small_self);
  const auto* so = static_cast<const unsigned char*>(small_other);
  const auto* cd = static_cast<const unsigned char*>(codes);
  return static_cast<int>(
      bf16 ? dispatch_depth<__nv_bfloat16>(
                 d_pad, vertical, coded, vol_in, vol_out, ss, so, cd, height,
                 width, pitch1, pitch2, forward, left_volume, p1_base,
                 p2_base, inv_q1, inv_q2, s)
           : dispatch_depth<float>(d_pad, vertical, coded, vol_in, vol_out,
                                   ss, so, cd, height, width, pitch1, pitch2,
                                   forward, left_volume, p1_base, p2_base,
                                   inv_q1, inv_q2, s));
}
