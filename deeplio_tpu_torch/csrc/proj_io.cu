// The projection's prologue and epilogue for Hopper (sm_90a), plain C
// interface: the elementwise work around the two selection kernels
// (ring_project.cu, proj_scatter.cu), on the packed-f16 routes.
//
// It replaces no Pallas kernel. In the JAX package this work is XLA, which
// fuses it into a few loops around each pallas_call:
//
//   prologue   deeplio_tpu/ops/projection_pallas.py:104-114 (scatter keys
//              and packed words), projection_pallas_ring.py:489-513 (ring
//              pixels, the pure-tail rule, keys and packed words), and
//              projection.py's spherical_uv_planes under both;
//   epilogue   projection_pallas.py:149-158 and projection_pallas_ring.py:
//              591-601 (mask, f16 unpack, depth from the quantized range),
//              then make_projector's channel stack, normalisation and cast.
//
// In the port the same code ran as some sixty PyTorch launches a
// projection. Here it is three launches (prologue, selection, epilogue),
// four on the ring route, whose pure-tail flag is a reduction over each
// scan (below).
//
// Prologue (prologue_kernel<kRing>), one thread per point, kItems points a
// thread kThreads apart, so each load of a plane is coalesced. Per point:
//   r = sqrt(x*x + y*y + z*z), yaw = atan2(y, x),
//   pitch = asin(clamp(z / max(r, 1e-9), -1, 1)),
//   u = clamp(int(floor(0.5 * (1 - yaw * (1/pi)) * W)), 0, W-1),
//   v = clamp(int(floor((1 - (pitch - fov_down) * (1/fov)) * H)), 0, H-1),
//   ok = valid && r > 1e-6, rq = int(min(r * rq_scale, rq_max - 1));
//   scatter: key = ok ? (v*W + u) << rq_bits | max(rq, 0) : INT32_MAX
//            (projection_scatter.py::scatter_keys);
//   ring:    pix = ok ? v*W + u : (pure ? n_pix : -1),
//            key = (ok ? max(rq, 0) : rq_max) << idx_bits | i
//            (projection_ring.py::ring_keys);
//   p1 = f16(x) | f16(y) << 16, p2 = f16(z) | f16(rem) << 16.
// The ring's pure-tail flag (no valid point follows an invalid one) is a
// reduction over the scan, so a pre-pass (pure_tail_kernel) writes one
// flag per (scan, chunk of kChunk points), "some valid point in this chunk
// follows an invalid one", recomputing `ok` of the point before the chunk;
// each CTA of the main pass ORs its scan's flags. No read to the host, no
// fill: every flag is written by the pre-pass, and the sequence captures in
// a CUDA graph.
//
// Epilogue (epilogue_kernel<kRing, kNorm, Out>), one thread per pixel,
// the CTA's image staged in shared memory and stored as 16-byte words:
//   scatter: m = key != INT32_MAX, rq = key & rq_max;
//   ring:    rq = key >> idx_bits, m = key != INT32_MAX && rq < rq_max;
//   the five values x, y, z, rem (the f16 halves) and depth = float(rq) *
//   float32(1/rq_scale), each times m (the plain epilogue's img5); then for
//   each configured channel c: (v*m - mean[c]) / std[c] * m with mean and
//   std, else v*m*m (make_projector's second mask product, which leaves
//   every bit of v*m as it is), in float32, bfloat16 or float16; and m.
//
// Bit for bit against PyTorch's CUDA ops (the plain versions): every float
// operation is the intrinsic of one rounding (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn), in PyTorch's order, so nvcc's FMA
// contraction cannot merge two of them. PyTorch divides a tensor by a
// Python scalar as a multiply by the scalar's float32 reciprocal
// (div_true_kernel_cuda), so yaw / pi and (pitch - fov_down) / fov are
// multiplies by reciprocals the host computes in float32; z / r and
// (v - mean) / std are true divisions. atan2f, asinf, floorf and the
// float-to-int (round toward zero), float-to-half and float-to-bfloat16
// (round to nearest even) conversions are those PyTorch's kernels call. A
// clamp keeps NaN, as torch.clamp does; the mask is a product, so a NaN
// payload on a landed, valid pixel stays NaN. Never build with
// --use_fast_math.
//
// What bounds them on the card: bytes. Per point the prologue reads 17 B
// (four float32 planes and the valid byte) and writes 12 B (scatter) or
// 16 B (ring); the ring's pre-pass reads the planes' x, y, z and valid
// again (13 B) and writes a flag per 1024 points. Per pixel the epilogue
// reads 12 B and writes 4 * C + 4 B in float32, 2 * C + 4 B in bfloat16 or
// float16. At training's B = 144 x 131072 points into 64x1024 pixels that
// is 163 us (scatter prologue), 186 us (ring prologue) and 73 us (epilogue
// in bf16, C = 5) at 3.35 TB/s. The trig functions cost some 100
// instructions a point, below the memory's pace on 132 SMs.
//
// Choices: planes are read through their strides, so an array-of-structs
// batch [B, N, 4] needs no copy; outputs are contiguous and allocated by
// the caller (torch.empty); one launch per pass on the caller's stream;
// nothing is read back to the host.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                     // points a thread
constexpr int kChunk = kThreads * kItems;     // points a CTA (a flag each)
constexpr int kMaxChannels = 16;
constexpr int kSentinel = INT_MAX;

struct Planes {
  const float* p[4];            // x, y, z, remission
  long long sb[4], sn[4];       // strides in elements: scan, point
  const unsigned char* valid;   // bool
  long long vb, vn;
};

struct Geometry {
  int H, W, n_pix;
  float fov_down, inv_fov, inv_pi, rq_scale;
  int bits;                     // ring: idx_bits; scatter: rq_bits
  int rq_max;
};

struct Channels {
  int count;
  int idx[kMaxChannels];        // 0..4: x, y, z, remission, depth
  float mean[kMaxChannels];
  float stdev[kMaxChannels];
};

__device__ __forceinline__ float load(const Planes& a, int c, int b,
                                      long long i) {
  return a.p[c][b * a.sb[c] + i * a.sn[c]];
}

__device__ __forceinline__ float range_of(float x, float y, float z) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z)));
}

__device__ __forceinline__ bool point_ok(const Planes& a, int b,
                                         long long i) {
  const float r = range_of(load(a, 0, b, i), load(a, 1, b, i),
                           load(a, 2, b, i));
  return a.valid[b * a.vb + i * a.vn] != 0 && r > 1e-6f;
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// ops/projection.py::spherical_uv_planes, operation by operation
__device__ __forceinline__ void spherical(float x, float y, float z,
                                          const Geometry& g, int& u, int& v,
                                          float& r) {
  r = range_of(x, y, z);
  const float r_safe = isnan(r) ? r : fmaxf(r, 1e-9f);
  const float yaw = atan2f(y, x);
  const float pitch = asinf(clamp_keep_nan(__fdiv_rn(z, r_safe), -1.f, 1.f));
  const float tu = __fmul_rn(
      __fmul_rn(0.5f, __fsub_rn(1.f, __fmul_rn(yaw, g.inv_pi))),
      static_cast<float>(g.W));
  const float tv = __fmul_rn(
      __fsub_rn(1.f, __fmul_rn(__fsub_rn(pitch, g.fov_down), g.inv_fov)),
      static_cast<float>(g.H));
  u = min(max(__float2int_rz(floorf(tu)), 0), g.W - 1);
  v = min(max(__float2int_rz(floorf(tv)), 0), g.H - 1);
}

__device__ __forceinline__ int pack_f16x2(float a, float b) {
  const unsigned lo = __half_as_ushort(__float2half(a));
  const unsigned hi = __half_as_ushort(__float2half(b));
  return static_cast<int>(lo | (hi << 16));
}

__device__ __forceinline__ float half_lo(int w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(
      static_cast<unsigned>(w) & 0xFFFFu)));
}

__device__ __forceinline__ float half_hi(int w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(
      static_cast<unsigned>(w) >> 16)));
}

__global__ void __launch_bounds__(kThreads)
    pure_tail_kernel(Planes a, int n, int* __restrict__ flags, int chunks) {
  __shared__ unsigned char ok_s[kChunk + 1];
  const int b = blockIdx.y;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x + k * kThreads;
    const long long i = start + j;
    ok_s[1 + j] = i < n ? point_ok(a, b, i) : 1;
  }
  if (threadIdx.x == 0) ok_s[0] = start > 0 ? point_ok(a, b, start - 1) : 1;
  __syncthreads();
  int rise = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (start + j < n && ok_s[1 + j] && !ok_s[j]) rise = 1;
  }
  rise = __syncthreads_or(rise);
  if (threadIdx.x == 0)
    flags[static_cast<size_t>(b) * chunks + blockIdx.x] = rise;
}

template <bool kRing>
__global__ void __launch_bounds__(kThreads)
    prologue_kernel(Planes a, Geometry g, int n,
                    const int* __restrict__ flags, int chunks,
                    int* __restrict__ pix, int* __restrict__ key,
                    int* __restrict__ p1, int* __restrict__ p2) {
  const int b = blockIdx.y;
  bool pure = false;
  if (kRing) {
    int rise = 0;
    for (int j = threadIdx.x; j < chunks; j += kThreads)
      rise |= flags[static_cast<size_t>(b) * chunks + j];
    pure = !__syncthreads_or(rise);
  }
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  float x[kItems], y[kItems], z[kItems], rem[kItems];
  bool vld[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + threadIdx.x + k * kThreads;
    if (i < n) {
      x[k] = load(a, 0, b, i);
      y[k] = load(a, 1, b, i);
      z[k] = load(a, 2, b, i);
      rem[k] = load(a, 3, b, i);
      vld[k] = a.valid[b * a.vb + i * a.vn] != 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + threadIdx.x + k * kThreads;
    if (i >= n) continue;
    int u, v;
    float r;
    spherical(x[k], y[k], z[k], g, u, v, r);
    const bool ok = vld[k] && r > 1e-6f;
    // clamp in float first: a huge range saturates to the key ceiling
    const float t = __fmul_rn(r, g.rq_scale);
    const int rq = max(__float2int_rz(isnan(t) ? t : fminf(
                           t, static_cast<float>(g.rq_max - 1))), 0);
    const size_t o = static_cast<size_t>(b) * n + i;
    if (kRing) {
      pix[o] = ok ? v * g.W + u : (pure ? g.n_pix : -1);
      key[o] = ((ok ? rq : g.rq_max) << g.bits) | static_cast<int>(i);
    } else {
      key[o] = ok ? ((v * g.W + u) << g.bits) | rq : kSentinel;
    }
    p1[o] = pack_f16x2(x[k], y[k]);
    p2[o] = pack_f16x2(z[k], rem[k]);
  }
}

template <typename Out>
__device__ __forceinline__ Out to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half to_out<__half>(float v) {
  return __float2half(v);
}

template <bool kRing, bool kNorm, typename Out>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const int* __restrict__ key, const int* __restrict__ p1,
                    const int* __restrict__ p2, Out* __restrict__ img,
                    float* __restrict__ mask, int n_pix, int bits,
                    int rq_max, float inv_scale, Channels ch) {
  // the CTA's pixels' channels, staged so the image is stored coalesced
  __shared__ __align__(16) unsigned char stage[kThreads * kMaxChannels *
                                              sizeof(float)];
  Out* out = reinterpret_cast<Out*>(stage);
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.y) * n_pix;
  if (p < n_pix) {
    const size_t o = row + p;
    const int k = key[o];
    const int w1 = p1[o];
    const int w2 = p2[o];
    int rq;
    bool live;
    if (kRing) {
      rq = k >> bits;
      live = k != kSentinel && rq < rq_max;
    } else {
      rq = k & rq_max;
      live = k != kSentinel;
    }
    const float m = live ? 1.f : 0.f;
    const float vals[5] = {
        __fmul_rn(half_lo(w1), m), __fmul_rn(half_hi(w1), m),
        __fmul_rn(half_lo(w2), m), __fmul_rn(half_hi(w2), m),
        __fmul_rn(__fmul_rn(__int2float_rn(rq), inv_scale), m)};
    mask[o] = m;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
      if (c >= ch.count) break;
      const int s = ch.idx[c];
      const float v = s == 0 ? vals[0] : s == 1 ? vals[1] : s == 2 ? vals[2]
                    : s == 3 ? vals[3] : vals[4];
      const float t = kNorm ? __fdiv_rn(__fsub_rn(v, ch.mean[c]),
                                        ch.stdev[c])
                            : v;
      out[threadIdx.x * ch.count + c] = to_out<Out>(__fmul_rn(t, m));
    }
  }
  __syncthreads();
  // the CTA's pixels are one contiguous run of the image: 16-byte stores
  // where it is aligned, else one element a thread at a time
  const int total = min(kThreads, n_pix - p0) * ch.count;
  Out* dst = img + (row + p0) * ch.count;
  const size_t bytes = static_cast<size_t>(total) * sizeof(Out);
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (bytes & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < static_cast<int>(bytes / 16); i += kThreads)
      d[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) dst[i] = out[i];
  }
}

template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = s;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

template <bool kRing, bool kNorm>
cudaError_t launch_epilogue(int out_dtype, dim3 grid, cudaStream_t s,
                            const int* key, const int* p1, const int* p2,
                            void* img, float* mask, int n_pix, int bits,
                            int rq_max, float inv_scale, const Channels& ch) {
  switch (out_dtype) {
    case 0:
      return launch(epilogue_kernel<kRing, kNorm, float>, grid, s, key, p1,
                    p2, static_cast<float*>(img), mask, n_pix, bits, rq_max,
                    inv_scale, ch);
    case 1:
      return launch(epilogue_kernel<kRing, kNorm, __nv_bfloat16>, grid, s,
                    key, p1, p2, static_cast<__nv_bfloat16*>(img), mask,
                    n_pix, bits, rq_max, inv_scale, ch);
    case 2:
      return launch(epilogue_kernel<kRing, kNorm, __half>, grid, s, key, p1,
                    p2, static_cast<__half*>(img), mask, n_pix, bits, rq_max,
                    inv_scale, ch);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* dlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The points a CTA of the prologue takes, and so the points a pure-tail
// flag covers.
int dlt_proj_chunk(void) { return kChunk; }

// planes: x, y, z, rem float32 and valid bool, each [batch, n] read through
// strides[2c], strides[2c + 1] (c = 0..4, in elements: scan, point). ring
// != 0: pix, key, p1, p2 int32 [batch, n] contiguous and flags int32
// [batch, ceil(n / kChunk)] scratch, two launches (pre-pass, main pass);
// ring == 0: key, p1, p2 (pix and flags unused), one launch. bits is
// idx_bits (ring) or rq_bits (scatter); inv_fov and inv_pi are float32
// reciprocals, rq_scale the float32 quantization steps per metre. Returns
// the first launch error, 0 on success.
int dlt_proj_prologue(const void* x, const void* y, const void* z,
                      const void* rem, const void* valid,
                      const long long* strides, void* pix, void* key,
                      void* p1, void* p2, void* flags, int batch, int n,
                      int ring, int H, int W, float fov_down, float inv_fov,
                      float inv_pi, float rq_scale, int bits, int rq_max,
                      void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535 || H < 1 || W < 1 || bits < 1 || bits > 30 ||
      rq_max < 1 || (long long)H * W >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Planes a;
  const void* src[4] = {x, y, z, rem};
  for (int c = 0; c < 4; ++c) {
    a.p[c] = static_cast<const float*>(src[c]);
    a.sb[c] = strides[2 * c];
    a.sn[c] = strides[2 * c + 1];
  }
  a.valid = static_cast<const unsigned char*>(valid);
  a.vb = strides[8];
  a.vn = strides[9];
  Geometry g{H, W, H * W, fov_down, inv_fov, inv_pi, rq_scale, bits, rq_max};
  const int chunks = (n + kChunk - 1) / kChunk;
  const dim3 grid(chunks, batch, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* f = static_cast<int*>(flags);
  int* k = static_cast<int*>(key);
  int* w1 = static_cast<int*>(p1);
  int* w2 = static_cast<int*>(p2);
  if (ring) {
    cudaError_t err = launch(pure_tail_kernel, grid, s, a, n, f, chunks);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch(prologue_kernel<true>, grid, s, a, g, n,
                                   static_cast<const int*>(f), chunks,
                                   static_cast<int*>(pix), k, w1, w2));
  }
  return static_cast<int>(launch(prologue_kernel<false>, grid, s, a, g, n,
                                 static_cast<const int*>(nullptr), 0,
                                 static_cast<int*>(nullptr), k, w1, w2));
}

// key, p1, p2: int32 [batch, n_pix] (the selection's outputs); img
// [batch, n_pix, n_channels] of out_dtype (0 float32, 1 bfloat16, 2
// float16) and mask float32 [batch, n_pix], all contiguous. channels: host
// int [n_channels], each 0..4; mean and stdev: host float [n_channels], or
// both null for no normalisation. bits is idx_bits (ring != 0) or unused
// (scatter); inv_scale is float32(1 / rq_scale). One launch.
int dlt_proj_epilogue(const void* key, const void* p1, const void* p2,
                      void* img, void* mask, int batch, int n_pix, int ring,
                      int bits, int rq_max, float inv_scale, int n_channels,
                      const int* channels, const float* mean,
                      const float* stdev, int out_dtype, void* stream) {
  if (batch <= 0 || n_pix <= 0) return 0;
  if (batch > 65535 || n_channels < 1 || n_channels > kMaxChannels ||
      rq_max < 1 || bits < 0 || bits > 30 || (mean == nullptr) != (stdev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Channels ch{};
  ch.count = n_channels;
  for (int c = 0; c < n_channels; ++c) {
    if (channels[c] < 0 || channels[c] > 4)
      return static_cast<int>(cudaErrorInvalidValue);
    ch.idx[c] = channels[c];
    ch.mean[c] = mean ? mean[c] : 0.f;
    ch.stdev[c] = stdev ? stdev[c] : 1.f;
  }
  const dim3 grid((n_pix + kThreads - 1) / kThreads, batch, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(key);
  const int* w1 = static_cast<const int*>(p1);
  const int* w2 = static_cast<const int*>(p2);
  float* m = static_cast<float*>(mask);
  cudaError_t err;
  if (ring)
    err = mean ? launch_epilogue<true, true>(out_dtype, grid, s, k, w1, w2,
                                             img, m, n_pix, bits, rq_max,
                                             inv_scale, ch)
               : launch_epilogue<true, false>(out_dtype, grid, s, k, w1, w2,
                                              img, m, n_pix, bits, rq_max,
                                              inv_scale, ch);
  else
    err = mean ? launch_epilogue<false, true>(out_dtype, grid, s, k, w1, w2,
                                              img, m, n_pix, bits, rq_max,
                                              inv_scale, ch)
               : launch_epilogue<false, false>(out_dtype, grid, s, k, w1, w2,
                                               img, m, n_pix, bits, rq_max,
                                               inv_scale, ch);
  return static_cast<int>(err);
}

}  // extern "C"
