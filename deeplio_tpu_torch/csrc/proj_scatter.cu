// Point-scatter projection selection for Hopper (sm_90a), plain C
// interface.
//
// Replaces deeplio_tpu/ops/projection_pallas.py::_proj_kernel, the Pallas
// TPU kernel behind project_batch_pallas (backend "pallas"). For each scan
// of N points IN ANY ORDER, with key[i] = pixel << rq_bits | rq (or
// INT32_MAX for an invalid point), it computes for every pixel p < n_pix
//
//   i*      = the point of pixel p with the smallest rq, ties to the
//             smaller index (the TPU kernel's strict "<" in index order)
//   kmin[p] = key[i*]                 (INT32_MAX if no point landed)
//   xyo[p]  = xy[i*], zro[p] = zr[i*] (0 if no point landed)
//
// The TPU kernel walks the points one at a time through SMEM because
// Mosaic has no scatter. Here every point is one thread:
//
//   pass 1: atomicMin of the 64-bit composite (rq << 32 | index) into a
//           u64 scratch best[B, n_pix] that starts all ones. The composite
//           is unique within a scan, so the result does not depend on the
//           order of the atomics: closest wins, ties go to the smaller
//           index, exactly the Pallas rule.
//   pass 2: one thread per pixel decodes best and gathers the winner's
//           two payload words.
//
// What bounds it on the card: memory traffic and the atomics. The work is
// a few integer operations per point, so the least time is the bytes (each
// point's key, the two payload words of each pixel's winner, three int32
// outputs written) over the memory rate, at most about 0.55 us for one
// 131072-point scan into 64x1024 pixels. This first
// design is simple and right rather than fast: it reads only the keys in
// pass 1, the payload words only for the winners in pass 2, and pays for
// the u64 scratch (a memset, 8 bytes per pixel written by the atomics and
// read back). Shared-memory pre-aggregation of the per-pixel minimum, a
// fused prologue and dropping the scratch are the later, faster design. A
// pixel that many points hit serialises their atomics at one address.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;

// Pass 1: per valid point, atomicMin of (rq << 32 | index) at its pixel.
// The grid's y dimension is the scan, x walks its points.
__global__ void scatter_min_kernel(const int* __restrict__ key,
                                   unsigned long long* __restrict__ best,
                                   int n, int n_pix, int rq_bits) {
  const long long row = (long long)blockIdx.y * n;
  unsigned long long* out = best + (long long)blockIdx.y * n_pix;
  const unsigned rq_mask = (1u << rq_bits) - 1u;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned k = static_cast<unsigned>(key[row + i]);
    // INT32_MAX marks an invalid point; a negative key is outside the
    // contract and skipped the same way.
    if (k >= static_cast<unsigned>(INT_MAX)) continue;
    const unsigned pix = k >> rq_bits;
    if (pix >= static_cast<unsigned>(n_pix)) continue;
    const unsigned long long comp =
        (static_cast<unsigned long long>(k & rq_mask) << 32) |
        static_cast<unsigned long long>(static_cast<unsigned>(i));
    atomicMin(out + pix, comp);
  }
}

// Pass 2: per pixel, decode the winner and gather its payload words.
__global__ void scatter_payload_kernel(
    const unsigned long long* __restrict__ best, const int* __restrict__ xy,
    const int* __restrict__ zr, int* __restrict__ kmin,
    int* __restrict__ xyo, int* __restrict__ zro, int n, int n_pix,
    int rq_bits) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const long long o = (long long)blockIdx.y * n_pix + p;
  const unsigned long long v = best[o];
  if (v == kEmpty) {
    kmin[o] = INT_MAX;
    xyo[o] = 0;
    zro[o] = 0;
    return;
  }
  const unsigned idx = static_cast<unsigned>(v & 0xffffffffull);
  const unsigned rq = static_cast<unsigned>(v >> 32);
  const long long src = (long long)blockIdx.y * n + idx;
  kmin[o] = static_cast<int>((static_cast<unsigned>(p) << rq_bits) | rq);
  xyo[o] = xy[src];
  zro[o] = zr[src];
}

}  // namespace

extern "C" {

const char* dlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key, xy, zr: int32 [batch, n]; kmin, xyo, zro: int32 [batch, n_pix];
// best: u64 [batch, n_pix] scratch (set here). All on one device, the
// launches on `stream`. batch must be <= 65535 (the grid's y limit).
// Returns the first launch error, 0 on success.
int dlt_proj_scatter(const void* key, const void* xy, const void* zr,
                     void* kmin, void* xyo, void* zro, void* best, int batch,
                     int n, int n_pix, int rq_bits, void* stream) {
  if (batch <= 0 || n_pix <= 0) return 0;
  if (batch > 65535 || rq_bits < 1 || rq_bits > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      best, 0xff, sizeof(unsigned long long) * (size_t)batch * n_pix, s);
  if (err != cudaSuccess) return err;

  if (n > 0) {
    // Enough blocks to cover a scan in one sweep, capped so a huge N
    // walks its points in a grid-stride loop.
    int bx = (n + kThreads - 1) / kThreads;
    if (bx > 4096) bx = 4096;
    scatter_min_kernel<<<dim3(bx, batch), kThreads, 0, s>>>(
        static_cast<const int*>(key),
        static_cast<unsigned long long*>(best), n, n_pix, rq_bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const int px = (n_pix + kThreads - 1) / kThreads;
  scatter_payload_kernel<<<dim3(px, batch), kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(best),
      static_cast<const int*>(xy), static_cast<const int*>(zr),
      static_cast<int*>(kmin), static_cast<int*>(xyo),
      static_cast<int*>(zro), n, n_pix, rq_bits);
  return cudaGetLastError();
}

}  // extern "C"
