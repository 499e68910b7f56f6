// Ring projection selection for Hopper (sm_90a), plain C interface.
//
// Replaces deeplio_tpu/ops/projection_pallas_ring.py::_ring_kernel, the
// Pallas TPU kernel behind project_batch_ring_pallas. For each scan of N
// points in ring order it computes
//
//   cpix[i] = max(cummax(pix)[i], 0)
//   okey[p] = min{ key[i] : cpix[i] == p }          (SENTINEL if none)
//   op1[p], op2[p] = p1[i*], p2[i*]  where key[i*] == okey[p]  (0 if none)
//
// for every pixel p < n_pix. Keys are positive and unique within a scan
// (their low bits are the point index), so a 32-bit atomicMin is
// deterministic and exactly one point writes each pixel's payload. The
// TPU kernel's rank compaction, windowed gather and roll-based expansion
// exist only because Mosaic has no scatter; here a point writes its pixel
// directly.
//
// What bounds it on the card: memory traffic and atomics. The work is a
// handful of integer operations per point, so the least time is the bytes
// (each point's pixel and key, the two payload words of each pixel's
// winner, three int32 outputs written) over the memory rate, at most about
// 0.70 us for one 131072-point scan into 64x1024 pixels. This
// first design is simple and right rather than fast:
//   * traffic: four passes (tile max, carry scan, cummax + atomicMin,
//     payload), so pix is read twice and the running pixel goes through a
//     scratch array; the payload words are read only by winning points.
//     A one-pass decoupled look-back scan fused with the prologue and
//     epilogue is the later, faster design.
//   * atomics: each thread first reduces its own run of equal pixels in
//     registers and issues one atomicMin per run it holds, so a long run
//     (invalid points inheriting one pixel, or a scan out of ring order)
//     costs one atomic per thread, not one per point.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr int kItems = 4;                // consecutive points per thread
constexpr int kTile = kThreads * kItems; // points per block
constexpr int kSentinel = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive prefix max over the block (identity -1); *total gets the
// block's max. Every thread of the block must call it.
__device__ int block_exclusive_max(int v, int* smem, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int n = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc = max(inc, n);
  }
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = -1;
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? smem[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w = max(w, n);
    }
    __syncwarp();
    if (lane < nwarps) smem[lane] = w;   // inclusive warp-total prefix
  }
  __syncthreads();
  int pre = warp > 0 ? smem[warp - 1] : -1;
  *total = smem[nwarps - 1];
  __syncthreads();                       // smem is reused by the caller
  return max(pre, exc);
}

// Pass 1: the largest raw pixel of each tile.
__global__ void tile_max_kernel(const int* __restrict__ pix,
                                int* __restrict__ tile_max, int n,
                                int ntiles) {
  __shared__ int smem[32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const long long row = (long long)b * n;
  const int i0 = t * kTile + threadIdx.x * kItems;
  int m = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (i0 + k < n) m = max(m, pix[row + i0 + k]);
  int total;
  block_exclusive_max(m, smem, &total);
  if (threadIdx.x == 0) tile_max[(long long)b * ntiles + t] = total;
}

// Pass 2: per scan, carry[t] = max(tile_max[0..t-1]), -1 for t = 0.
__global__ void tile_carry_kernel(const int* __restrict__ tile_max,
                                  int* __restrict__ carry, int ntiles) {
  __shared__ int smem[32];
  const long long base = (long long)blockIdx.x * ntiles;
  int running = -1;
  for (int c0 = 0; c0 < ntiles; c0 += blockDim.x) {
    const int t = c0 + threadIdx.x;
    const int v = t < ntiles ? tile_max[base + t] : -1;
    int total;
    const int exc = block_exclusive_max(v, smem, &total);
    if (t < ntiles) carry[base + t] = max(running, exc);
    running = max(running, total);
  }
}

// Pass 3: block cummax with the tile's carry-in, clamp at 0, store the
// running pixel, and atomicMin each in-range run's smallest key.
__global__ void ring_min_kernel(const int* __restrict__ pix,
                                const int* __restrict__ key,
                                const int* __restrict__ carry,
                                int* __restrict__ cpix,
                                int* __restrict__ okey, int n, int n_pix,
                                int ntiles) {
  __shared__ int smem[32];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const long long row = (long long)b * n;
  const int i0 = t * kTile + threadIdx.x * kItems;
  int c[kItems];
  int run = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = i0 + k < n ? pix[row + i0 + k] : -1;
    run = max(run, v);
    c[k] = run;
  }
  int total;
  int pre = block_exclusive_max(run, smem, &total);
  pre = max(max(pre, carry[(long long)b * ntiles + t]), 0);

  int* out = okey + (long long)b * n_pix;
  int run_pix = -1;
  int run_key = kSentinel;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k >= n) break;
    const int p = max(pre, c[k]);
    const int kk = key[row + i0 + k];
    cpix[row + i0 + k] = p;
    if (p != run_pix) {
      if (run_pix >= 0 && run_pix < n_pix) atomicMin(out + run_pix, run_key);
      run_pix = p;
      run_key = kk;
    } else {
      run_key = min(run_key, kk);
    }
  }
  if (run_pix >= 0 && run_pix < n_pix) atomicMin(out + run_pix, run_key);
}

// Pass 4: the point holding its pixel's minimum key writes the payload.
__global__ void ring_payload_kernel(const int* __restrict__ cpix,
                                    const int* __restrict__ key,
                                    const int* __restrict__ p1,
                                    const int* __restrict__ p2,
                                    const int* __restrict__ okey,
                                    int* __restrict__ op1,
                                    int* __restrict__ op2, int n, int n_pix,
                                    long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int p = cpix[i];
    if (p >= n_pix) continue;
    const long long o = (i / n) * n_pix + p;
    if (okey[o] == key[i]) {
      op1[o] = p1[i];
      op2[o] = p2[i];
    }
  }
}

}  // namespace

extern "C" {

int dlt_ring_num_tiles(int n) { return (n + kTile - 1) / kTile; }

const char* dlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// okey must hold SENTINEL and op1/op2 zeros on entry (the caller fills
// them on the same stream). tile_max and carry are [B, ntiles] scratch,
// cpix is [B, N] scratch. Returns the first launch error, 0 on success.
int dlt_ring_project(const void* pix, const void* key, const void* p1,
                     const void* p2, void* okey, void* op1, void* op2,
                     void* tile_max, void* carry, void* cpix, int batch,
                     int n, int n_pix, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = dlt_ring_num_tiles(n);
  const dim3 grid(ntiles, batch);
  cudaError_t err;

  tile_max_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(pix), static_cast<int*>(tile_max), n, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  tile_carry_kernel<<<batch, 1024, 0, s>>>(
      static_cast<const int*>(tile_max), static_cast<int*>(carry), ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ring_min_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int*>(pix), static_cast<const int*>(key),
      static_cast<const int*>(carry), static_cast<int*>(cpix),
      static_cast<int*>(okey), n, n_pix, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long total = (long long)batch * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  ring_payload_kernel<<<blocks < 65535 ? blocks : 65535, kThreads, 0, s>>>(
      static_cast<const int*>(cpix), static_cast<const int*>(key),
      static_cast<const int*>(p1), static_cast<const int*>(p2),
      static_cast<const int*>(okey), static_cast<int*>(op1),
      static_cast<int*>(op2), n, n_pix, total);
  return cudaGetLastError();
}

}  // extern "C"
