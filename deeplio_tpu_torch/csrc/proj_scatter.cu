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
// A key that is INT32_MAX, negative, or whose pixel is >= n_pix lands
// nowhere.
//
// What bounds it on the card: memory traffic. The work is a few integer
// operations per point, so the least time is the bytes it must move: each
// point's key (4 B), the two payload words of each landed pixel's winner
// (8 B) and three int32 outputs per pixel (12 B), over the memory rate:
// 65 us for 144 scans of 131072 points into 64x1024 pixels. The winners'
// payload words are random 4-byte reads, and each moves a whole 32-byte
// sector from a random DRAM row: that, not the bound's bytes, is what the
// kernel waits on.
//
// The design: one launch, no global scratch, no memset. The per-pixel
// minima of a scan live in the shared memory of a thread-block cluster of C
// CTAs (at most 8): each CTA owns a contiguous 1/C of a pixel tile's slots.
// A slot holds the composite rq << idx_bits | index, unique within a scan,
// so atomicMin gives the Pallas rule whatever the order of the atomics, and
// all ones means an empty pixel. The slots are 32-bit where
// rq_bits + idx_bits <= 31 (the main path: 14 + 17), else 64-bit with
// idx_bits = 32. Each CTA:
//
//   phase 0: sets its slots to all ones.
//   phase 1: streams every key of the scan (16-byte loads, kVec in flight,
//            a scalar head and tail) and atomicMins the keys of its own
//            pixels into its own slots. The CTAs of a cluster read the
//            same keys at the same time (the cluster launch guarantees
//            they run together), so the L2 serves C - 1 of the C reads;
//            no CTA touches another's shared memory, and the cluster is
//            there only because, at the main path's C = 4, it measured
//            faster than the same CTAs launched alone (at C = 8 it
//            measured slower: bench/scatter_launch.py, PERF.md).
//            (Sending each key once to its owner through map_shared_rank
//            instead makes 3 of 4 atomics remote, and remote shared-memory
//            atomics were slower on the card than the L2 reads they save.)
//   phase 2: walks its own pixels, kPix at a time so that many winners'
//            payload gathers are in flight, and writes kmin, xyo and zro
//            coalesced (0 payload for an empty pixel).
//
// One 1024-thread CTA per SM (64 registers a thread) keeps about 33 scans
// in flight, whose payload rows (1 MB a scan) stay in the 50 MB L2 while
// their winners are gathered. An image whose slots do not fit in 8 CTAs'
// budget is cut into pixel tiles along the grid's x; every cluster then
// reads all of the scan's keys and keeps its own tile's. The host chooses
// slot width, C, slots per CTA and tiles
// (projection_scatter.py::scatter_plan). A pixel that many points hit
// serialises their atomics at one shared-memory address.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kVec = 8;   // 16-byte key loads in flight per thread
constexpr int kPix = 8;   // pixels (and their gathers) in flight per thread
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA can use (227 KB)

template <typename Slot>
__global__ void __launch_bounds__(kThreads)
    scatter_select_kernel(const int* __restrict__ key,
                          const int* __restrict__ xy,
                          const int* __restrict__ zr, int* __restrict__ kmin,
                          int* __restrict__ xyo, int* __restrict__ zro, int n,
                          int n_pix, int rq_bits, int idx_bits,
                          int cta_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* slots = reinterpret_cast<Slot*>(smem);
  constexpr Slot kEmpty = ~Slot(0);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  // this CTA's pixels: [p0, p0 + count) of tile blockIdx.x / csize
  const int p0 = (blockIdx.x / csize) * csize * cta_slots + rank * cta_slots;
  const int count = max(0, min(cta_slots, n_pix - p0));

  // phase 0
  for (int s = tid; s < count; s += kThreads) slots[s] = kEmpty;
  __syncthreads();

  // phase 1. An invalid (INT32_MAX) or negative key has a pixel >= n_pix
  // because (n_pix + 1) << rq_bits < 2^31, so one unsigned range check
  // rejects it with the other CTAs' pixels.
  const int* krow = key + b * n;
  const unsigned rq_mask = (1u << rq_bits) - 1u;
  const unsigned base = static_cast<unsigned>(p0);
  const unsigned mine = static_cast<unsigned>(count);
  auto visit = [&](int i, int k) {
    const unsigned u = static_cast<unsigned>(k);
    const unsigned local = (u >> rq_bits) - base;   // wraps below base
    if (local < mine)
      atomicMin(slots + local, (static_cast<Slot>(u & rq_mask) << idx_bits) |
                                   static_cast<Slot>(static_cast<unsigned>(i)));
  };
  // a scalar head up to the first 16-byte boundary (rows of a ragged N
  // start anywhere), the 16-byte body, a scalar tail
  const int head = min(
      n, static_cast<int>(
             (4 - ((reinterpret_cast<uintptr_t>(krow) >> 2) & 3)) & 3));
  if (tid < head) visit(tid, __ldg(krow + tid));
  const int nvec = (n - head) >> 2;
  const int4* kv = reinterpret_cast<const int4*>(krow + head);
  for (int v0 = 0; v0 < nvec; v0 += kThreads * kVec) {
    int4 q[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int v = v0 + u * kThreads + tid;
      q[u] = v < nvec ? __ldg(kv + v) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = head + 4 * (v0 + u * kThreads + tid);
      visit(i, q[u].x);
      visit(i + 1, q[u].y);
      visit(i + 2, q[u].z);
      visit(i + 3, q[u].w);
    }
  }
  const int t0 = head + 4 * nvec;
  if (t0 + tid < n) visit(t0 + tid, __ldg(krow + t0 + tid));
  __syncthreads();

  // phase 2
  const Slot idx_mask = (Slot(1) << idx_bits) - 1;
  const int* xrow = xy + b * n;
  const int* zrow = zr + b * n;
  const long long o = b * n_pix + p0;
  for (int s0 = 0; s0 < count; s0 += kThreads * kPix) {
    Slot v[kPix];
    int xw[kPix], zw[kPix];
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      const int s = s0 + u * kThreads + tid;
      v[u] = s < count ? slots[s] : kEmpty;
    }
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      xw[u] = 0;
      zw[u] = 0;
      if (v[u] != kEmpty) {
        const int idx = static_cast<int>(v[u] & idx_mask);
        xw[u] = __ldg(xrow + idx);
        zw[u] = __ldg(zrow + idx);
      }
    }
#pragma unroll
    for (int u = 0; u < kPix; ++u) {
      const int s = s0 + u * kThreads + tid;
      if (s >= count) continue;
      const unsigned rq = static_cast<unsigned>(v[u] >> idx_bits);
      kmin[o + s] = v[u] == kEmpty
                        ? INT_MAX
                        : static_cast<int>(
                              (static_cast<unsigned>(p0 + s) << rq_bits) | rq);
      xyo[o + s] = xw[u];
      zro[o + s] = zw[u];
    }
  }
}

// What launch() has set and checked on one device for one Slot type: the
// dynamic shared memory the kernel may use, and the last (cluster, smem)
// found to fit.
struct DeviceState {
  size_t smem_set = 0;
  int checked_cluster = 0;
  size_t checked_smem = 0;
};

template <typename Slot>
cudaError_t launch(const int* key, const int* xy, const int* zr, int* kmin,
                   int* xyo, int* zro, int batch, int n, int n_pix,
                   int rq_bits, int idx_bits, int cluster, int cta_slots,
                   int tiles, cudaStream_t s) {
  auto kernel = scatter_select_kernel<Slot>;
  const size_t smem = sizeof(Slot) * (size_t)cta_slots;
  // Host-side settings and checks, made once per device and configuration
  // so that a call inside CUDA-graph capture makes no new runtime query;
  // the lock keeps concurrent callers from racing on them.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::unordered_map<int, DeviceState> states;
  std::lock_guard<std::mutex> lock(mu);
  DeviceState& st = states[dev];
  if (smem > st.smem_set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    st.smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * tiles, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster != st.checked_cluster || smem != st.checked_smem) {
    int fits = 0;
    err = cudaOccupancyMaxActiveClusters(&fits, (void*)kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fits < 1) return cudaErrorLaunchOutOfResources;
    st.checked_cluster = cluster;
    st.checked_smem = smem;
  }
  return cudaLaunchKernelEx(&cfg, kernel, key, xy, zr, kmin, xyo, zro, n,
                            n_pix, rq_bits, idx_bits, cta_slots);
}

}  // namespace

extern "C" {

const char* dlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key, xy, zr: int32 [batch, n]; kmin, xyo, zro: int32 [batch, n_pix]. All
// on one device, one launch on `stream`, no scratch. The plan (slot_bytes
// 4 or 8, idx_bits, cluster CTAs, cta_slots, tiles) comes from
// scatter_plan; batch must be <= 65535 (the grid's y limit). Returns the
// launch error, cudaErrorLaunchOutOfResources if no cluster of the plan
// fits on the device, 0 on success.
int dlt_proj_scatter(const void* key, const void* xy, const void* zr,
                     void* kmin, void* xyo, void* zro, int batch, int n,
                     int n_pix, int rq_bits, int slot_bytes, int idx_bits,
                     int cluster, int cta_slots, int tiles, void* stream) {
  if (batch <= 0 || n_pix <= 0) return 0;
  if (batch > 65535 || n < 0 || rq_bits < 1 || rq_bits > 30 ||
      ((long long)n_pix + 1) << rq_bits >= (1LL << 31) || cluster < 1 ||
      cluster > 8 || cta_slots < 1 || tiles < 1 ||
      (size_t)cta_slots * slot_bytes > kMaxSmem ||
      (long long)cluster * cta_slots * tiles < n_pix ||
      (long long)cluster * cta_slots * tiles >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* k = static_cast<const int*>(key);
  const int* x = static_cast<const int*>(xy);
  const int* z = static_cast<const int*>(zr);
  int* km = static_cast<int*>(kmin);
  int* xo = static_cast<int*>(xyo);
  int* zo = static_cast<int*>(zro);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slot_bytes == 4 && rq_bits + idx_bits <= 31)
    return launch<unsigned>(k, x, z, km, xo, zo, batch, n, n_pix, rq_bits,
                            idx_bits, cluster, cta_slots, tiles, s);
  if (slot_bytes == 8 && idx_bits == 32)
    return launch<unsigned long long>(k, x, z, km, xo, zo, batch, n, n_pix,
                                      rq_bits, idx_bits, cluster, cta_slots,
                                      tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
