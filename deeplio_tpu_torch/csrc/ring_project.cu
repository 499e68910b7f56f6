// Ring projection selection for Hopper (sm_90a), plain C interface.
//
// Replaces deeplio_tpu/ops/projection_pallas_ring.py::_ring_kernel, the
// Pallas TPU kernel behind project_batch_ring_pallas. For each scan of N
// points in ring order it computes, for every pixel p < n_pix,
//
//   cpix[i] = max(cummax(pix)[i], 0)
//   okey[p] = min{ key[i] : cpix[i] == p }          (SENTINEL if none)
//   op1[p], op2[p] = p1[i*], p2[i*]  for the point i* holding okey[p]
//                                                   (0 if none)
//
// (projection_ring.py::ring_select_reference). Keys are unique within a
// scan; nothing here reads a layout into them.
//
// What bounds it on the card: bytes. The work is a few integer operations
// per point, so the least time is the bytes it must move: each point's
// pixel and key (8 B), the two payload words of each landed pixel's winner
// (8 B) and three int32 outputs per pixel (12 B), over the memory rate:
// 0.70 us for one 131072-point scan into 64x1024 pixels. That is less than
// a kernel launch, so at the streaming path's B = 1 the time goes to
// launches, fills and dependent steps. The design makes it one launch, with
// no fill and no global scratch, and every output word written once; what
// is left is the chain of dependent steps inside the launch (two cluster
// barriers, a block scan, the loads, the walk and the writes) on the 16
// SMs that one scan keeps busy: an empty scan into 64x1024 pixels already
// takes more than half the time of a full one (bench/ring_layouts.py,
// PERF.md).
//
// The design (modelled step for step, against the plain version, by
// tests/test_torch_ring_scan_model.py):
//
//   * Runs are contiguous. cpix never decreases along the scan, so the
//     points of a pixel form one run and the run's minimum is known at its
//     last point. The selection is one inclusive scan over the points with
//     an associative operator on segment states (m, t, a): m the largest
//     clamped pixel, t the smallest (key, position) among the points whose
//     running max is m, a the smallest (key, position) of all points;
//       combine(A, B) = B.m > A.m ? (B.m, B.t, min(A.a, B.a))
//                                 : (A.m, min(A.t, B.a), min(A.a, B.a)).
//     The pixel is clamped at load (v = max(pix, 0)): clamping commutes
//     with cummax and merges a leading invalid prefix with a following run
//     on pixel 0, as the plain version's clamp_min(0) after the cummax does.
//   * A cluster replaces a look-back. A scan is cut into kCluster
//     contiguous slices, one CTA each, launched as one thread-block
//     cluster of 16 (co-scheduled, so no CTA waits on one that has not
//     started; 16 is above the portable 8 and set as such, and at B = 1
//     faster than any layout of 8 timed). Each CTA stages
//     its slice's pixels and keys in shared memory (each warp loading 512
//     contiguous bytes, an XOR layout keeping stores and reads free of bank
//     conflicts), each thread folds kItems consecutive points, the block
//     scans the threads' states (warp shuffles, shared memory), and the CTA
//     publishes its slice's aggregate in its shared memory. After
//     cluster.sync() each CTA folds the lower ranks' aggregates, read
//     through distributed shared memory, into its carry-in. No status
//     array, so nothing to reset before a call. A slice longer than one
//     pass of the block (kThreads * kItems points) loops over chunks.
//   * Pixels have owners. Point i ends a run iff it is the last point or
//     v[i+1] > cpix[i]; its pixel cpix[i] (if below n_pix) then takes the
//     run's winner. Every other pixel is empty: those between two runs'
//     pixels and after the last. So the image is cut into kCluster windows
//     of K pixels (K = n_pix / kCluster, rounded up to 4, at most kWindow;
//     larger images take several passes), window r owned by CTA r and held
//     in its shared memory, starting empty. Each run end sends its winner
//     (key, position) to the owner of its pixel (a local store for nearly
//     every run of a ring scan, else a store through distributed shared
//     memory); after a second cluster barrier each CTA writes its window
//     whole, with 16-byte stores, gathering the winners' payload words by
//     position (winners come in pixel order, so a warp's gathers fall on a
//     few lines). Runs at cpix >= n_pix (the prologue's re-keyed invalid
//     tail) send nothing. Every pixel is written once, by its owner, and
//     every CTA writes the same share, whatever the scan: an all-invalid
//     scan costs what a full one does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;              // CTAs per scan
constexpr int kThreads = 512;             // threads per CTA
constexpr int kItems = 16;                // consecutive points per thread
constexpr int kChunk = kThreads * kItems; // points per pass of a CTA
constexpr int kUnits = kItems / 4;        // 16-byte units per thread's group
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 8192;             // most pixels a CTA owns per pass
// the chunk's pixels and keys, then the window's winner keys and positions
constexpr int kSmemBytes = kChunk * 8 + (kWindow + 4) * 8;
constexpr int kMaxN = 1 << 30;
constexpr int kSentinel = INT_MAX;
constexpr long long kNone = LLONG_MAX;    // the t and a of no point
constexpr unsigned kFull = 0xffffffffu;

static_assert(kUnits >= 1 && kUnits <= 8 && (kUnits & (kUnits - 1)) == 0 &&
                  kWarps <= 32 && kCluster <= 32,
              "layout");
static_assert(kSmemBytes <= 227 * 1024 - 1024, "shared memory");

// A segment's state; t and a are (key, position) as key * 2^32 + position,
// so one signed 64-bit comparison orders them.
struct State {
  long long t, a;
  int m;
};

__device__ __forceinline__ State ident() { return State{kNone, kNone, -1}; }

__device__ __forceinline__ long long tag(int key, int i) {
  return static_cast<long long>(key) * 4294967296LL + i;
}

__device__ __forceinline__ State combine(const State& x, const State& y) {
  const bool up = y.m > x.m;
  return State{up ? y.t : min(x.t, y.a), min(x.a, y.a), up ? y.m : x.m};
}

__device__ __forceinline__ State shfl_up(const State& s, int o) {
  return State{__shfl_up_sync(kFull, s.t, o), __shfl_up_sync(kFull, s.a, o),
               __shfl_up_sync(kFull, s.m, o)};
}

// Inclusive scan over the warp's lanes in lane order.
__device__ __forceinline__ State warp_scan(State s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const State n = shfl_up(s, o);
    if (lane >= o) s = combine(n, s);
  }
  return s;
}

struct Shared {
  State warp[kWarps];
  State agg;     // this CTA's slice aggregate, read by the higher ranks
  State carry;
};

// Exclusive scan of the threads' states in thread order; *total gets the
// block's. Every thread of the block must call it.
__device__ State block_scan(const State& s, State* total, Shared& sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const State inc = warp_scan(s);
  State exc = shfl_up(inc, 1);
  if (lane == 0) exc = ident();
  if (lane == 31) sm.warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const State w = warp_scan(lane < kWarps ? sm.warp[lane] : ident());
    if (lane < kWarps) sm.warp[lane] = w;
  }
  __syncthreads();
  const State pre = warp > 0 ? sm.warp[warp - 1] : ident();
  *total = sm.warp[kWarps - 1];
  __syncthreads();                       // sm.warp is reused by the caller
  return combine(pre, exc);
}

// Where the 16-byte unit q of thread g's group sits in shared memory: the
// XOR spreads both the striped stores and each thread's reads of its own
// group over all banks.
__device__ __forceinline__ int unit_slot(int g, int q) {
  constexpr int kPer = 8 / kUnits;       // groups per 128 bytes
  return g * kUnits + (q ^ ((g / kPer) & (kUnits - 1)));
}

// Stages points c0 .. c0 + cnt - 1 into shared memory, each warp loading
// 512 contiguous bytes at a time: the clamped pixel (-1 past cnt) and key.
__device__ __forceinline__ void stage(const int* prow, const int* krow,
                                      int c0, int cnt, bool vec, int4* sp,
                                      int4* sk) {
  int4 a[kUnits], b[kUnits];
#pragma unroll
  for (int r = 0; r < kUnits; ++r) {
    const int j = 4 * (r * kThreads + threadIdx.x);
    if (vec && j + 4 <= cnt) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(prow + c0 + j));
      a[r] = make_int4(max(p.x, 0), max(p.y, 0), max(p.z, 0), max(p.w, 0));
      b[r] = __ldg(reinterpret_cast<const int4*>(krow + c0 + j));
    } else {
      int pv[4], kv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j + e < cnt;
        pv[e] = in ? max(__ldg(prow + c0 + j + e), 0) : -1;
        kv[e] = in ? __ldg(krow + c0 + j + e) : 0;
      }
      a[r] = make_int4(pv[0], pv[1], pv[2], pv[3]);
      b[r] = make_int4(kv[0], kv[1], kv[2], kv[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kUnits; ++r) {
    const int u = r * kThreads + threadIdx.x;
    const int s = unit_slot(u / kUnits, u % kUnits);
    sp[s] = a[r];
    sk[s] = b[r];
  }
}

// Thread g's kItems staged points.
__device__ __forceinline__ void group(const int4* sp, const int4* sk, int g,
                                      int (&v)[kItems], int (&k)[kItems]) {
#pragma unroll
  for (int q = 0; q < kUnits; ++q) {
    const int4 a = sp[unit_slot(g, q)];
    const int4 b = sk[unit_slot(g, q)];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
    k[4 * q] = b.x;
    k[4 * q + 1] = b.y;
    k[4 * q + 2] = b.z;
    k[4 * q + 3] = b.w;
  }
}

// Folds points i0 .. i0 + kW - 1 (v = -1: no point) into s, in order.
template <int kW>
__device__ __forceinline__ void fold(State& s, const int (&v)[kW],
                                     const int (&k)[kW], int i0) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    if (v[j] < 0) continue;
    const long long t = tag(k[j], i0 + j);
    if (v[j] > s.m) {
      s.m = v[j];
      s.t = t;
    } else {
      s.t = min(s.t, t);
    }
    s.a = min(s.a, t);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    ring_select_kernel(const int* __restrict__ pix,
                       const int* __restrict__ key,
                       const int* __restrict__ p1,
                       const int* __restrict__ p2, int* __restrict__ okey,
                       int* __restrict__ op1, int* __restrict__ op2, int n,
                       int n_pix) {
  __shared__ Shared sm;
  extern __shared__ int4 dyn[];
  int4* sp = dyn;                        // staged pixels, kChunk
  int4* sk = dyn + kChunk / 4;           // staged keys, kChunk
  int* wkey = reinterpret_cast<int*>(dyn + kChunk / 2);  // kWindow + 4
  int* wpos = wkey + kWindow + 4;                          // kWindow + 4
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int* prow = pix + b * n;
  const int* krow = key + b * n;
  const int* x1 = p1 + b * n;
  const int* x2 = p2 + b * n;
  const bool vec = ((reinterpret_cast<uintptr_t>(prow) |
                     reinterpret_cast<uintptr_t>(krow)) & 15) == 0;
  // slices are whole groups of kItems, so only the scan's last group is
  // ragged and a group past a slice's end lies wholly past it (N = 0: all
  // slices empty)
  const int slice = ((n - 1) / kCluster / kItems + 1) * kItems;
  const int lo = min(n, rank * slice);
  const int hi = min(n, lo + slice);
  // a pass covers kCluster windows of K pixels, window r owned by rank r;
  // window slot s sits at lead + s, so that groups of 4 slots line up with
  // 16-byte groups of the outputs
  const long long obase = b * n_pix;     // this scan's first output word
  const int K = min(kWindow, (((n_pix - 1) / kCluster + 1) + 3) & ~3);
  const int span = kCluster * K;
  const int lead = static_cast<int>(obase & 3);
  const int nq = (lead + K + 3) >> 2;
  auto reset = [&]() {
    for (int q = tid; q < nq; q += kThreads) {
      reinterpret_cast<int4*>(wkey)[q] =
          make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
      reinterpret_cast<int4*>(wpos)[q] = make_int4(-1, -1, -1, -1);
    }
  };

  // phase 1: the slice's aggregate; the first chunk stays staged
  int v[kItems], k[kItems];
  int after0 = -1;                       // v of the point after chunk 0
  State exc0 = ident(), tot0 = ident();
  if (lo < hi) {
    const int c1 = min(lo + kChunk, hi);
    if (c1 < n) after0 = max(__ldg(prow + c1), 0);
    stage(prow, krow, lo, c1 - lo, vec, sp, sk);
    // the winners' payload words lie near the chunk's own points
    const int i0 = lo + tid * kItems;
    if (i0 < hi) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(x1 + i0));
      asm volatile("prefetch.global.L1 [%0];" ::"l"(x2 + i0));
    }
    __syncthreads();
    group(sp, sk, tid, v, k);
    State s = ident();
    fold<kItems>(s, v, k, i0);
    exc0 = block_scan(s, &tot0, sm);
  }
  State agg = tot0;
  for (int c0 = lo + kChunk; c0 < hi; c0 += kChunk) {
    const int i0 = c0 + tid * kItems;
    State s = ident();
#pragma unroll 1
    for (int q = 0; q < kItems; q += 4) {
      int v4[4], k4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = i0 + q + e < hi;
        v4[e] = in ? max(__ldg(prow + i0 + q + e), 0) : -1;
        k4[e] = in ? __ldg(krow + i0 + q + e) : 0;
      }
      fold<4>(s, v4, k4, i0 + q);
    }
    State tot;
    block_scan(s, &tot, sm);
    agg = combine(agg, tot);
  }
  reset();                               // the other CTAs write into it next
  if (tid == 0) sm.agg = agg;
  cluster.sync();
  if (tid < 32) {                        // the lower ranks' aggregates, in order
    const State x = warp_scan(
        tid < rank ? *cluster.map_shared_rank(&sm.agg, tid) : ident());
    if (tid == 31) sm.carry = x;
  }
  __syncthreads();
  const State carry0 = sm.carry;

  // phase 2, pass by pass: every run end sends its winner (key, position)
  // to the window of the pixel's owner, then every CTA writes its window
  int staged = lo;
  for (int pass0 = 0; pass0 < n_pix; pass0 += span) {
    if (pass0 > 0) {
      __syncthreads();                   // the last pass's writes are done
      reset();
      cluster.sync();
    }
    State carry = carry0;
    for (int c0 = lo; c0 < hi; c0 += kChunk) {
      const int i0 = c0 + tid * kItems;
      const int c1 = min(c0 + kChunk, hi);
      const int after = c0 == lo ? after0
                                 : (c1 < n ? max(__ldg(prow + c1), 0) : -1);
      if (c0 != staged) {
        __syncthreads();                 // the last chunk's reads are done
        stage(prow, krow, c0, c1 - c0, vec, sp, sk);
        __syncthreads();
        staged = c0;
      }
      group(sp, sk, tid, v, k);
      State exc = exc0, tot = tot0;
      if (c0 != lo) {
        State s = ident();
        fold<kItems>(s, v, k, i0);
        exc = block_scan(s, &tot, sm);
      }
      // v of the point after this thread's group
      const int vnext = i0 + kItems < c1
          ? reinterpret_cast<const int*>(sp + unit_slot(tid + 1, 0))[0]
          : after;
      State s = combine(carry, exc);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (v[j] < 0) break;             // past the scan's end or the slice
        const long long t = tag(k[j], i0 + j);
        if (v[j] > s.m) {
          s.m = v[j];
          s.t = t;
        } else {
          s.t = min(s.t, t);
        }
        const int nv = j + 1 < kItems ? v[j + 1] : vnext;
        const int off = s.m - pass0;     // s.m >= 0, pass0 >= 0: no overflow
        if ((nv < 0 || nv > s.m) && s.m < n_pix && off >= 0 && off < span) {
          const int owner = off / K;     // a run ends
          const int slot = lead + off - owner * K;
          const int wk = static_cast<int>(s.t >> 32);
          const int wp = static_cast<int>(s.t & 0xffffffffLL);
          if (owner == rank) {           // mostly: a CTA's runs land near it
            wkey[slot] = wk;
            wpos[slot] = wp;
          } else {
            cluster.map_shared_rank(wkey, owner)[slot] = wk;
            cluster.map_shared_rank(wpos, owner)[slot] = wp;
          }
        }
      }
      carry = combine(carry, tot);
    }
    cluster.sync();                      // every winner is in its window
    const int own = pass0 + rank * K;
    const int wn = max(0, min(K, n_pix - own));
#pragma unroll 2
    for (int q = tid; 4 * q < lead + wn; q += kThreads) {
      const int4 kq = reinterpret_cast<const int4*>(wkey)[q];
      const int4 wq = reinterpret_cast<const int4*>(wpos)[q];
      const int w[4] = {wq.x, wq.y, wq.z, wq.w};
      int x[4], z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = w[e] >= 0 ? __ldg(x1 + w[e]) : 0;
        z[e] = w[e] >= 0 ? __ldg(x2 + w[e]) : 0;
      }
      const int s0 = 4 * q - lead;       // the slot of the group's first word
      const long long g = obase + own + s0;
      if (s0 >= 0 && s0 + 4 <= wn) {
        *reinterpret_cast<int4*>(okey + g) = kq;
        *reinterpret_cast<int4*>(op1 + g) = make_int4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<int4*>(op2 + g) = make_int4(z[0], z[1], z[2], z[3]);
      } else {
        const int kk[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + e >= 0 && s0 + e < wn) {
            okey[g + e] = kk[e];
            op1[g + e] = x[e];
            op2[g + e] = z[e];
          }
      }
    }
  }
}

// What dlt_ring_project has set and checked on one device: the shared
// memory, and that a cluster fits.
std::mutex checked_mu;
std::unordered_map<int, bool> checked;

}  // namespace

extern "C" {

const char* dlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pix, key, p1, p2: int32 [batch, n]; okey, op1, op2: int32 [batch, n_pix],
// 16-byte aligned, every word written by the kernel (no fill needed). One launch on
// `stream`, no scratch. Returns the launch error,
// cudaErrorLaunchOutOfResources if no cluster fits on the device,
// cudaErrorInvalidValue for shapes out of range, 0 on success.
int dlt_ring_project(const void* pix, const void* key, const void* p1,
                     const void* p2, void* okey, void* op1, void* op2,
                     int batch, int n, int n_pix, void* stream) {
  if (batch < 0 || batch > 65535 || n < 0 || n > kMaxN || n_pix < 1 ||
      n_pix > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(okey) | reinterpret_cast<uintptr_t>(op1) |
        reinterpret_cast<uintptr_t>(op2)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per device, so that a call under CUDA-graph capture makes no new
  // runtime query or setting
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(checked_mu);
    if (!checked[dev]) {
      err = cudaFuncSetAttribute(ring_select_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
      if (err != cudaSuccess) return err;
      if (kCluster > 8) {
        err = cudaFuncSetAttribute(
            ring_select_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
      }
      int fits = 0;
      err = cudaOccupancyMaxActiveClusters(
          &fits, (void*)ring_select_kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (fits < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
      checked[dev] = true;
    }
  }
  return cudaLaunchKernelEx(
      &cfg, ring_select_kernel, static_cast<const int*>(pix),
      static_cast<const int*>(key), static_cast<const int*>(p1),
      static_cast<const int*>(p2), static_cast<int*>(okey),
      static_cast<int*>(op1), static_cast<int*>(op2), n, n_pix);
}

}  // extern "C"
