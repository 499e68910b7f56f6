// Host slot binning for the slot-aligned projection routes (the port's
// copy of deeplio_tpu/native/slot_bin_core.cpp, same code): bin a raw
// LiDAR scan onto the fixed [H rings x W*spp azimuth-slots] grid that
// ops/projection.py::project_batch_ring_aligned_planes and
// project_batch_ring_halves_planes read, keeping each pixel's spp best
// candidates by (quantized range, original index), best first.
//
// Semantics mirror data/synthetic.py::slot_bin_scan_np (the numpy oracle)
// exactly, except the yaw/pitch transcendentals (slot_bin_trig.cpp, a
// few ulp). THIS translation unit is compiled WITHOUT fast-math and with
// -ffp-contract=off so every f32 op that feeds an integer decision
// (floor/clip binning, range quantization) is bit-identical to numpy's
// IEEE arithmetic.
//
// O(N*spp) insertion with no sort; the ctypes caller releases the GIL;
// OpenMP across scans in the batch entry point.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" void dlt_yaw_pitch(const float*, const float*, const float*,
                              int64_t, float*, float*);

namespace {

// Selection + placement from precomputed integer keys. Exposed for
// bit-exact logic tests (no trig involved). layout: 0 = interleaved
// slots (pos = pix*spp + rank), 1 = dual-half (pos = rank*n_pix + pix).
void select_place(const int32_t* pix, const int32_t* rq, const uint8_t* ok,
                  int64_t n, int32_t n_pix, int32_t spp, int32_t layout,
                  int32_t* best_rq, int32_t* best_src, int32_t* out_src) {
  const int64_t cap = (int64_t)n_pix * spp;
  for (int64_t s = 0; s < cap; s++) best_rq[s] = INT32_MAX;
  for (int64_t i = 0; i < n; i++) {
    if (!ok[i]) continue;
    const int64_t base = (int64_t)pix[i] * spp;
    const int32_t r = rq[i];
    // index order of the pass makes ties first-point-wins: insert after
    // any entry with best_rq <= r (equal rq => earlier index ranks
    // first), shifting the tail down.
    int32_t k = spp;
    while (k > 0 && best_rq[base + k - 1] > r) k--;
    if (k == spp) continue;  // loses to every kept candidate
    for (int32_t j = spp - 1; j > k; j--) {
      best_rq[base + j] = best_rq[base + j - 1];
      best_src[base + j] = best_src[base + j - 1];
    }
    best_rq[base + k] = r;
    best_src[base + k] = (int32_t)i;
  }
  for (int32_t p = 0; p < n_pix; p++)
    for (int32_t k = 0; k < spp; k++) {
      const int64_t pos =
          layout ? (int64_t)k * n_pix + p : (int64_t)p * spp + k;
      out_src[pos] =
          best_rq[(int64_t)p * spp + k] == INT32_MAX ? -1 : best_src[(int64_t)p * spp + k];
    }
}

}  // namespace

extern "C" {

// Bit-exact-logic test hook: selection/placement from caller-provided
// (pix, rq, ok) arrays. out_src[pos] = source point index or -1.
void dlt_slot_bin_from_keys(const int32_t* pix, const int32_t* rq,
                            const uint8_t* ok, int64_t n, int32_t n_pix,
                            int32_t spp, int32_t layout, int32_t* out_src) {
  std::vector<int32_t> best_rq((size_t)n_pix * spp);
  std::vector<int32_t> best_src((size_t)n_pix * spp);
  select_place(pix, rq, ok, n, n_pix, spp, layout, best_rq.data(),
               best_src.data(), out_src);
}

// Full scan binning. pts: [n,4] f32 row-major (x,y,z,remission);
// valid: [n] uint8. out: [H*W*spp, 4] f32; out_valid: [H*W*spp] uint8.
// rq_scale / rq_hi come from the device key layout
// (ops/projection.py::_idx_key_layout): rq = clip(int(r*rq_scale), 0,
// rq_hi). layout: 0 slots, 1 halves (see select_place).
void dlt_slot_bin_scan(const float* pts, const uint8_t* valid, int64_t n,
                       int32_t H, int32_t W, int32_t spp, float fov_up_deg,
                       float fov_down_deg, float rq_scale, int32_t rq_hi,
                       int32_t layout, float* out, uint8_t* out_valid) {
  const int32_t n_pix = H * W;
  const int64_t cap = (int64_t)n_pix * spp;
  std::vector<float> yaw(n), pitch(n), xs(n), ys(n), zs(n);
  for (int64_t i = 0; i < n; i++) {  // AoS -> planes for the simd pass
    xs[i] = pts[i * 4 + 0];
    ys[i] = pts[i * 4 + 1];
    zs[i] = pts[i * 4 + 2];
  }
  dlt_yaw_pitch(xs.data(), ys.data(), zs.data(), n, yaw.data(),
                pitch.data());

  // exact f32 arithmetic (matches the numpy oracle op-for-op)
  const float pi = (float)M_PI;
  const float fov_down = (float)(fov_down_deg * (M_PI / 180.0));
  const float fov = (float)((fov_up_deg - fov_down_deg) * (M_PI / 180.0));
  std::vector<int32_t> pix(n), rq(n);
  std::vector<uint8_t> ok(n);
  for (int64_t i = 0; i < n; i++) {
    const float x = xs[i], y = ys[i], z = zs[i];
    const float r = sqrtf(x * x + y * y + z * z);
    ok[i] = valid[i] && (r > 1e-6f);
    float uf = floorf(0.5f * (1.0f - yaw[i] / pi) * (float)W);
    float vf = floorf((1.0f - (pitch[i] - fov_down) / fov) * (float)H);
    int32_t u = (int32_t)uf;
    int32_t v = (int32_t)vf;
    u = u < 0 ? 0 : (u > W - 1 ? W - 1 : u);
    v = v < 0 ? 0 : (v > H - 1 ? H - 1 : v);
    pix[i] = v * W + u;
    int64_t q = (int64_t)(r * rq_scale);
    rq[i] = (int32_t)(q < 0 ? 0 : (q > rq_hi ? rq_hi : q));
  }

  std::vector<int32_t> best_rq((size_t)cap), best_src((size_t)cap);
  std::vector<int32_t> out_src((size_t)cap);
  select_place(pix.data(), rq.data(), ok.data(), n, n_pix, spp, layout,
               best_rq.data(), best_src.data(), out_src.data());

  std::memset(out, 0, (size_t)cap * 4 * sizeof(float));
  std::memset(out_valid, 0, (size_t)cap);
  for (int64_t pos = 0; pos < cap; pos++) {
    const int32_t src = out_src[pos];
    if (src < 0) continue;
    std::memcpy(out + pos * 4, pts + (int64_t)src * 4, 4 * sizeof(float));
    out_valid[pos] = 1;
  }
}

// Batch entry point: n_scans independent scans, OpenMP across scans.
void dlt_slot_bin_batch(const float* pts, const uint8_t* valid,
                        int64_t n_scans, int64_t n, int32_t H, int32_t W,
                        int32_t spp, float fov_up_deg, float fov_down_deg,
                        float rq_scale, int32_t rq_hi, int32_t layout,
                        float* out, uint8_t* out_valid) {
  const int64_t cap = (int64_t)H * W * spp;
#pragma omp parallel for schedule(dynamic)
  for (int64_t s = 0; s < n_scans; s++) {
    dlt_slot_bin_scan(pts + s * n * 4, valid + s * n, n, H, W, spp,
                      fov_up_deg, fov_down_deg, rq_scale, rq_hi, layout,
                      out + s * cap * 4, out_valid + s * cap);
  }
}

}  // extern "C"
