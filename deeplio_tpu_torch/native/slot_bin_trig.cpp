// Vectorized spherical-angle pass of the host slot binning (the port's
// copy of deeplio_tpu/native/slot_bin_trig.cpp, same code).
//
// THIS translation unit is compiled with -Ofast -march=native so g++
// vectorizes atan2f/asinf through libmvec. Fast-math may perturb the
// transcendentals by a few ulp against numpy's; everything whose ulps
// feed integer decisions (range -> quantized key, the floor/clip binning
// arithmetic) lives in slot_bin_core.cpp, compiled WITHOUT fast-math and
// with -ffp-contract=off, so only the transcendental approximations can
// differ, and then only for points on a pixel boundary.

#include <cmath>
#include <cstdint>

extern "C" void dlt_yaw_pitch(
    const float* __restrict x, const float* __restrict y,
    const float* __restrict z, int64_t n,
    float* __restrict yaw, float* __restrict pitch) {
#pragma omp simd
  for (int64_t i = 0; i < n; i++) {
    yaw[i] = atan2f(y[i], x[i]);
    float ri = sqrtf(x[i] * x[i] + y[i] * y[i] + z[i] * z[i]);
    float d = z[i] / fmaxf(ri, 1e-9f);
    d = d > 1.f ? 1.f : (d < -1.f ? -1.f : d);
    pitch[i] = asinf(d);
  }
}
