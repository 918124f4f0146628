// common.cuh's lgamma_digamma built for the host (through cuda_runtime.h's
// emulation), for tests/test_torch_k3k2_emulation.py: lgamma(z) and
// digamma(z) of n arguments in float32 and float64.
#include <cuda_runtime.h>

#include "common.cuh"

template <typename T>
static void lgdg(const T* z, T* lg, T* dg, int n) {
  for (int i = 0; i < n; ++i) {
    const dk::LgDg<T> f = dk::lgamma_digamma(z[i]);
    lg[i] = f.lg;
    dg[i] = f.dg;
  }
}

extern "C" {
void lgdg_f32(const float* z, float* lg, float* dg, int n) {
  lgdg(z, lg, dg, n);
}
void lgdg_f64(const double* z, double* lg, double* dg, int n) {
  lgdg(z, lg, dg, n);
}
}
