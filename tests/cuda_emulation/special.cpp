// common.cuh's lgamma_digamma built for the host (through cuda_runtime.h's
// emulation), for tests/test_torch_k3k2_emulation.py: lgamma(z) and
// digamma(z) of n arguments in float32 and float64; and the narrow float64
// K2's per-sample terms (ls_point64, ls_terms64) for
// tests/test_torch_narrow_emulation.py.
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
// sample i's terms at the point alpha[i]: log1p(mua), 1/(1 + mua),
// lgamma(y + c) - lgamma(c) - y log c, digamma(y + c) - digamma(c)
void ls_terms_f64(const double* y, const double* alpha, const double* mua,
                  double* l1p, double* r, double* lgd, double* dgd, int n) {
  for (int i = 0; i < n; ++i) {
    const dk::LsPoint64 k = dk::ls_point64(alpha[i]);
    dk::ls_terms64(y[i], mua[i], k, l1p[i], r[i], lgd[i], dgd[i]);
  }
}
}
