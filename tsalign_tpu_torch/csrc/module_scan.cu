// The module scan's entry points for its shared-memory variants: the plan of
// a launch and the launch.  The kernel and its layout are in module_scan.cuh;
// the global-memory variant's entry point is in module_scan_gmem.cu.

#include "module_scan.cuh"

// Offsets a lane (K), warps a problem (T), problems a block (G), shared
// bytes of a launch and whether its tables stay in device memory (gmem: the
// launch is tsa_module_scan_gmem's); returns 0, or cudaErrorInvalidValue past
// 8 warps a problem (W > 16,384).
extern "C" int tsa_module_scan_plan(int W, int A, int diag, int* K, int* T, int* G,
                                    long long* bytes, int* gmem) {
  Plan plan;
  if (!plan_of(W, A, diag, &plan)) return (int)cudaErrorInvalidValue;
  *K = plan.K;
  *T = plan.T;
  *G = plan.G;
  *bytes = (long long)plan.bytes;
  *gmem = plan.gmem ? 1 : 0;
  return 0;
}

// P problem sets of one shape.  Cross mode (diag = 0): seedT (P, NB, C, W),
// lut (P, A, C, W), sdo/sde (P, C, W), the per-level tables (L, P NBs), out
// (L+1, P NBs, C).  Diagonal mode (diag = 1, C ignored): seed (P, NB, W), lut
// (P, A, NB, W), sdo/sde (P, NB, W), the per-level tables (L, P NBs), out
// (L+1, P NBs).  NBs is NB for P = 1 and NB rounded up to a multiple of the
// plan's G for P > 1 (tsa_module_scan_plan); the padding is neither read nor
// written.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue past
// the plan's cap and where the plan keeps the tables in device memory.
// skip_from = 0 never leaves a problem early.
extern "C" int tsa_module_scan(const int* seedT, const int* lut, const int* sdo,
                               const int* sde, const int* pchar,
                               const int* pmask, const int* io, const int* ie,
                               int* out, int P, int NB, int C, int W, int L, int A,
                               int fwd, int allow_sdel, int skip_from, int diag,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 0 || NB == 0 || (!diag && C == 0)) return 0;
  Plan plan;
  if (!plan_of(W, A, diag, &plan) || plan.gmem) return (int)cudaErrorInvalidValue;
  if (plan.T == 1) {
    switch (plan.K) {
#define TSA_CASE(KK)                                                           \
  case KK:                                                                     \
    return launch<KK, false, false>(seedT, lut, sdo, sde, pchar, pmask, io, ie, \
                                    out, P, NB, C, W, L, A, fwd, allow_sdel,    \
                                    skip_from, diag, plan, s);
      TSA_CASE16(1)
      TSA_CASE16(17)
      TSA_CASE16(33)
      TSA_CASE16(49)
#undef TSA_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  // a wide problem has K > 32 * (T - 1) / T >= 32 offsets a lane
  switch (plan.K) {
#define TSA_CASE(KK)                                                           \
  case KK:                                                                     \
    return launch<KK, true, false>(seedT, lut, sdo, sde, pchar, pmask, io, ie,  \
                                   out, P, NB, C, W, L, A, fwd, allow_sdel,     \
                                   skip_from, diag, plan, s);
    TSA_CASE16(33)
    TSA_CASE16(49)
#undef TSA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
