// The module scan's global-memory variant (module_scan.cuh, GMEM): the
// instantiations for a problem whose tables do not fit a block's shared
// memory, built apart from the shared-memory variants' so that the two nvcc
// processes run side by side.

#include "module_scan.cuh"

// The arguments and layouts of tsa_module_scan (module_scan.cu).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue past the
// plan's cap and where the plan keeps the tables in shared memory.
extern "C" int tsa_module_scan_gmem(const int* seedT, const int* lut, const int* sdo,
                                    const int* sde, const int* pchar,
                                    const int* pmask, const int* io, const int* ie,
                                    int* out, int P, int NB, int C, int W, int L, int A,
                                    int fwd, int allow_sdel, int skip_from, int diag,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 0 || NB == 0 || (!diag && C == 0)) return 0;
  Plan plan;
  if (!plan_of(W, A, diag, &plan) || !plan.gmem) return (int)cudaErrorInvalidValue;
  // the variant runs the wide form's loop, K > 32 offsets a lane
  switch (plan.K) {
#define TSA_CASE(KK)                                                           \
  case KK:                                                                     \
    return launch<KK, true, true>(seedT, lut, sdo, sde, pchar, pmask, io, ie,  \
                                  out, P, NB, C, W, L, A, fwd, allow_sdel,     \
                                  skip_from, diag, plan, s);
    TSA_CASE16(33)
    TSA_CASE16(49)
#undef TSA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
