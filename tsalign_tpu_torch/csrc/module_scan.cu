// Cross-kind TSM module scan (int32 saturating (min,+)).
//
// Replaces the TPU kernel tsalign_tpu/ops/pallas_module.py::module_scan_pallas
// (_module_kernel).  For each problem (entry row p, chunk column c), three gap
// planes over the W secondary offsets are carried through L levels.  Each
// level closes secondary deletions with the chain
//   D[w] = min(cand[w], D[w -/+ 1] + sde[w -/+ 1])   (forward: from w-1)
// where cand is the shifted open min(none, ins) + sdo (only if allow_sdel),
// emits min over planes and w into B[level, p, c], then steps:
//   none' = shift+-1(min3 + lut[pchar][c] + pmask)
//   ins'  = min(min(none, del) + io, ins + ie),   del' = INF.
// A final close-and-emit gives level L.  Every add is clamped to DEV_INF in
// the JAX package's order.
//
// Inputs: seedT (NB, C, W), lut (A, C, W), sdo/sde (C, W),
// pchar/pmask/io/ie (L, NB); output B (L+1, NB, C).
//
// What bounds it: integer min/add throughput.  A 1000 x 1000 pair under the
// default configuration runs about 1001 x 64 x 1101 cell updates per level
// and chunk, each some 25 int32 operations, and reads little from memory (the
// LUT row of one column per level, shared by the warps of a block through L1).
// The design keeps all carried state in registers: one warp runs one problem,
// each lane holds a contiguous run of K = ceil(W / 32) offsets of the none and
// ins planes, the deletion chain is a serial chain over each run plus one warp
// scan of the chain maps (c, e) o (c', e') = (min(c', c + e'), e + e') with
// e summed exactly in 64 bits (equal to the serial recurrence bit for bit),
// the +-1 shift crosses lanes with one shuffle, and the per-level emit is a
// warp min.  The grid is NB x C warps (about 64k for a 1000 bp chunk), which
// fills the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

__device__ __forceinline__ int sat(int a, int b) { return min(a + b, DEV_INF); }

__device__ __forceinline__ int sat64(int c, long long e) {
  long long v = (long long)c + e;
  return v < (long long)DEV_INF ? (int)v : DEV_INF;
}

template <int K>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
module_scan_kernel(const int* __restrict__ seedT, const int* __restrict__ lut,
                   const int* __restrict__ sdo, const int* __restrict__ sde,
                   const int* __restrict__ pchar, const int* __restrict__ pmask,
                   const int* __restrict__ io, const int* __restrict__ ie,
                   int* __restrict__ out, int NB, int C, int W, int L, int A,
                   int fwd, int allow_sdel) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int c = blockIdx.y;
  if (p >= NB) return;  // whole warps leave together; no block barriers below
  const int base = lane * K;
  const size_t CW = (size_t)C * W;
  const int* seed = seedT + ((size_t)p * C + c) * W;
  const int* lutc = lut + (size_t)c * W;
  const int* sdoc = sdo + (size_t)c * W;
  const int* sdec = sde + (size_t)c * W;

  int Tn[K], Ti[K], Td[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = base + k;
    Tn[k] = w < W ? seed[w] : DEV_INF;
    Ti[k] = DEV_INF;
    Td[k] = DEV_INF;
  }

  for (int lvl = 0;; ++lvl) {
    // --- close: secondary-deletion chain along w ---------------------------
    if (allow_sdel) {
      if (fwd) {
        // cand[w] = open[w-1], ext[w] = sde[w-1]; open[w] = min(Tn,Ti)[w] + sdo[w]
        const int wl = base + K - 1;
        int edge = wl < W ? sat(min(Tn[K - 1], Ti[K - 1]), sdoc[wl]) : DEV_INF;
        int po0 = __shfl_up_sync(FULL, edge, 1);
        if (lane == 0) po0 = DEV_INF;
        int cagg = DEV_INF;
        long long eagg = 0;
        int po = po0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int w = base + k;
          const long long ext = (w == 0 || w - 1 >= W) ? DEV_INF : sdec[w - 1];
          cagg = min(po, sat64(cagg, ext));
          eagg += ext;
          po = w < W ? sat(min(Tn[k], Ti[k]), sdoc[w]) : DEV_INF;
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int cl = __shfl_up_sync(FULL, cagg, off);
          const long long el = __shfl_up_sync(FULL, eagg, off);
          if (lane >= off) {
            cagg = min(cagg, sat64(cl, eagg));
            eagg = el + eagg;
          }
        }
        int d = __shfl_up_sync(FULL, cagg, 1);
        if (lane == 0) d = DEV_INF;
        po = po0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int w = base + k;
          const long long ext = (w == 0 || w - 1 >= W) ? DEV_INF : sdec[w - 1];
          d = min(po, sat64(d, ext));
          po = w < W ? sat(min(Tn[k], Ti[k]), sdoc[w]) : DEV_INF;
          Td[k] = w < W ? d : DEV_INF;
        }
      } else {
        // cand[w] = open[w+1], ext[w] = sde[w+1], chain from the top end
        int edge = base < W ? sat(min(Tn[0], Ti[0]), sdoc[base]) : DEV_INF;
        int po0 = __shfl_down_sync(FULL, edge, 1);
        if (lane == 31) po0 = DEV_INF;
        int cagg = DEV_INF;
        long long eagg = 0;
        int po = po0;
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          const int w = base + k;
          const long long ext = (w + 1 >= W) ? DEV_INF : sdec[w + 1];
          cagg = min(po, sat64(cagg, ext));
          eagg += ext;
          po = w < W ? sat(min(Tn[k], Ti[k]), sdoc[w]) : DEV_INF;
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int cl = __shfl_down_sync(FULL, cagg, off);
          const long long el = __shfl_down_sync(FULL, eagg, off);
          if (lane + off < 32) {
            cagg = min(cagg, sat64(cl, eagg));
            eagg = el + eagg;
          }
        }
        int d = __shfl_down_sync(FULL, cagg, 1);
        if (lane == 31) d = DEV_INF;
        po = po0;
#pragma unroll
        for (int k = K - 1; k >= 0; --k) {
          const int w = base + k;
          const long long ext = (w + 1 >= W) ? DEV_INF : sdec[w + 1];
          d = min(po, sat64(d, ext));
          po = w < W ? sat(min(Tn[k], Ti[k]), sdoc[w]) : DEV_INF;
          Td[k] = w < W ? d : DEV_INF;
        }
      }
    }

    // --- emit: min over the three planes and w ------------------------------
    int m = DEV_INF;
#pragma unroll
    for (int k = 0; k < K; ++k) m = min(m, min(min(Tn[k], Ti[k]), Td[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(FULL, m, off));
    if (lane == 0) out[((size_t)lvl * NB + p) * C + c] = m;
    if (lvl == L) break;

    // --- step to the next level ---------------------------------------------
    const size_t li = (size_t)lvl * NB + p;
    const int pc = pchar[li];
    const int pm = pmask[li];
    const int iov = io[li];
    const int iev = ie[li];
    const int* lrow = (pc >= 0 && pc < A) ? lutc + (size_t)pc * CW : nullptr;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w = base + k;
      const int sub = (lrow != nullptr && w < W) ? min(lrow[w] + pm, DEV_INF) : DEV_INF;
      const int any = min(min(Tn[k], Ti[k]), Td[k]);
      const int ins = min(sat(min(Tn[k], Td[k]), iov), sat(Ti[k], iev));
      Tn[k] = w < W ? sat(any, sub) : DEV_INF;  // diag, shifted below
      Ti[k] = w < W ? ins : DEV_INF;
      Td[k] = DEV_INF;
    }
    if (fwd) {
      int e = __shfl_up_sync(FULL, Tn[K - 1], 1);
#pragma unroll
      for (int k = K - 1; k > 0; --k) Tn[k] = Tn[k - 1];
      Tn[0] = lane == 0 ? DEV_INF : e;
    } else {
      int e = __shfl_down_sync(FULL, Tn[0], 1);
#pragma unroll
      for (int k = 0; k < K - 1; ++k) Tn[k] = Tn[k + 1];
      Tn[K - 1] = lane == 31 ? DEV_INF : e;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (base + k >= W) Tn[k] = DEV_INF;
  }
}

template <int K>
int launch(const int* seedT, const int* lut, const int* sdo, const int* sde,
           const int* pchar, const int* pmask, const int* io, const int* ie,
           int* out, int NB, int C, int W, int L, int A, int fwd, int allow_sdel,
           cudaStream_t stream) {
  dim3 grid((NB + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, C);
  module_scan_kernel<K><<<grid, WARPS_PER_BLOCK * 32, 0, stream>>>(
      seedT, lut, sdo, sde, pchar, pmask, io, ie, out, NB, C, W, L, A, fwd,
      allow_sdel);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue when W
// exceeds the widest instantiation (32 * 64 offsets).
extern "C" int tsa_module_scan(const int* seedT, const int* lut, const int* sdo,
                               const int* sde, const int* pchar,
                               const int* pmask, const int* io, const int* ie,
                               int* out, int NB, int C, int W, int L, int A,
                               int fwd, int allow_sdel, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (NB == 0 || C == 0) return 0;
  const int k = (W + 31) / 32;
#define TSA_LAUNCH(KK)                                                        \
  if (k <= KK)                                                                \
    return launch<KK>(seedT, lut, sdo, sde, pchar, pmask, io, ie, out, NB, C, \
                      W, L, A, fwd, allow_sdel, s);
  TSA_LAUNCH(1)
  TSA_LAUNCH(2)
  TSA_LAUNCH(4)
  TSA_LAUNCH(8)
  TSA_LAUNCH(16)
  TSA_LAUNCH(24)
  TSA_LAUNCH(36)
  TSA_LAUNCH(48)
  TSA_LAUNCH(64)
#undef TSA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
