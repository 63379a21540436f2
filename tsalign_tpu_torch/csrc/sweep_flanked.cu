// Flank-layered primary sweep (gap-affine wavefront over F = L + R + 1 flank
// layers, int32 saturating (min,+)).
//
// Replaces the TPU kernel tsalign_tpu/ops/pallas_sweep.py::sweep_pallas_flanked
// (_flanked_kernel).  It computes what that kernel computes; the 8-row
// sublane packing, the iota row select, the 128-lane padding of the deletion
// costs and the whole-field on-chip residency of the TPU kernel are not
// carried over: rows stream from device memory, so there is no size cap.
//
// Arguments: subs (3, n_rows, Wq) substitution rows of the (primary,
// left-flank, right-flank) tables, ddrows (n_rows, 6) del open/extend per
// table, io/ie (3, Wq) ins open/extend per table, seeds and out of logical
// shape (n_rows, 3F, Wq), plane 3 * fi + gap with gaps NONE=0, INS=1, DEL=2.
// Seeds and out are addressed through a row stride and a plane stride (in
// elements, columns contiguous), so the kernel reads and writes either the
// row-major layout of the TPU kernel or the engine's plane-major field
// (F, 3, n_rows, Wq) in place, with no transposed copy on either side.
//
// For each row r the layers run bottom-up, fi = 0 .. F-1, flank f = fi - R:
//   * layer f = 0 takes the primary diagonal and deletion from its own
//     previous row and runs the in-row insertion chain;
//   * a climbing layer (right-flank table for -R < f <= 0 with R > 0,
//     left-flank table for f > 0 when `climb`) also takes, from layer fi - 1,
//     the diagonal and the deletion out of the previous row and ONE insertion
//     step out of the current row (columns j - 1 -> j);
//   * layer f = -R, and every f > 0 when `climb` is off, holds its seeds.
// At f = 0 with R > 0 the chain's candidates are the min of the seed, the
// climb insertion and the in-row open.  Every add is clamped to DEV_INF in the
// JAX package's order.
//
// What bounds it: by bytes the work is small (seeds read once, out written
// once: 28 MB at 501 x 15 x 421, some microseconds at the H100's memory
// rate), but rows are serial, layers within a row are serial (each reads the
// finished current row of the layer below), and one thread block runs one
// pair, so the kernel uses one SM of 132 and its time is rows x layers x the
// latency of a block barrier plus, once a row, the block scan of the chain.
// The design keeps that latency small: columns go across the block's threads
// (a contiguous run of columns per thread when Wq exceeds the block), the
// previous row and the layer below are read back from `out` (written at most
// a row earlier, so they sit in L1/L2), one barrier separates two layers,
// and the chain is the flankless kernel's: a serial chain over each thread's
// run plus one block-wide Hillis-Steele scan of the chain maps
// (c, e) o (c', e') = (min(c', c + e'), e + e') with e summed exactly in 64
// bits, which equals the serial recurrence bit for bit.  Filling the card
// (many pairs a launch, or anti-diagonal tiles over rows and layers) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr int NONE = 0, INS = 1, DEL = 2;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ int sat(int a, int b) { return min(a + b, DEV_INF); }

__device__ __forceinline__ int sat64(int c, long long e) {
  long long v = (long long)c + e;
  return v < (long long)DEV_INF ? (int)v : DEV_INF;
}

__global__ void sweep_flanked_kernel(const int* __restrict__ subs,
                                     const int* __restrict__ ddrows,
                                     const int* __restrict__ seeds,
                                     const int* __restrict__ io,
                                     const int* __restrict__ ie,
                                     int* out, int n_rows, int Wq, int L, int R,
                                     int climb, long long row_stride,
                                     long long plane_stride) {
  __shared__ int s_c[MAX_THREADS];
  __shared__ long long s_e[MAX_THREADS];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (Wq + nt - 1) / nt;
  const int j0 = min(tid * per, Wq);
  const int j1 = min(j0 + per, Wq);
  const int F = L + R + 1;
  const size_t table = (size_t)n_rows * Wq;
  const int* io_p = io;
  const int* ie_p = ie;

  for (int r = 0; r < n_rows; ++r) {
    const int* seed_row = seeds + (long long)r * row_stride;
    int* cur_row = out + (long long)r * row_stride;
    const int* prev_row = out + (long long)(r - 1) * row_stride;  // r >= 1

    for (int fi = 0; fi < F; ++fi) {
      const int f = fi - R;
      int ct = -1;  // table of the climb edges into this layer, or none
      if ((f > -R && f < 0) || (f == 0 && R > 0)) ct = 2;
      else if (f > 0 && climb) ct = 1;
      const bool primary = f == 0;

      const int* seed = seed_row + (long long)(3 * fi) * plane_stride;
      int* cur = cur_row + (long long)(3 * fi) * plane_stride;
      const int* prev = prev_row + (long long)(3 * fi) * plane_stride;
      // Layer below: its previous row and its finished current row.
      const int* below_prev = prev - 3 * plane_stride;
      const int* below_cur = cur - 3 * plane_stride;
      const int* sub_p = subs + (size_t)r * Wq;
      const int p_open = ddrows[6 * r], p_ext = ddrows[6 * r + 1];
      const int* sub_c = ct >= 0 ? subs + ct * table + (size_t)r * Wq : nullptr;
      const int c_open = ct >= 0 ? ddrows[6 * r + 2 * ct] : DEV_INF;
      const int c_ext = ct >= 0 ? ddrows[6 * r + 2 * ct + 1] : DEV_INF;
      const int* io_c = ct >= 0 ? io + (size_t)ct * Wq : nullptr;
      const int* ie_c = ct >= 0 ? ie + (size_t)ct * Wq : nullptr;

      // Phase A: none and del, and the insertion candidate before the chain.
      for (int j = j0; j < j1; ++j) {
        int none = seed[NONE * plane_stride + j];
        int ins = seed[INS * plane_stride + j];
        int del = seed[DEL * plane_stride + j];
        if (primary && r > 0) {
          const int pn = prev[NONE * plane_stride + j];
          const int pi = prev[INS * plane_stride + j];
          const int pd = prev[DEL * plane_stride + j];
          if (j > 0) {
            const int any = min(min(prev[NONE * plane_stride + j - 1],
                                    prev[INS * plane_stride + j - 1]),
                                prev[DEL * plane_stride + j - 1]);
            none = min(none, min(any + sub_p[j - 1], DEV_INF));
          }
          del = min(del, min(sat(min(pn, pi), p_open), sat(pd, p_ext)));
        }
        if (ct >= 0) {
          if (r > 0) {
            const int pn = below_prev[NONE * plane_stride + j];
            const int pi = below_prev[INS * plane_stride + j];
            const int pd = below_prev[DEL * plane_stride + j];
            if (j > 0) {
              const int any = min(min(below_prev[NONE * plane_stride + j - 1],
                                      below_prev[INS * plane_stride + j - 1]),
                                  below_prev[DEL * plane_stride + j - 1]);
              none = min(none, min(any + sub_c[j - 1], DEV_INF));
            }
            del = min(del, min(sat(min(pn, pi), c_open), sat(pd, c_ext)));
          }
          if (j > 0) {
            const int o = sat(min(below_cur[NONE * plane_stride + j - 1],
                                  below_cur[DEL * plane_stride + j - 1]),
                              io_c[j - 1]);
            const int e = sat(below_cur[INS * plane_stride + j - 1], ie_c[j - 1]);
            ins = min(ins, min(o, e));
          }
        }
        cur[NONE * plane_stride + j] = none;
        cur[INS * plane_stride + j] = ins;  // final unless this is layer f = 0
        cur[DEL * plane_stride + j] = del;
      }
      __syncthreads();
      if (!primary) continue;

      // Phase B (layer f = 0): this thread's chain map over its columns.
      // cand[j] = min(ins before the chain, min(none, del)[j-1] + io[j-1]).
      int c_agg = DEV_INF;
      long long e_agg = 0;
      for (int j = j0; j < j1; ++j) {
        int cand = cur[INS * plane_stride + j];
        long long ext = DEV_INF;
        if (j > 0) {
          const int open_src = min(cur[NONE * plane_stride + j - 1],
                                   cur[DEL * plane_stride + j - 1]);
          cand = min(cand, sat(open_src, io_p[j - 1]));
          ext = ie_p[j - 1];
        }
        c_agg = min(cand, sat64(c_agg, ext));
        e_agg += ext;
      }
      s_c[tid] = c_agg;
      s_e[tid] = e_agg;
      __syncthreads();

      // Phase C: inclusive block scan of the chain maps (Hillis-Steele).
      for (int off = 1; off < nt; off <<= 1) {
        int cl = DEV_INF;
        long long el = 0;
        if (tid >= off) {
          cl = s_c[tid - off];
          el = s_e[tid - off];
        }
        __syncthreads();
        if (tid >= off) {
          s_c[tid] = min(s_c[tid], sat64(cl, s_e[tid]));
          s_e[tid] = el + s_e[tid];
        }
        __syncthreads();
      }

      // Phase D: rerun the run's chain from the incoming value; write ins.
      int d = tid > 0 ? s_c[tid - 1] : DEV_INF;
      for (int j = j0; j < j1; ++j) {
        int cand = cur[INS * plane_stride + j];
        long long ext = DEV_INF;
        if (j > 0) {
          const int open_src = min(cur[NONE * plane_stride + j - 1],
                                   cur[DEL * plane_stride + j - 1]);
          cand = min(cand, sat(open_src, io_p[j - 1]));
          ext = ie_p[j - 1];
        }
        d = min(cand, sat64(d, ext));
        cur[INS * plane_stride + j] = d;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int tsa_sweep_flanked(const int* subs, const int* ddrows,
                                 const int* seeds, const int* io, const int* ie,
                                 int* out, int n_rows, int Wq, int L, int R,
                                 int climb, long long row_stride,
                                 long long plane_stride, void* stream) {
  int threads = ((Wq + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 32) threads = 32;
  sweep_flanked_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      subs, ddrows, seeds, io, ie, out, n_rows, Wq, L, R, climb, row_stride,
      plane_stride);
  return (int)cudaGetLastError();
}
