// Flankless primary sweep (gap-affine wavefront, int32 saturating (min,+)).
//
// Replaces the TPU kernels tsalign_tpu/ops/pallas_sweep.py::sweep_pallas_flankless
// (_sweep_kernel) and ::sweep_pallas_flankless_tiled (_sweep_kernel_tiled).
// The tiled TPU variant exists only to fit VMEM; here rows stream from device
// memory, so one kernel covers any row count.
//
// Layout (the Pallas one): sub_rows (n_rows, Wq), ddrows (n_rows, 2) del
// open/extend, seeds and out (n_rows, 3, Wq) with gap planes NONE=0, INS=1,
// DEL=2, io/ie (Wq).  For each row r:
//   none[j] = min(seed_n, min3(prev[j-1]) + sub[r][j-1])
//   del[j]  = min(seed_d, min(prev_n, prev_i)[j] + do, prev_d[j] + de)
//   ins     = chain D[j] = min(cand[j], D[j-1] + ie[j-1]),
//             cand[j] = min(seed_i, min(none, del)[j-1] + io[j-1])
// with every add clamped to DEV_INF in the JAX package's order.
//
// What bounds it: the row loop is serial, and one thread block runs one pair,
// so the kernel uses one SM of the H100's 132 and its time is the row count
// times the latency of one row (a few block barriers and a block scan), not
// bytes or operations.  The design keeps that latency small: columns go
// across the block's threads (a contiguous run of columns per thread), the
// previous row is read back from the output (it was written one barrier
// earlier and sits in L1/L2), and the insertion chain is a serial chain over
// each thread's run plus one block-wide scan of the chain maps
// (c, e) o (c', e') = (min(c', c + e'), e + e'), with e summed exactly in
// 64 bits so that the result equals the serial recurrence bit for bit.
// Filling the card (many pairs, or anti-diagonal tiles) is later work.

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

__global__ void sweep_flankless_kernel(const int* __restrict__ sub_rows,
                                       const int* __restrict__ ddrows,
                                       const int* __restrict__ seeds,
                                       const int* __restrict__ io,
                                       const int* __restrict__ ie,
                                       int* out, int n_rows, int Wq) {
  __shared__ int s_c[MAX_THREADS];
  __shared__ long long s_e[MAX_THREADS];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (Wq + nt - 1) / nt;
  const int j0 = min(tid * per, Wq);
  const int j1 = min(j0 + per, Wq);
  const size_t plane = (size_t)Wq;

  for (int r = 0; r < n_rows; ++r) {
    const int* seed = seeds + (size_t)r * 3 * plane;
    int* row = out + (size_t)r * 3 * plane;
    const int* prev = out + (size_t)(r - 1) * 3 * plane;  // valid for r >= 1
    const int d_open = ddrows[2 * r];
    const int d_ext = ddrows[2 * r + 1];
    const int* sub = sub_rows + (size_t)r * plane;

    // Phase A: none and del planes (previous row only).
    for (int j = j0; j < j1; ++j) {
      int pn = DEV_INF, pi = DEV_INF, pd = DEV_INF, diag = DEV_INF;
      if (r > 0) {
        pn = prev[NONE * plane + j];
        pi = prev[INS * plane + j];
        pd = prev[DEL * plane + j];
        if (j > 0) {
          int any = min(min(prev[NONE * plane + j - 1], prev[INS * plane + j - 1]),
                        prev[DEL * plane + j - 1]);
          diag = min(any + sub[j - 1], DEV_INF);
        }
      }
      int none = min(seed[NONE * plane + j], diag);
      int del_new = min(sat(min(pn, pi), d_open), sat(pd, d_ext));
      int del = min(seed[DEL * plane + j], del_new);
      row[NONE * plane + j] = none;
      row[DEL * plane + j] = del;
    }
    __syncthreads();

    // Phase B: this thread's chain map over its run of columns.
    int c_agg = DEV_INF;
    long long e_agg = 0;
    for (int j = j0; j < j1; ++j) {
      int cand = seed[INS * plane + j];
      long long ext = DEV_INF;
      if (j > 0) {
        int open_src = min(row[NONE * plane + j - 1], row[DEL * plane + j - 1]);
        cand = min(cand, sat(open_src, io[j - 1]));
        ext = ie[j - 1];
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
      int cand = seed[INS * plane + j];
      long long ext = DEV_INF;
      if (j > 0) {
        int open_src = min(row[NONE * plane + j - 1], row[DEL * plane + j - 1]);
        cand = min(cand, sat(open_src, io[j - 1]));
        ext = ie[j - 1];
      }
      d = min(cand, sat64(d, ext));
      row[INS * plane + j] = d;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tsa_sweep_flankless(const int* sub_rows, const int* ddrows,
                                   const int* seeds, const int* io,
                                   const int* ie, int* out, int n_rows, int Wq,
                                   void* stream) {
  int threads = ((Wq + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  if (threads < 32) threads = 32;
  sweep_flankless_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      sub_rows, ddrows, seeds, io, ie, out, n_rows, Wq);
  return (int)cudaGetLastError();
}
