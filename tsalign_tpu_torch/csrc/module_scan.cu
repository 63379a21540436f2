// Cross-kind TSM module scan (int32 saturating (min,+)) for Hopper.
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
// the JAX package's order, and the result equals the plain version
// (ops/modules.py::module_scan_torch) bit for bit, also in [2^29, 2^30 - 1].
//
// Inputs: seedT (NB, C, W), lut (A, C, W), sdo/sde (C, W),
// pchar/pmask/io/ie (L, NB); output B (L+1, NB, C); skip_from (see below).
//
// What bounds it: the integer pipe's instruction rate (21 min/add operations a cell
// and level with secondary deletions; the inputs and the output are read and
// written once and are three orders of magnitude below the memory bound).
// What the design does about it:
//   * One warp runs one problem and keeps the three planes in registers; a
//     lane owns a run of K = ceil(W / 32) neighbouring offsets, and there is
//     one instantiation for every K up to 64, so no lane carries a slot it
//     does not need.  The 32 K - W < 32 slots left over are spread one to a
//     lane: the last lanes own K - 1 offsets and a "hole" in their slot
//     K - 1, which is held at DEV_INF by a handful of selects a level (not a
//     select a slot), passes the chain through (extension 0, no candidate)
//     and is bypassed by the diagonal's shuffle.
//   * A reverse kind is the forward recurrence on the mirrored offset
//     s = W - 1 - w, so only the loads differ by direction and both run the
//     same loop: the diagonal and the chain always move toward higher slots.
//   * Every clamped add is one DPX instruction: sat(a, b) is
//     __viaddmin_s32(a, b, DEV_INF) = min(a + b, DEV_INF), and a chain step
//     min(cand, sat(d, ext)) is __viaddmin_s32(d, ext, cand) since
//     cand <= DEV_INF.  Both operands are <= DEV_INF = 2^30 - 1, so a + b
//     <= 2^31 - 2 cannot leave int32 (the plain version makes the same
//     assumption for every add).
//   * The chain is a serial run over the lane's slots (32-bit, as above) plus
//     a warp scan of the chain maps (c, e) o (c', e') = (min(c', c + e'),
//     e + e').  The extension sums e depend on sde only, so their scan runs
//     once before the level loop in 64 bits; a level's scan step is then
//     min(c, cl + e) with e a per-lane constant, evaluated exactly in 32
//     bits as (cl < DEV_INF - e ? cl + e : DEV_INF) (see `ScanStep`).
//   * The open min(none, ins) + sdo is computed once a level (kept in the
//     deletion plane's registers between the two passes of the chain); the
//     emit's min3 is computed once, inside the step loop, and the step
//     writes the diagonal straight into the neighbouring slot's register.
//   * The level-invariant tables live on chip: the A + 1 LUT rows of the
//     block's column (all warps of a block share c) in shared memory, stored
//     [row][slot][lane] so that a level's read is conflict-free, padded with
//     a DEV_INF row for an invalid pchar, and beside them sdo and the
//     shifted sde, already DEV_INF outside [0, W) (the loops carry no bounds
//     test).  Shared-memory reads run beside the integer pipe: keeping sdo
//     and sde in registers instead was no faster a slot (K = 17 against
//     K = 19 on the H100) and cost 2 K registers.  The four per-level
//     scalars are loaded one level ahead.
//   * Exit from a dead state: after the emit of level l, a warp whose state
//     minimum m >= skip_from (> 0) writes DEV_INF to B[l+1..L, p, c] and
//     returns.  The caller proves that such a state cannot reach a value
//     below 2^29 again (ops/common.py::dead_state_threshold);
//     skip_from = 0 never skips and is the exact mode.  No block barrier
//     follows the table load, so warps leave one by one.
// The grid is ceil(NB / WARPS) x C blocks of WARPS = 8 warps.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr unsigned FULL = 0xffffffffu;
// Warps a block.  They share the column's tables, which argues for many; they
// leave at different levels in the skipping mode, which argues for few.  On
// the H100 at the main shapes 4 were 0.7 % slower than 8 in the exact mode and
// 1 % faster in the skipping mode (scripts/torch_port_scan_probe.py --define
// TSA_WARPS=4), so 8 stay.
#ifndef TSA_WARPS
#define TSA_WARPS 8
#endif
constexpr int WARPS = TSA_WARPS;
constexpr int MAX_K = 64;

// min(a + b, c); a, b <= DEV_INF, so the sum stays inside int32.
__device__ __forceinline__ int addmin(int a, int b, int c) { return __viaddmin_s32(a, b, c); }

// One step of the warp scan over chain maps, for this lane: the value
// min(cl + e, DEV_INF) for the neighbour's c = cl and this lane's constant
// extension sum e >= 0 (up to 32 * 64 * DEV_INF, held in 64 bits when it is
// made).  cl + e < DEV_INF iff cl < DEV_INF - e; when DEV_INF - e is below
// INT_MIN no int32 cl passes, else the sum lies in [cl, DEV_INF) and its low
// 32 bits are the sum.  A lane the step does not reach has thr = INT_MIN.
struct ScanStep {
  int thr;
  unsigned elo;
  __device__ __forceinline__ int apply(int cl) const {
    return cl < thr ? (int)((unsigned)cl + elo) : DEV_INF;
  }
};

// Up to K = 25 the kernel fits 128 registers (ptxas: 3 K + about 50), so
// 512 threads are resident on an SM; above that one block of 8 warps is.
template <int K>
constexpr int min_blocks() {
  return K <= 25 ? 512 / (WARPS * 32) : 1;
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32, min_blocks<K>())
module_scan_kernel(const int* __restrict__ seedT, const int* __restrict__ lut,
                   const int* __restrict__ sdo, const int* __restrict__ sde,
                   const int* __restrict__ pchar, const int* __restrict__ pmask,
                   const int* __restrict__ io, const int* __restrict__ ie,
                   int* __restrict__ out, int NB, int C, int W, int L, int A,
                   int fwd, int allow_sdel, int skip_from) {
  constexpr int KS = K * 32;
  extern __shared__ int smem[];
  int* sdo_s = smem;            // [slot][lane]
  int* ext_s = smem + KS;       // [slot][lane]
  int* lut_s = smem + 2 * KS;   // [row][slot][lane], row A all DEV_INF

  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int c = blockIdx.y;
  // Lanes below `full` own K offsets, the others K - 1 and a hole.
  const int full = W - 32 * (K - 1);  // in [1, 32]

  // --- the block's level-invariant tables, in slot order ---------------------
  for (int i = threadIdx.x; i < KS; i += WARPS * 32) {
    const int k = i >> 5, l = i & 31;
    const int s = l * K - max(0, l - full) + k;
    const bool valid = k < K - (l >= full ? 1 : 0);
    const int w = fwd ? s : W - 1 - s;
    const int wprev = fwd ? s - 1 : W - s;  // the offset in slot s - 1
    sdo_s[i] = valid ? sdo[(size_t)c * W + w] : DEV_INF;
    ext_s[i] = !valid ? 0 : (s == 0 ? DEV_INF : sde[(size_t)c * W + wprev]);
    for (int a = 0; a < A; ++a)
      lut_s[a * KS + i] = valid ? lut[((size_t)a * C + c) * W + w] : DEV_INF;
    lut_s[A * KS + i] = DEV_INF;
  }
  __syncthreads();
  if (p >= NB) return;  // whole warps leave; no block barrier below

  const bool hole = lane >= full;
  const int base = lane * K - max(0, lane - full);
  const int* seed = seedT + ((size_t)p * C + c) * W;

  int Tn[K], Ti[K], Td[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    const bool valid = k < K - 1 || !hole;
    Tn[k] = valid ? seed[fwd ? s : W - 1 - s] : DEV_INF;
    Ti[k] = DEV_INF;
    Td[k] = DEV_INF;
  }
#define SDO(k) sdo_s[(k) * 32 + lane]
#define EXT(k) ext_s[(k) * 32 + lane]

  // --- the scan of the extension sums, once ----------------------------------
  ScanStep scan[5];
  {
    long long e = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) e += EXT(k);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int off = 1 << i;
      const long long room = (long long)DEV_INF - e;
      scan[i].thr = (lane >= off && room > (long long)INT_MIN) ? (int)room : INT_MIN;
      scan[i].elo = (unsigned)e;
      const long long el = __shfl_up_sync(FULL, e, off);
      if (lane >= off) e += el;
    }
  }

  const int dead_from = skip_from > 0 ? skip_from : INT_MAX;
  int pc = 0, pm = 0, iov = 0, iev = 0;
  if (L > 0) {
    pc = pchar[p];
    pm = pmask[p];
    iov = io[p];
    iev = ie[p];
  }

  for (int lvl = 0;; ++lvl) {
    // the next level's scalars, asked for before this level's arithmetic
    int pc_n = 0, pm_n = 0, io_n = 0, ie_n = 0;
    if (lvl + 1 < L) {
      const size_t li = (size_t)(lvl + 1) * NB + p;
      pc_n = pchar[li];
      pm_n = pmask[li];
      io_n = io[li];
      ie_n = ie[li];
    }

    // --- close: the secondary-deletion chain toward higher slots -------------
    if (allow_sdel) {
      // open[k] = min(none, ins) + sdo, parked in the deletion plane
#pragma unroll
      for (int k = 0; k < K; ++k) Td[k] = addmin(min(Tn[k], Ti[k]), SDO(k), DEV_INF);
      // the candidate of slot k is the open of the slot below it
      int edge = Td[K - 1];
      if (K >= 2) edge = hole ? Td[K - 2] : edge;
      int po_in = __shfl_up_sync(FULL, edge, 1);
      if (lane == 0) po_in = DEV_INF;
      // a hole takes no candidate and extension 0, so the chain passes it
      const int po_last = hole ? DEV_INF : (K >= 2 ? Td[K - 2] : po_in);
      int cagg = DEV_INF;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int po = k == K - 1 ? po_last : (k == 0 ? po_in : Td[k - 1]);
        cagg = addmin(cagg, EXT(k), po);
      }
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int cl = __shfl_up_sync(FULL, cagg, 1 << i);
        cagg = min(cagg, scan[i].apply(cl));
      }
      int d = __shfl_up_sync(FULL, cagg, 1);
      if (lane == 0) d = DEV_INF;
      int below = po_in;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int po = k == K - 1 ? po_last : below;
        below = Td[k];
        d = addmin(d, EXT(k), po);
        Td[k] = d;
      }
      if (hole) Td[K - 1] = DEV_INF;
    }

    if (lvl == L) {
      // --- the last emit ------------------------------------------------------
      int m = DEV_INF;
#pragma unroll
      for (int k = 0; k < K; ++k) m = min(m, __vimin3_s32(Tn[k], Ti[k], Td[k]));
      m = __reduce_min_sync(FULL, m);
      if (lane == 0) out[((size_t)lvl * NB + p) * C + c] = m;
      return;
    }

    // --- emit and step, highest slot first so the diagonal lands in place ----
    const int* lrow = lut_s + (size_t)((unsigned)pc < (unsigned)A ? pc : A) * KS + lane;
    int m = DEV_INF;
    int top = DEV_INF;  // the diagonal leaving slot K - 1
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int nd = min(Tn[k], Td[k]);
      const int any = min(nd, Ti[k]);
      m = min(m, any);
      const int sub = addmin(lrow[k * 32], pm, DEV_INF);
      const int diag = addmin(any, sub, DEV_INF);
      Ti[k] = addmin(Ti[k], iev, addmin(nd, iov, DEV_INF));
      if (k == K - 1) top = diag; else Tn[k + 1] = diag;
    }
    // the diagonal of the lane's last offset goes to the next lane
    int e = top;
    if (K >= 2) e = hole ? Tn[K - 1] : top;
    e = __shfl_up_sync(FULL, e, 1);
    Tn[0] = lane == 0 ? DEV_INF : e;
    if (hole) {
      Tn[K - 1] = DEV_INF;
      Ti[K - 1] = DEV_INF;
    }
    m = __reduce_min_sync(FULL, m);
    if (lane == 0) out[((size_t)lvl * NB + p) * C + c] = m;
    if (m >= dead_from) {
      for (int j = lvl + 1 + lane; j <= L; j += 32)
        out[((size_t)j * NB + p) * C + c] = DEV_INF;
      return;
    }
    pc = pc_n;
    pm = pm_n;
    iov = io_n;
    iev = ie_n;
  }
#undef SDO
#undef EXT
}

template <int K>
int launch(const int* seedT, const int* lut, const int* sdo, const int* sde,
           const int* pchar, const int* pmask, const int* io, const int* ie,
           int* out, int NB, int C, int W, int L, int A, int fwd, int allow_sdel,
           int skip_from, size_t smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        module_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((NB + WARPS - 1) / WARPS, C);
  module_scan_kernel<K><<<grid, WARPS * 32, smem_bytes, stream>>>(
      seedT, lut, sdo, sde, pchar, pmask, io, ie, out, NB, C, W, L, A, fwd,
      allow_sdel, skip_from);
  return (int)cudaGetLastError();
}

// Shared memory a launch needs: sdo, the shifted sde and A + 1 LUT rows of
// 32 K words each.
size_t table_bytes(int W, int A) {
  return (size_t)(A + 3) * ((W + 31) / 32) * 32 * sizeof(int);
}

}  // namespace

// Returns cudaGetLastError() after the launch; cudaErrorInvalidValue when W
// exceeds the widest instantiation (32 * 64 offsets) or the tables exceed a
// block's shared memory.  skip_from = 0 never leaves a problem early.
extern "C" int tsa_module_scan(const int* seedT, const int* lut, const int* sdo,
                               const int* sde, const int* pchar,
                               const int* pmask, const int* io, const int* ie,
                               int* out, int NB, int C, int W, int L, int A,
                               int fwd, int allow_sdel, int skip_from,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (NB == 0 || C == 0) return 0;
  if (W < 1 || W > 32 * MAX_K || A < 0) return (int)cudaErrorInvalidValue;
  const size_t smem_bytes = table_bytes(W, A);
  if (smem_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int k = (W + 31) / 32;
  switch (k) {
#define TSA_CASE(KK)                                                           \
  case KK:                                                                     \
    return launch<KK>(seedT, lut, sdo, sde, pchar, pmask, io, ie, out, NB, C,  \
                      W, L, A, fwd, allow_sdel, skip_from, smem_bytes, s);
#define TSA_CASE4(K0) TSA_CASE(K0) TSA_CASE(K0 + 1) TSA_CASE(K0 + 2) TSA_CASE(K0 + 3)
#define TSA_CASE16(K0) TSA_CASE4(K0) TSA_CASE4(K0 + 4) TSA_CASE4(K0 + 8) TSA_CASE4(K0 + 12)
    TSA_CASE16(1)
    TSA_CASE16(17)
    TSA_CASE16(33)
    TSA_CASE16(49)
#undef TSA_CASE16
#undef TSA_CASE4
#undef TSA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
