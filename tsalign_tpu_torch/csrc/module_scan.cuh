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
// Two more forms of the same recurrence:
//   * the diagonal mode (same-sequence kinds, the plain version's 2-D seeds):
//     seed (NB, W), lut (A, NB, W), sdo/sde (NB, W), the per-level tables
//     (L, NB); problem b reads column b of the tables (p = c = b), and the
//     output is B (L+1, NB).  It is the cross-kind grid's diagonal, run
//     without the other NB - 1 columns;
//   * a pair axis: P problem sets of one shape, the seeds and the column
//     tables stacked on a leading axis, the per-level tables and the output
//     side by side on the problem axis, the sets one after the other on the
//     grid's y axis.
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
//   * Wide modules (W > 2048 = 32 x 64 offsets): a problem is held by
//     T = ceil(W / 2048) warps of one block, warp t a contiguous run of
//     offsets, K = ceil(W / 32 T) a lane, the holes spread over the
//     problem's last lanes as above.  Per level three things cross a warp
//     boundary, through shared memory with a named barrier of the problem's
//     T warps: the chain (each warp folds the totals of the warps before it
//     into its carry-in: the chain maps compose, and T <= 4), the diagonal
//     of a warp's last offset (into the next warp's first), and the emit's
//     minimum over W.  The skipping mode's exit is then the same decision in
//     all T warps.  The tables of such a problem are stored [lane][slot]
//     with an odd row stride (conflict-free, and a slot's address is an
//     immediate offset).  The cap left is the tables' shared memory:
//     (A + 3) x 32 T K x 4 bytes <= 227 KB, 7,264 offsets at A = 5 (the DNA
//     alphabet and its poison row) and 6,356 at A = 6.
//   * Past that cap (and wherever a problem's tables do not fit a block) the
//     global-memory variant (GMEM, a template constant like the modes) leaves
//     the tables where they are: each lane reads its slots' LUT entry, sdo
//     and shifted sde from device memory through the read-only path
//     (__ldg), L2-resident after the first level, and the block's shared
//     memory holds only the exchange area.  It runs the wide form's loop for
//     T = ceil(W / 2048) <= 8 warps a problem (16,384 offsets; also T = 1 at
//     K > 32), so its cap is the registers of a block's 8 warps.  It reads
//     three ints a slot and level from L2 where the shared variant reads
//     them from shared memory, so it is the slower of the two and runs only
//     where the other cannot.
// The grid is C x P ceil(NB / G) blocks of G problems of T warps each
// (G T <= 8 warps; G = 8 at W <= 2048 in the cross mode, fewer in the
// diagonal mode when G column table sets would not fit a block).  There is an
// instantiation for each K, one warp or several, cross or diagonal mode; the
// shared-memory variants' entry points are in module_scan.cu and the
// global-memory variant's in module_scan_gmem.cu, two translation units that
// nvcc builds side by side.

#pragma once

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
constexpr int MAX_T = 8;                 // warps a problem (the block's warps)
constexpr size_t MAX_SHARED = 232448;    // bytes of shared memory a block can take
// Of the exchange area of a wide problem: per level parity and warp, the
// chain's local total and the open of the warp's last offset, the diagonal
// leaving it, the emit's minimum; once, the warp's extension sum past its
// first slot (64 bits).
constexpr int XS_INTS = 2 * MAX_T * 4 + 2 * MAX_T;

// min(a + b, c); a, b <= DEV_INF, so the sum stays inside int32.
__device__ __forceinline__ int addmin(int a, int b, int c) { return __viaddmin_s32(a, b, c); }

// min(x + e, DEV_INF) for x <= DEV_INF and 0 <= e (64 bits).
__device__ __forceinline__ int sat64(int x, long long e) {
  const long long v = (long long)x + e;
  return v < DEV_INF ? (int)v : DEV_INF;
}

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
  __device__ __forceinline__ void set(long long e, bool reaches) {
    const long long room = (long long)DEV_INF - e;
    thr = (reaches && room > (long long)INT_MIN) ? (int)room : INT_MIN;
    elo = (unsigned)e;
  }
};

// Up to K = 25 the kernel fits 128 registers (ptxas: 3 K + about 50), so
// 512 threads are resident on an SM; above that one block of 8 warps is.
template <int K>
constexpr int min_blocks() {
  return K <= 25 ? 512 / (WARPS * 32) : 1;
}

// Ints of a table row (one int a slot): [slot][lane] for a one-warp problem,
// [lane][slot] with an odd stride for a wide one.
template <int K, bool MULTI>
__host__ __device__ constexpr int slot_stride() { return MULTI ? (K | 1) : 32; }
template <int K, bool MULTI>
__host__ __device__ inline int row_ints(int T) { return MULTI ? 32 * T * (K | 1) : 32 * K; }

// The T warps of problem group g meet here (barrier 0 is the block's).
__device__ __forceinline__ void group_barrier(int g, int T) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(T * 32) : "memory");
}

// DIAG is the diagonal mode: a template constant, so that the cross mode's
// loop holds no select of it (a runtime flag cost 4 % at the main shapes).
// GMEM reads the tables from device memory (see the head of the file).
template <int K, bool MULTI, bool DIAG, bool GMEM>
__global__ void __launch_bounds__(WARPS * 32, min_blocks<K>())
module_scan_kernel(const int* __restrict__ seedT, const int* __restrict__ lut,
                   const int* __restrict__ sdo, const int* __restrict__ sde,
                   const int* __restrict__ pchar, const int* __restrict__ pmask,
                   const int* __restrict__ io, const int* __restrict__ ie,
                   int* __restrict__ out, int NB, int NBt, int C, int W, int L, int A,
                   int fwd, int allow_sdel, int skip_from, int T, int G) {
  extern __shared__ int smem[];
  if (!MULTI) T = 1;
  // A one-warp cross-mode block always holds WARPS problems: a constant lets
  // the level loop keep the problem's index in one instruction.
  if (!MULTI && !DIAG) G = WARPS;
  const int NL = 32 * T;                     // lanes of a problem
  const int ROW = row_ints<K, MULTI>(T);     // ints of a table row
  constexpr int SS = slot_stride<K, MULTI>();
  const int CT = DIAG ? NB : C;              // columns of the tables
  const int CO = DIAG ? 1 : C;               // columns of the output and the seeds
  // The pair axis.  The grid's y axis holds the sets one after the other,
  // ceil(NB / G) blocks each (x is the column, so a set's blocks run
  // together); the per-level tables and the output hold the sets side by side
  // on the problem axis, NBt / P problems a set (NB rounded up to G when
  // P > 1), so that the level loop indexes problem q of all sets as the
  // one-set kernel indexes its problem p.  Seeds and column tables of set z
  // lie at its offset.
  const int blocks_a_set = (NB + G - 1) / G;
  const int zs = blockIdx.y / blocks_a_set;
  const size_t z = zs;
  seedT += z * NB * CO * W;
  lut += z * A * CT * W;
  sdo += z * CT * W;
  sde += z * CT * W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = MULTI ? warp / T : warp;     // the block's problem
  const int wt = MULTI ? warp - g * T : 0;   // the warp's place in it
  const int gl = wt * 32 + lane;             // the lane's place in it
  const int p = (blockIdx.y - zs * blocks_a_set) * G + g;  // the problem in its set
  const int q = blockIdx.y * G + g;                         // among all sets
  const int c = DIAG ? 0 : blockIdx.x;
  // Lanes below `full` own K offsets, the others K - 1 and a hole.
  const int full = W - NL * (K - 1);  // in [1, NL]
  const int set_ints = (A + 3) * ROW;
  int* xs = smem;  // the exchange area of wide problems
  int* tables = smem + (MULTI ? G * XS_INTS : 0);

  // --- the block's level-invariant tables, in slot order ----------------------
  // One set of sdo, the shifted sde and A + 1 LUT rows (row A all DEV_INF)
  // for the block's column, or in the diagonal mode one for each problem.
  const int sets = GMEM ? 0 : (DIAG ? G : 1);
  for (int i = threadIdx.x; i < sets * ROW; i += blockDim.x) {
    const int set = i / ROW, j = i - set * ROW;
    const int l = MULTI ? j / SS : j & 31;   // the lane of the slot
    const int k = MULTI ? j - l * SS : j >> 5;
    const int s = l * K - max(0, l - full) + k;
    const int col = DIAG ? (blockIdx.y - zs * blocks_a_set) * G + set : c;
    const bool valid = l < NL && k < K - (l >= full ? 1 : 0) && col < CT;
    const int w = fwd ? s : W - 1 - s;
    const int wprev = fwd ? s - 1 : W - s;  // the offset in slot s - 1
    int* t = tables + set * set_ints + j;
    t[0] = valid ? sdo[(size_t)col * W + w] : DEV_INF;
    t[ROW] = !valid ? 0 : (s == 0 ? DEV_INF : sde[(size_t)col * W + wprev]);
    for (int a = 0; a < A; ++a)
      t[(2 + a) * ROW] = valid ? lut[((size_t)a * CT + col) * W + w] : DEV_INF;
    t[(2 + A) * ROW] = DEV_INF;
  }
  __syncthreads();
  if (p >= NB) return;  // whole problems leave; no block barrier below

  const int* tab = tables + (DIAG ? g : 0) * set_ints + (MULTI ? gl * SS : lane);
  const int* sdo_s = tab;
  const int* ext_s = tab + ROW;
  const int* lut_s = tab + 2 * ROW;

  const bool hole = gl >= full;
  const int base = gl * K - max(0, gl - full);
  // GMEM: the problem's column of the tables in device memory, read a slot at
  // a time as the shared variant's staging loop reads it
  const size_t col_at = (size_t)(DIAG ? p : c) * W;
  const int* sdo_g = sdo + col_at;
  const int* sde_g = sde + col_at;
  const int* lut_g = lut + col_at;
  auto slot_valid = [&](int k) { return k < K - 1 || !hole; };
  auto offset_of = [&](int k) { return fwd ? base + k : W - 1 - base - k; };
  // the extension into slot s (from slot s - 1's offset), DEV_INF into slot 0
  auto ext_into = [&](int s) {
    return s == 0 ? DEV_INF : __ldg(sde_g + (fwd ? s - 1 : W - s));
  };
#define SDO(k) (GMEM ? (slot_valid(k) ? __ldg(sdo_g + offset_of(k)) : DEV_INF) \
                     : sdo_s[(k) * (MULTI ? 1 : 32)])
#define EXT(k) (GMEM ? (slot_valid(k) ? ext_into(base + (k)) : 0) \
                     : ext_s[(k) * (MULTI ? 1 : 32)])
  const int* seed = seedT + ((size_t)p * CO + c) * W;

  int Tn[K], Ti[K], Td[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = base + k;
    const bool valid = k < K - 1 || !hole;
    Tn[k] = valid ? seed[fwd ? s : W - 1 - s] : DEV_INF;
    Ti[k] = DEV_INF;
    Td[k] = DEV_INF;
  }

  // --- the scan of the extension sums, once ----------------------------------
  ScanStep scan[5];
  ScanStep carry;        // (wide) the extension from this warp's first slot to the lane's
  long long ext1 = 0;    // (wide) the warp's extension sum past its first slot
  {
    long long e = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) e += EXT(k);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int off = 1 << i;
      scan[i].set(e, lane >= off);
      const long long el = __shfl_up_sync(FULL, e, off);
      if (lane >= off) e += el;
    }
    if (MULTI) {
      // e is the inclusive sum of the lanes up to this one; the first slot's
      // extension is not crossed by a carry entering the warp there
      const long long ext0 = __shfl_sync(FULL, (long long)EXT(0), 0);
      const long long before = __shfl_up_sync(FULL, e, 1);
      carry.set(before - ext0, lane > 0);
      ext1 = __shfl_sync(FULL, e, 31) - ext0;
    }
  }
  int* xg = xs + g * XS_INTS;  // this problem's exchange area
  long long* x_ext1 = reinterpret_cast<long long*>(xg + 2 * MAX_T * 4);
  if (MULTI) {
    if (lane == 0) x_ext1[wt] = ext1;
    group_barrier(g, T);
  }
  // (wide) the extension of the first slot of warp t, read from the tables
  auto ext0_of = [&](int t) {
    if (GMEM) return ext_into(t * 32 * K - max(0, t * 32 - full));
    return tables[(DIAG ? g : 0) * set_ints + ROW + (t * 32) * SS];
  };

  const int dead_from = skip_from > 0 ? skip_from : INT_MAX;
  int pc = 0, pm = 0, iov = 0, iev = 0;
  if (L > 0) {
    pc = pchar[q];
    pm = pmask[q];
    iov = io[q];
    iev = ie[q];
  }

  for (int lvl = 0;; ++lvl) {
    int* xl = xg + (lvl & 1) * MAX_T * 4;  // this level's slots: [warp][4]
    // the next level's scalars, asked for before this level's arithmetic
    int pc_n = 0, pm_n = 0, io_n = 0, ie_n = 0;
    if (lvl + 1 < L) {
      const size_t li = (size_t)(lvl + 1) * NBt + q;
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
      if (MULTI) {
        // The warps before this one, in turn: the chain at the last slot of
        // warp t is its local total or the value entering its first slot
        // carried over its extension; the next warp's first slot takes the
        // smaller of that carried one step and the open of warp t's last slot.
        if (lane == 31) {
          xl[wt * 4] = cagg;
          xl[wt * 4 + 1] = edge;
        }
        group_barrier(g, T);
        int enter = DEV_INF, last = DEV_INF, open_last = DEV_INF;
        for (int t = 0; t < wt; ++t) {
          if (t > 0) enter = min(open_last, sat64(last, ext0_of(t)));
          last = min(xl[t * 4], sat64(enter, x_ext1[t]));
          open_last = xl[t * 4 + 1];
        }
        if (wt > 0) {
          // lane 0's first step is that one step; the others carry it over
          // the extension from the warp's first slot to theirs
          const int first = min(open_last, sat64(last, ext0_of(wt)));
          if (lane == 0) {
            d = last;
            po_in = open_last;
          } else {
            d = min(d, carry.apply(first));
          }
        }
      }
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
      if (MULTI) {
        if (lane == 0) xl[wt * 4 + 3] = m;
        group_barrier(g, T);
        for (int t = 0; t < T; ++t) m = min(m, xl[t * 4 + 3]);
      }
      if (gl == 0) out[((size_t)lvl * NBt + q) * CO + c] = m;
      return;
    }

    // --- emit and step, highest slot first so the diagonal lands in place ----
    const int* lrow = lut_s + (size_t)((unsigned)pc < (unsigned)A ? pc : A) * ROW;
    const bool pc_ok = (unsigned)pc < (unsigned)A;
    const int* lrow_g = lut_g + (size_t)(pc_ok ? pc : 0) * (DIAG ? NB : C) * W;
    int m = DEV_INF;
    int top = DEV_INF;  // the diagonal leaving slot K - 1
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int nd = min(Tn[k], Td[k]);
      const int any = min(nd, Ti[k]);
      m = min(m, any);
      const int lv = GMEM ? (pc_ok && slot_valid(k) ? __ldg(lrow_g + offset_of(k)) : DEV_INF)
                          : lrow[k * (MULTI ? 1 : 32)];
      const int sub = addmin(lv, pm, DEV_INF);
      const int diag_v = addmin(any, sub, DEV_INF);
      Ti[k] = addmin(Ti[k], iev, addmin(nd, iov, DEV_INF));
      if (k == K - 1) top = diag_v; else Tn[k + 1] = diag_v;
    }
    // the diagonal of the lane's last offset goes to the next lane
    int e = top;
    if (K >= 2) e = hole ? Tn[K - 1] : top;
    const int e_last = e;
    e = __shfl_up_sync(FULL, e, 1);
    Tn[0] = lane == 0 ? DEV_INF : e;
    if (hole) {
      Tn[K - 1] = DEV_INF;
      Ti[K - 1] = DEV_INF;
    }
    m = __reduce_min_sync(FULL, m);
    if (MULTI) {
      // and the warp's last one to the next warp; the minimum over all warps
      if (lane == 31) xl[wt * 4 + 2] = e_last;
      if (lane == 0) xl[wt * 4 + 3] = m;
      group_barrier(g, T);
      for (int t = 0; t < T; ++t) m = min(m, xl[t * 4 + 3]);
      if (lane == 0 && wt > 0) Tn[0] = xl[(wt - 1) * 4 + 2];
    }
    if (gl == 0) out[((size_t)lvl * NBt + q) * CO + c] = m;
    if (m >= dead_from) {
      // (every warp of the problem saw the same minimum and leaves here)
      for (int j = lvl + 1 + gl; j <= L; j += NL) out[((size_t)j * NBt + q) * CO + c] = DEV_INF;
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

// The layout of a launch: T warps a problem, G problems a block, and the
// block's shared memory, or false when the tables do not fit a block.
struct Plan {
  int K, T, G;
  size_t bytes;
  bool gmem;  // the tables stay in device memory
};

bool plan_of(int W, int A, int diag, Plan* out) {
  if (W < 1 || A < 0) return false;
  const int T = (W + 32 * MAX_K - 1) / (32 * MAX_K);
  if (T > MAX_T) return false;
  const int K = (W + 32 * T - 1) / (32 * T);
  const bool multi = T > 1;
  const size_t set = (size_t)(A + 3) * (multi ? 32 * T * (K | 1) : 32 * K) * sizeof(int);
  const size_t xs = multi ? XS_INTS * sizeof(int) : 0;
  int G = WARPS / T;
  if (diag) {
    while (G > 0 && G * (set + xs) > MAX_SHARED) --G;
  } else if (G * xs + set > MAX_SHARED) {
    G = 0;
  }
  out->K = K;
  out->T = T;
  if (G >= 1) {
    out->G = G;
    out->bytes = (diag ? G * set : set) + G * xs;
    out->gmem = false;
    return true;
  }
  // the global-memory variant runs the wide form's loop (K > 32)
  if (K <= 32) return false;
  out->G = WARPS / T;
  out->bytes = out->G * XS_INTS * sizeof(int);
  out->gmem = true;
  return true;
}

template <int K, bool MULTI, bool DIAG, bool GMEM>
int launch_mode(const int* seedT, const int* lut, const int* sdo, const int* sde,
                const int* pchar, const int* pmask, const int* io, const int* ie,
                int* out, int P, int NB, int C, int W, int L, int A, int fwd, int allow_sdel,
                int skip_from, const Plan& plan, cudaStream_t stream) {
  if (plan.bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(module_scan_kernel<K, MULTI, DIAG, GMEM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)plan.bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks_a_set = (NB + plan.G - 1) / plan.G;
  if ((long long)P * blocks_a_set > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(DIAG ? 1 : C, P * blocks_a_set);
  const int NBt = P > 1 ? P * blocks_a_set * plan.G : NB;
  module_scan_kernel<K, MULTI, DIAG, GMEM><<<grid, plan.G * plan.T * 32, plan.bytes, stream>>>(
      seedT, lut, sdo, sde, pchar, pmask, io, ie, out, NB, NBt, C, W, L, A, fwd,
      allow_sdel, skip_from, plan.T, plan.G);
  return (int)cudaGetLastError();
}

template <int K, bool MULTI, bool GMEM>
int launch(const int* seedT, const int* lut, const int* sdo, const int* sde,
           const int* pchar, const int* pmask, const int* io, const int* ie,
           int* out, int P, int NB, int C, int W, int L, int A, int fwd, int allow_sdel,
           int skip_from, int diag, const Plan& plan, cudaStream_t stream) {
  return diag ? launch_mode<K, MULTI, true, GMEM>(seedT, lut, sdo, sde, pchar, pmask, io, ie, out,
                                            P, NB, C, W, L, A, fwd, allow_sdel, skip_from,
                                            plan, stream)
              : launch_mode<K, MULTI, false, GMEM>(seedT, lut, sdo, sde, pchar, pmask, io, ie, out,
                                             P, NB, C, W, L, A, fwd, allow_sdel, skip_from,
                                             plan, stream);
}

}  // namespace

// The switch over K of an entry point: TSA_CASE(KK) is defined by the includer.
#define TSA_CASE4(K0) TSA_CASE(K0) TSA_CASE(K0 + 1) TSA_CASE(K0 + 2) TSA_CASE(K0 + 3)
#define TSA_CASE16(K0) TSA_CASE4(K0) TSA_CASE4(K0 + 4) TSA_CASE4(K0 + 8) TSA_CASE4(K0 + 12)
