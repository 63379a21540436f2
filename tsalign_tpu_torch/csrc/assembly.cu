// Reentry assembly of one chunk of a TSM kind, min-folded into the kind's
// slab, for Hopper (int32 saturating (min,+)).
//
// Replaces the XLA program tsalign_tpu/ops/jax_modules.py::_assembly
// (with _band_masked, _masked_window_min and _assembly_positive_traced),
// run inside _kind_all_chunks / _kind_sel_chunks, and the fold that follows
// it there.  For each pair z of the launch, each entry row p2 of its chunk,
// each chunk column c and each output s in [0, S):
//   x[l]  = D3s[p2, c, l] = sat(B[l, p2 - l, c] + length[l])   (cross kinds)
//         = sat(sat(A[p2 - l, c] + B[l, p2 - l]) + length[l]) (same sequence)
//           for 0 <= l <= L and p2 - l >= 0, DEV_INF otherwise;
//   for each finite ldiff segment [a, b] of cost `cost` (a "plan"), the
//   window of offsets u in [lo, hi] that the anti-gap walk allows row p2
//   (positive segments: lo = clamp(p2 - (Ah - b), 0, w), hi = w - 1, with Ah
//   the pair's real anti length ah for a poison-padded pair and the
//   bucket's anti_hi otherwise; negative segments: lo = 0,
//   hi = clamp(p2 + b - Al, -1, w - 1); w = b - a + 1), and
//     val = min over u in [lo, hi] of x[s_lo - b + s + u]   (DEV_INF if empty)
//     U = min(U, sat(val + cost));
//   then U = min(U, sat(x[s_lo + s] + ldiff0)), U = sat(U + anti[s]) and
//     slab[p2, dest(c) + s] = min(slab[p2, dest(c) + s], U)
// with dest(c) = dest_base + c (the chunked route: the diagonal min-fold) or
// dest_base + dest[c] (the compact route: each column at its own place).
// This is ops/modules.py::assembly_torch and its fold, saturating add for
// saturating add in the same order (costs may be negative, so the order
// matters near DEV_INF): the full window, the band's per-row widths and the
// kill rows of the plain version are all the one window [lo, hi] of a row.
//
// What bounds it: the bytes.  At the main pair's widest chunk (501 rows, C
// 64, L 500, S 196) B is 64 MB, 19 us at 3.35 TB/s; a running minimum needs
// about 3 operations a window and output, 0.11 G in all, 3 us at the DPX
// rate.  This kernel takes each window's minimum directly, up to w (about
// 100) sheared values a segment, 1.1 G operations or 33 us, so its own
// operations, not the bytes, set its floor.  What the design does about it:
//   * A block owns one row p2 of one pair: it stages the row's sheared
//     values of a group of columns in shared memory (a column's L + 1
//     values and a DEV_INF sentinel, the odd row stride keeping the
//     column-parallel reads conflict-free), so B is read once, and folds
//     every (c, s) of the row into a shared copy of the row's slab window
//     (atomicMin in shared memory), which it min-writes to the slab once.
//     No two blocks write one slab row, and chunks of a kind launch in order
//     on one stream, so no atomic touches device memory.
//   * A thread computes R = 8 neighbouring outputs s of one column: every
//     value it loads from shared memory serves up to R windows, so a window
//     of width wr costs wr + R - 1 loads for R outputs, not R wr.  The
//     window bounds depend on the row and the segment only (uniform in the
//     block), so the loop carries no per-output test; an index outside
//     [0, L] is clamped onto the sentinel.
//   * The pair axis: the chunk's live pairs run in one launch (the grid's y
//     axis), each with its own B, entry columns, tables, real anti length,
//     destinations and slab; the segments and the shapes are the bucket's.
// A van Herk / Gil-Werman running minimum (3 operations an output whatever
// the width) and reading B straight from the module scan are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr int THREADS = 256;
constexpr int R = 8;              // outputs s a thread
constexpr int MAX_PAIRS = 32;     // pairs a launch (the entry point splits more)
constexpr int MAX_PLANS = 16;     // finite ldiff segments
constexpr size_t MAX_SHARED = 232448;

// min(a + b, c); a, b <= DEV_INF, so the sum stays inside int32.
__device__ __forceinline__ int addmin(int a, int b, int c) { return __viaddmin_s32(a, b, c); }

struct Pair {
  const int* B;         // B[l * b_level + p * b_row + c * b_col]
  const int* A;         // same-sequence kinds: A[p * a_row + c]
  const int* length;    // (L + 1)
  const int* anti;      // (S)
  const int* dest;      // (C) or null
  int* slab;            // slab[p * slab_row + col]
  long long b_level, b_row, b_col, a_row, slab_row;
  int dest_base;        // dest(c) = dest_base + (dest ? dest[c] : c)
  int lo, span;         // the row's slab window [lo, lo + span) this launch writes
  int ah;               // the anti length of the positive segments' walk
};

struct Seg {
  int a, b, cost, positive;
};

struct Args {
  Pair pairs[MAX_PAIRS];
  Seg segs[MAX_PLANS];
  int n_segs, C, L, S, s_lo, anti_lo, ldiff0, same, CG, XS;
};

// The window minima of R outputs over x[base + j + k], k in [0, wr), for a
// width wr >= 1.  With wr >= R each loaded value is folded into the outputs
// it serves, known at compile time in the prologue and epilogue.
__device__ __forceinline__ void window_min(const int* x, unsigned last, int base, int wr,
                                           int (&m)[R]) {
  auto at = [&](int i) { return x[min((unsigned)i, last)]; };
  if (wr >= R) {
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      const int v = at(base + k);
#pragma unroll
      for (int j = 0; j <= k; ++j) m[j] = min(m[j], v);
    }
#pragma unroll 4
    for (int k = R - 1; k < wr; ++k) {
      const int v = at(base + k);
#pragma unroll
      for (int j = 0; j < R; ++j) m[j] = min(m[j], v);
    }
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      const int v = at(base + wr + k);
#pragma unroll
      for (int j = k + 1; j < R; ++j) m[j] = min(m[j], v);
    }
  } else {
    for (int k = 0; k < wr + R - 1; ++k) {
      const int v = at(base + k);
#pragma unroll
      for (int j = 0; j < R; ++j)
        if ((unsigned)(k - j) < (unsigned)wr) m[j] = min(m[j], v);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
assembly_kernel(const __grid_constant__ Args args) {
  extern __shared__ int smem[];
  const Pair& pr = args.pairs[blockIdx.y];
  const int p2 = blockIdx.x;
  const int C = args.C, L = args.L, S = args.S, XS = args.XS;
  int* fold = smem;               // the row's slab window, span ints
  int* rel = fold + pr.span;      // each column's first place in it
  int* X = rel + C;               // CG columns of XS ints
  for (int i = threadIdx.x; i < pr.span; i += THREADS) fold[i] = DEV_INF;
  for (int c = threadIdx.x; c < C; c += THREADS)
    rel[c] = pr.dest_base + (pr.dest ? pr.dest[c] : c) - pr.lo;

  const int runs = (S + R - 1) / R;
  const unsigned last = (unsigned)(L + 1);  // the sentinel's index
  for (int c0 = 0; c0 < C; c0 += args.CG) {
    const int cg = min(args.CG, C - c0);
    __syncthreads();  // the group before is read, rel and fold are set
    // --- stage the sheared row: X[cc][l] = D3[p2 - l, c0 + cc, l] -----------
    for (int i = threadIdx.x; i < cg * (L + 2); i += THREADS) {
      const int l = i / cg, cc = i - l * cg;
      const int p = p2 - l;
      int v = DEV_INF;
      if (l <= L && p >= 0) {
        const int c = c0 + cc;
        v = pr.B[l * pr.b_level + p * pr.b_row + c * pr.b_col];
        if (args.same) v = addmin(pr.A[p * pr.a_row + c], v, DEV_INF);
        v = addmin(v, pr.length[l], DEV_INF);
      }
      X[cc * XS + l] = v;
    }
    __syncthreads();
    // --- R outputs of one column a task ----------------------------------------
    for (int task = threadIdx.x; task < cg * runs; task += THREADS) {
      const int run = task / cg, cc = task - run * cg;
      const int s0 = run * R;
      const int* x = X + cc * XS;
      int U[R];
#pragma unroll
      for (int j = 0; j < R; ++j) U[j] = DEV_INF;
      for (int k = 0; k < args.n_segs; ++k) {
        const Seg sg = args.segs[k];
        const int w = sg.b - sg.a + 1;
        int lo, hi;
        if (sg.positive) {
          lo = min(max(p2 - (pr.ah - sg.b), 0), w);
          hi = w - 1;
        } else {
          lo = 0;
          hi = min(max(p2 + sg.b - args.anti_lo, -1), w - 1);
        }
        int m[R];
#pragma unroll
        for (int j = 0; j < R; ++j) m[j] = DEV_INF;
        if (hi >= lo) window_min(x, last, args.s_lo - sg.b + s0 + lo, hi - lo + 1, m);
#pragma unroll
        for (int j = 0; j < R; ++j) U[j] = min(U[j], addmin(m[j], sg.cost, DEV_INF));
      }
      const int fbase = rel[c0 + cc] + s0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int s = s0 + j;
        if (s < S) {
          const int v0 = x[min((unsigned)(args.s_lo + s), last)];
          int u = min(U[j], addmin(v0, args.ldiff0, DEV_INF));
          u = addmin(u, pr.anti[s], DEV_INF);
          atomicMin(fold + fbase + j, u);
        }
      }
    }
  }
  __syncthreads();
  // --- one read-min-write of the row's slab window ----------------------------
  int* row = pr.slab + p2 * pr.slab_row + pr.lo;
  for (int i = threadIdx.x; i < pr.span; i += THREADS) row[i] = min(row[i], fold[i]);
}

// Shared bytes of a launch whose widest slab window is `span` ints, for C
// columns of L + 1 levels, and the columns staged at a time (*CG, *XS the
// ints a staged column); false when not one column and the window fit a
// block's shared memory.
bool plan_of(int C, int L, int span, int* CG, int* XS, size_t* bytes) {
  const int xs = (L + 2) | 1;
  const size_t fixed = ((size_t)span + C) * sizeof(int);
  const size_t col = (size_t)xs * sizeof(int);
  if (fixed + col > MAX_SHARED) return false;
  // up to 48 KB a block where that holds a column: several blocks an SM
  const size_t budget = fixed + col <= 48 * 1024 ? 48 * 1024 : fixed + col;
  const int cg = (int)((budget - fixed) / col);
  *CG = cg < C ? cg : C;
  *XS = xs;
  *bytes = fixed + (size_t)*CG * col;
  return true;
}

}  // namespace

// One chunk's assembly for P pairs, folded in place into each pair's slab.
// `ptrs` holds 6 pointers a pair (B, A, length, anti, dest, slab), `strides`
// 5 int64 a pair (b_level, b_row, b_col, a_row, slab_row), `ints` 4 a pair
// (dest_base, lo, span, ah), `segs` 4 ints a segment (a, b, cost, positive):
// all in host memory.  The pairs run MAX_PAIRS a launch, in order on
// `stream`.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue on shapes the kernel does not take (more than
// MAX_PLANS segments, or a slab window and one column beyond a block's
// shared memory).
extern "C" int tsa_assembly(const unsigned long long* ptrs, const long long* strides,
                            const int* ints, const int* segs, int n_segs, int P, int n_rows,
                            int C, int L, int S, int s_lo, int anti_lo, int ldiff0, int same,
                            void* stream) {
  if (P == 0 || n_rows == 0) return 0;
  if (P < 0 || n_rows < 0 || n_segs < 0 || n_segs > MAX_PLANS || C < 1 || S < 1 || L < 0)
    return (int)cudaErrorInvalidValue;
  int span = 1;
  for (int z = 0; z < P; ++z) span = ints[4 * z + 2] > span ? ints[4 * z + 2] : span;
  int CG, XS;
  size_t bytes;
  if (!plan_of(C, L, span, &CG, &XS, &bytes)) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  Args args;
  args.n_segs = n_segs;
  for (int k = 0; k < n_segs; ++k)
    args.segs[k] = Seg{segs[4 * k], segs[4 * k + 1], segs[4 * k + 2], segs[4 * k + 3]};
  args.C = C;
  args.L = L;
  args.S = S;
  args.s_lo = s_lo;
  args.anti_lo = anti_lo;
  args.ldiff0 = ldiff0;
  args.same = same;
  args.CG = CG;
  args.XS = XS;
  for (int z0 = 0; z0 < P; z0 += MAX_PAIRS) {
    const int n = P - z0 < MAX_PAIRS ? P - z0 : MAX_PAIRS;
    for (int i = 0; i < n; ++i) {
      const int z = z0 + i;
      const unsigned long long* pp = ptrs + 6 * z;
      const long long* st = strides + 5 * z;
      const int* in = ints + 4 * z;
      Pair& pr = args.pairs[i];
      pr.B = (const int*)pp[0];
      pr.A = (const int*)pp[1];
      pr.length = (const int*)pp[2];
      pr.anti = (const int*)pp[3];
      pr.dest = (const int*)pp[4];
      pr.slab = (int*)pp[5];
      pr.b_level = st[0];
      pr.b_row = st[1];
      pr.b_col = st[2];
      pr.a_row = st[3];
      pr.slab_row = st[4];
      pr.dest_base = in[0];
      pr.lo = in[1];
      pr.span = in[2];
      pr.ah = in[3];
    }
    dim3 grid(n_rows, n);
    assembly_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(args);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
