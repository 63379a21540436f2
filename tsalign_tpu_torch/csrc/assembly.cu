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
//           for 0 <= l <= L and p2 - l >= 0, DEV_INF otherwise, where L is
//           the kind's L_read, the last level any window reads;
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
// This is ops/modules.py::assembly_torch and its fold, bit for bit: every
// term is one saturating add (its segment's cost, or ldiff0) and then the
// anti add away from a minimum, and sat(min(p, q) + t) = min(sat(p + t),
// sat(q + t)) for the clamp-from-above add, so each term may be folded into
// the slab window on its own, in any order, with the adds of the plain
// version in its order (costs may be negative, so that order matters near
// DEV_INF).  A segment whose window is empty still adds sat(DEV_INF + cost).
//
// What bounds it: the bytes.  At the main pair's widest chunk (501 rows, C
// 64, L_read 200, S 196) the function reads the 80,601 (row, level) pairs
// of B that the rows' shear reaches, 64 columns each, and the rows' slab
// windows: 21.7 MB, 6.5 us at 3.35 TB/s.  What the design does about it:
//   * A block owns one row p2 of one pair and stages only the levels it
//     reads, 0..min(p2, L_read), a group of CG columns at a time (16 at the
//     main shapes), as X[p][c]: cp.async copies of 16 bytes (4 columns of
//     one level) where B's rows are 16-byte aligned, 4 bytes otherwise, each
//     thread on fixed columns and a stride of levels (no division a value),
//     into two buffers, so that group g + 1 is in flight while group g's
//     minima run.  One pass then adds length[l] (and, same-sequence,
//     B[l, p2 - l]) in place, and DEV_INF past the levels staged.
//   * Window minima by doubling in place, built once per column and read
//     by every segment: after pass k, X[p] = min x[p - 2^k + 1, p] (pass k:
//     X[p] = min(X[p], X[p - 2^(k-1)]), the last position first, every read
//     of a batch before its writes); a window [a, a + wr - 1] with
//     2^k <= wr < 2^(k + 1) is min(X[a + wr - 1], X[a + 2^k - 1]), read
//     between pass k and pass k + 1.  The passes go to the widest window's
//     level (6 for w = 100) over the row's levels and 2^K - 1 beyond.  A
//     window cut by either end of the data needs no test: X before 0 reads
//     as DEV_INF, and X runs on as DEV_INF to the last position a window
//     reads (past L where the kind's L_read is its L).  (A van Herk /
//     Gil-Werman running minimum in blocks of wr was this kernel's first
//     design: a serial pass of about 2 wr steps a (column, segment, block)
//     with wr ints of scratch each took 0.080 ms at the main chunk; the
//     doubling's positions are independent, a thread 4 columns with 16-byte
//     loads: 0.039 ms.  Both measured on one H100 by
//     scripts/torch_port_scan_probe.py.)
//   * A thread holds RB = 8 outputs of a quad of 4 columns in registers
//     across the passes: the ldiff = 0 term and the empty windows' terms,
//     then each segment's at its level, then the anti add; the terms go into
//     a shared copy of the row's slab window by atomicMin in shared memory
//     (on the chunked route a quad's 32 terms meet on 11 places and are
//     merged first; a DEV_INF term changes nothing and is left out), which
//     the block min-writes to the slab once.  No two blocks write one slab
//     row, and chunks of a kind launch in order on one stream, so no atomic
//     touches device memory.
//   * Row p2's passes cover about min(p2, L_read) + 2^K levels, so the grid
//     takes the heavy rows, the last ones, first.
//   * The pair axis: the chunk's live pairs run in one launch, row-major
//     over the pairs, each with its own B, entry columns, tables, real anti
//     length, destinations and slab; the segments and the shapes are the
//     bucket's.
// Later work: reading B straight from the module scan's epilogue, with no
// trip through device memory; the passes' two barriers a level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr int THREADS = 128;
// the most columns a group (a power of two, 4 or more), and a thread's
// outputs, which is also its positions a batch of a doubling pass (the
// batch's loads go out together)
constexpr int CG_MAX = 32;
constexpr int RB = 8;
constexpr int MAX_PAIRS = 32;      // pairs a launch (the entry point splits more)
constexpr int MAX_PLANS = 16;      // finite ldiff segments
constexpr size_t MAX_SHARED = 232448;
constexpr size_t BLOCK_SHARED = 75 * 1024;  // three blocks an SM

// min(a + b, c); a, b <= DEV_INF, so the sum stays inside int32.
__device__ __forceinline__ int addmin(int a, int b, int c) { return __viaddmin_s32(a, b, c); }

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
  int n_pairs, n_rows, n_segs, C, L, XR, S, s_lo, anti_lo, ldiff0, same, CG, cg_log, span;
};

__device__ __forceinline__ int4 min4(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z), min(a.w, b.w));
}

// sat(a + b) a lane, b one value
__device__ __forceinline__ int4 addmin4(int4 a, int b) {
  return make_int4(addmin(a.x, b, DEV_INF), addmin(a.y, b, DEV_INF), addmin(a.z, b, DEV_INF),
                   addmin(a.w, b, DEV_INF));
}

__device__ __forceinline__ int floor_log2(int v) { return 31 - __clz(v); }

__global__ void __launch_bounds__(THREADS)
assembly_kernel(const __grid_constant__ Args args) {
  extern __shared__ __align__(16) int smem[];
  const int r = blockIdx.x / args.n_pairs;
  const int z = blockIdx.x - r * args.n_pairs;
  const Pair& pr = args.pairs[z];
  const int p2 = args.n_rows - 1 - r;  // the heavy rows first
  const int C = args.C, L = args.L, S = args.S, CG = args.CG, lg = args.cg_log;
  const int nq = CG >> 2, qlg = lg - 2;  // 4-column quads a group
  const int nlv = min(p2, L) + 1;        // the levels row p2 reads
  const int xbuf = args.XR * CG;
  const int n_groups = (C + CG - 1) / CG;
  int* X = smem;                          // two buffers of X[p][cc], p < XR (one group: one)
  int* fold = X + (n_groups > 1 ? 2 : 1) * xbuf;  // the row's slab window
  int* rel = fold + args.span;            // each column's first place in it
  int* anti = rel + C;
  int* len = anti + S;
  int* bl = len + (L + 1);                // same-sequence kinds: B[l, p2 - l]

  // what is staged: B's columns (cross kinds) or the entry columns A
  const int* src = args.same ? pr.A : pr.B;
  const long long s_lvl = args.same ? 0 : pr.b_level;
  const long long s_row = args.same ? pr.a_row : pr.b_row;
  const long long s_col = args.same ? 1 : pr.b_col;
  const bool vec = (C & 3) == 0 && s_col == 1 && (s_lvl & 3) == 0 && (s_row & 3) == 0 &&
                   ((uintptr_t)src & 15) == 0;

  // the cp.async copies of group g's levels 0..nlv-1 into buffer g & 1
  auto issue = [&](int g) {
    const int c0 = g * CG, cg = min(CG, C - c0);
    int* Xb = X + (g & 1) * xbuf;
    const int* base = src + (long long)p2 * s_row + (long long)c0 * s_col;  // level 0
    const long long step = s_lvl - s_row;  // one level up, one row back
    if (vec) {
      const int q = threadIdx.x & (nq - 1);
      const int l0 = threadIdx.x >> qlg, ls = THREADS >> qlg;
      if (4 * q < cg)
        for (int l = l0; l < nlv; l += ls)
          cp_async16(Xb + l * CG + 4 * q, base + l * step + 4 * q);
    } else {
      const int cc = threadIdx.x & (CG - 1);
      const int l0 = threadIdx.x >> lg, ls = THREADS >> lg;
      if (cc < cg)
        for (int l = l0; l < nlv; l += ls)
          cp_async4(Xb + l * CG + cc, base + l * step + cc * s_col);
    }
    cp_commit();
  };

  issue(0);
  if (n_groups > 1) issue(1);
  for (int i = threadIdx.x; i < args.span; i += THREADS) fold[i] = DEV_INF;
  for (int c = threadIdx.x; c < C; c += THREADS)
    rel[c] = pr.dest_base + (pr.dest ? pr.dest[c] : c) - pr.lo;
  for (int s = threadIdx.x; s < S; s += THREADS) anti[s] = pr.anti[s];
  for (int l = threadIdx.x; l < nlv; l += THREADS) {
    len[l] = pr.length[l];
    if (args.same) bl[l] = pr.B[l * pr.b_level + (p2 - l) * pr.b_row];
  }

  // The row's windows: segment k reads [t0 + s, t0 + s + wr - 1] for output
  // s; the doubling goes to the widest one's level K.
  auto window = [&](int k, int& t0, int& wr) {
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
    t0 = args.s_lo - sg.b + lo;
    wr = hi - lo + 1;
  };
  int K = 0, empty = DEV_INF;  // empty: the terms of the segments whose window is empty
  for (int k = 0; k < args.n_segs; ++k) {
    int t0, wr;
    window(k, t0, wr);
    if (wr >= 1) K = max(K, floor_log2(wr));
    else empty = min(empty, addmin(DEV_INF, args.segs[k].cost, DEV_INF));
  }
  // M_K[p] = min x[p - 2^K + 1, p]: DEV_INF past p_end (< XR, past the last
  // position a window reads)
  const int p_end = min(args.XR - 1, nlv - 1 + (1 << K) - 1);

  // this thread's outputs: quad oq, outputs s_out + [0, RB) of a round; the
  // rounds cover S (more than one only where S > RB * THREADS / nq)
  const int oq = threadIdx.x & (nq - 1), per_round = (THREADS >> qlg) * RB;
  const int n_rounds = (S + per_round - 1) / per_round;

  for (int g = 0; g < n_groups; ++g) {
    const int c0 = g * CG, cg = min(CG, C - c0);
    int4* Xq = reinterpret_cast<int4*>(X + (g & 1) * xbuf);  // Xq[p * nq + q]
    if (g + 1 < n_groups) cp_wait<1>(); else cp_wait<0>();
    for (int round = 0; round < n_rounds; ++round) {
      const int s_out = round * per_round + (threadIdx.x >> qlg) * RB;
      if (round > 0) {  // the passes overwrote the group: stage it again
        __syncthreads();
        issue(g);
        cp_wait<0>();
      }
      __syncthreads();  // group g's copies and the tables, seen by every thread
      // --- x = sat(B + length) (or sat(sat(A + B) + length)); DEV_INF to p_end --
      for (int i = threadIdx.x; i < (p_end + 1) * nq; i += THREADS) {
        const int p = i >> qlg;
        int4 v = make_int4(DEV_INF, DEV_INF, DEV_INF, DEV_INF);
        if (p < nlv) {
          v = Xq[i];
          if (args.same) v = addmin4(v, bl[p]);
          v = addmin4(v, len[p]);
        }
        Xq[i] = v;
      }
      __syncthreads();
      // --- the ldiff = 0 term and the empty windows' --------------------------
      int4 u[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int i = args.s_lo + s_out + j;
        const int4 v0 = (unsigned)i < (unsigned)nlv ? Xq[i * nq + oq]
                                                    : make_int4(DEV_INF, DEV_INF, DEV_INF, DEV_INF);
        const int4 e4 = make_int4(empty, empty, empty, empty);
        u[j] = min4(addmin4(v0, args.ldiff0), e4);
      }
      // --- each level: double, then the windows of that level ------------------
      for (int k = 0; k <= K; ++k) {
        if (k > 0) {  // in place, last position first: M[p] = min(M[p], M[p - d])
          const int d = 1 << (k - 1);
          const int n = (p_end + 1 - d) * nq;
          for (int i0 = 0; i0 < n; i0 += RB * THREADS) {
            int4 v[RB];
#pragma unroll
            for (int j = 0; j < RB; ++j) {
              const int i = i0 + j * THREADS + threadIdx.x;
              if (i < n) {
                const int p = p_end - (i >> qlg), q = i & (nq - 1);
                v[j] = min4(Xq[p * nq + q], Xq[(p - d) * nq + q]);
              }
            }
            __syncthreads();  // every read of this batch before its writes
#pragma unroll
            for (int j = 0; j < RB; ++j) {
              const int i = i0 + j * THREADS + threadIdx.x;
              if (i < n) Xq[(p_end - (i >> qlg)) * nq + (i & (nq - 1))] = v[j];
            }
            __syncthreads();
          }
        }
        if (s_out >= S) continue;
        for (int kk = 0; kk < args.n_segs; ++kk) {
          int t0, wr;
          window(kk, t0, wr);
          if (wr < 1 || floor_log2(wr) != k) continue;
          const int cost = args.segs[kk].cost;
          // min x[a, a + wr - 1] = min(M[a + wr - 1], M[a + 2^k - 1])
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const int a = t0 + s_out + j, e = a + wr - 1, m = a + (1 << k) - 1;
            const int4 inf = make_int4(DEV_INF, DEV_INF, DEV_INF, DEV_INF);
            const int4 ve = (unsigned)e <= (unsigned)p_end ? Xq[e * nq + oq] : inf;
            const int4 vm = (unsigned)m <= (unsigned)p_end ? Xq[m * nq + oq] : inf;
            u[j] = min4(u[j], addmin4(min4(ve, vm), cost));
          }
        }
      }
      // --- the anti add, and each term into the row's slab window ----------------
      // (a term of DEV_INF changes nothing there, and is left out)
      const int cq = 4 * oq;
      if (s_out < S && cq < cg) {
        const int fb = rel[c0 + cq] + s_out;
        int4 t[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) t[j] = addmin4(u[j], anti[min(s_out + j, S - 1)]);
        auto live = [&](int j, int c) { return s_out + j < S && cq + c < cg; };
        if (pr.dest == nullptr) {
          // the chunked route: column c0 + cq + c's output s_out + j lands at
          // fb + c + j, so the quad's RB outputs meet on RB + 3 places
          int m[RB + 3];
#pragma unroll
          for (int i = 0; i < RB + 3; ++i) m[i] = DEV_INF;
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            if (live(j, 0)) m[j] = min(m[j], t[j].x);
            if (live(j, 1)) m[j + 1] = min(m[j + 1], t[j].y);
            if (live(j, 2)) m[j + 2] = min(m[j + 2], t[j].z);
            if (live(j, 3)) m[j + 3] = min(m[j + 3], t[j].w);
          }
#pragma unroll
          for (int i = 0; i < RB + 3; ++i)
            if (m[i] < DEV_INF) atomicMin(fold + fb + i, m[i]);
        } else {
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const int* rc = rel + c0 + cq;
            if (live(j, 0) && t[j].x < DEV_INF) atomicMin(fold + rc[0] + s_out + j, t[j].x);
            if (live(j, 1) && t[j].y < DEV_INF) atomicMin(fold + rc[1] + s_out + j, t[j].y);
            if (live(j, 2) && t[j].z < DEV_INF) atomicMin(fold + rc[2] + s_out + j, t[j].z);
            if (live(j, 3) && t[j].w < DEV_INF) atomicMin(fold + rc[3] + s_out + j, t[j].w);
          }
        }
      }
    }
    __syncthreads();  // buffer g & 1 is free
    if (g + 2 < n_groups) issue(g + 2);
  }
  // --- one read-min-write of the row's slab window ----------------------------
  int* row = pr.slab + p2 * pr.slab_row + pr.lo;
  for (int i = threadIdx.x; i < pr.span; i += THREADS) row[i] = min(row[i], fold[i]);
}

size_t shared_bytes(int CG, int C, int L, int XR, int S, int span) {
  const size_t buffers = C > CG ? 2 : 1;
  return sizeof(int) * (buffers * XR * CG + span + C + S + 2 * (size_t)(L + 1));
}

// The columns a group (*CG = 1 << *lg: at least 4, at most the power of two
// >= C), the largest for which a thread's RB outputs of one quad cover S in
// one round and three blocks share an SM, and the launch's shared bytes;
// false when a group of 4 does not fit a block's shared memory.
bool plan_of(int C, int L, int XR, int S, int span, int* CG, int* lg, size_t* bytes) {
  int cg = CG_MAX, g = 31 - __builtin_clz(CG_MAX);
  while (cg > 4 && (cg >= 2 * C || (size_t)(cg / 4) * ((S + RB - 1) / RB) > THREADS ||
                    shared_bytes(cg, C, L, XR, S, span) > BLOCK_SHARED)) {
    cg >>= 1;
    --g;
  }
  *CG = cg;
  *lg = g;
  *bytes = shared_bytes(cg, C, L, XR, S, span);
  return *bytes <= MAX_SHARED;
}

}  // namespace

// One chunk's assembly for P pairs, folded in place into each pair's slab.
// `ptrs` holds 6 pointers a pair (B, A, length, anti, dest, slab), `strides`
// 5 int64 a pair (b_level, b_row, b_col, a_row, slab_row), `ints` 4 a pair
// (dest_base, lo, span, ah), `segs` 4 ints a segment (a, b, cost, positive):
// all in host memory.  L is the kind's L_read: B holds levels 0..L.
// The pairs run MAX_PAIRS a launch, in order on `stream`.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue on shapes
// the kernel does not take (more than MAX_PLANS segments, or a group of 4
// columns whose positions pass a block's shared memory).
extern "C" int tsa_assembly(const unsigned long long* ptrs, const long long* strides,
                            const int* ints, const int* segs, int n_segs, int P, int n_rows,
                            int C, int L, int S, int s_lo, int anti_lo, int ldiff0, int same,
                            void* stream) {
  if (P == 0 || n_rows == 0) return 0;
  if (P < 0 || n_rows < 0 || n_segs < 0 || n_segs > MAX_PLANS || C < 1 || S < 1 || L < 0)
    return (int)cudaErrorInvalidValue;
  int span = 1;
  for (int z = 0; z < P; ++z) span = ints[4 * z + 2] > span ? ints[4 * z + 2] : span;
  // X's positions: the levels 0..L, and where the windows read past L (a
  // kind whose L_read is its L), DEV_INF up to the last position they read
  int min_a = 0;
  for (int k = 0; k < n_segs; ++k) min_a = segs[4 * k] < min_a ? segs[4 * k] : min_a;
  const int last = s_lo + S - 1 - min_a;
  const int XR = L + 1 + (last > L ? last - L : 0);
  int CG, lg;
  size_t bytes;
  if (!plan_of(C, L, XR, S, span, &CG, &lg, &bytes)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(assembly_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  Args args;
  args.n_rows = n_rows;
  args.n_segs = n_segs;
  for (int k = 0; k < n_segs; ++k)
    args.segs[k] = Seg{segs[4 * k], segs[4 * k + 1], segs[4 * k + 2], segs[4 * k + 3]};
  args.C = C;
  args.L = L;
  args.XR = XR;
  args.S = S;
  args.s_lo = s_lo;
  args.anti_lo = anti_lo;
  args.ldiff0 = ldiff0;
  args.same = same;
  args.CG = CG;
  args.cg_log = lg;
  args.span = span;
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
    args.n_pairs = n;
    assembly_kernel<<<n_rows * n, THREADS, bytes, (cudaStream_t)stream>>>(args);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
