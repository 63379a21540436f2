// Primary sweep (gap-affine wavefront over F = L + R + 1 flank layers, int32
// saturating (min,+)) for Hopper: one lane-skewed kernel for both sweeps.
//
// Replaces the TPU kernels of tsalign_tpu/ops/pallas_sweep.py:
// sweep_pallas_flankless (_sweep_kernel), sweep_pallas_flankless_tiled
// (_sweep_kernel_tiled; it exists only to fit VMEM) and sweep_pallas_flanked
// (_flanked_kernel).  The flankless sweep is the F = 1 case of the flanked
// one (no climb edge, one table), so one kernel serves both; its 8-row
// sublane packing, iota row selects and 128-lane padding are not carried
// over.
//
// Arguments: subs (3, n_rows, Wq) substitution rows of the (primary,
// left-flank, right-flank) tables (only table 0 is read at F = 1), ddrows
// (n_rows, dd_stride) del open/extend per table, io/ie (3, Wq) ins
// open/extend per table (row 0 only at F = 1), seeds and out of logical shape
// (n_rows, 3F, Wq), plane 3 * fi + gap with gaps NONE=0, INS=1, DEL=2,
// addressed through a row stride and a plane stride (in elements, columns
// contiguous): the row-major layout of the TPU kernels and the engine's
// plane-major field (F, 3, n_rows, Wq) both run in place.
//
// The recurrence.  Number the (row, layer) pairs s = r * F + fi, flank
// f = fi - R.  For step s and column j:
//   * layer f = 0 takes the primary diagonal and deletion from its own
//     previous row (step s - F) and runs the in-row insertion chain
//       D[j] = min(cand[j], min(D[j-1] + ie[j-1], DEV_INF));
//   * a climbing layer (right-flank table for -R < f <= 0 with R > 0,
//     left-flank table for f > 0 when `climb`) also takes, from the layer
//     below, the diagonal and the deletion out of the previous row (step
//     s - F - 1) and ONE insertion step out of the current row (step s - 1,
//     columns j - 1 -> j);
//   * layer f = -R, and every f > 0 when `climb` is off, holds its seeds.
// At f = 0 with R > 0 the chain's candidates are the min of the seed, the
// climb insertion and the in-row open.  Every add is clamped to DEV_INF in the
// JAX package's order; an absent edge (row 0, column 0, a layer that does not
// climb) is predicated out with a select and never priced at DEV_INF, since a
// negative value plus DEV_INF lies below DEV_INF.  The result equals the plain
// versions (ops/sweep.py) bit for bit, also in [2^29, 2^30 - 1].
//
// What bounds it: neither bytes (28 MB at 501 x 15 x 421, microseconds at the
// H100's memory rate) nor operations, but the dependency chain: cell (s, j)
// needs (s, j - 1), so the longest path runs through n_rows + Wq + F - 2
// cells of two dependent integer instructions each, and one pair gives no
// more parallelism than the anti-diagonals hold.
// What the design does about it:
//   * Every source of cell (s, j) has a step <= s and a column <= j.  A lane
//     owns a strip of K neighbouring columns and is one row behind the lane
//     to its left: at row time t lane k is in row t - k and takes the row's F
//     layers one time step after the other, so all lanes of a warp are in the
//     same layer.  All a lane needs from outside its strip is the last column
//     of the lane to its left in the same row and in the row above, which
//     that lane finished one and two row times ago.  At F = 1 one
//     __shfl_up_sync of the triple a step hands it over and the one before is
//     kept.  At F > 1 every lane writes its last column of each layer into one
//     of three row slots in shared memory, [slot][layer][gap][lane], and reads
//     its left neighbour's two older slots; one __syncwarp() a row orders the
//     two.  There is no __syncthreads() in the step loop and no block scan:
//     the chain is the plain serial recurrence in 32 bits inside the strip
//     (d <= DEV_INF and 0 <= ie <= DEV_INF, so the sum fits), seeded by the
//     left lane's value.
//   * Because a warp is in one layer at a time, the kind of the layer (holds
//     its seeds, climbs, is f = 0) is a branch the whole warp takes, not a
//     select a cell: a layer pays only for the edges it has.
//   * State: the strip of the step just finished stays in registers (the
//     layer below in this row; at F = 1 also the previous row).  At F > 1 the
//     previous row of all layers is a lane-private (3F, K) tile in shared
//     memory, [plane][column][lane] so that a read is conflict-free: a step
//     reads the layer below's previous row from it, puts the last step's
//     strip in its place, and reads the own layer's previous row.  Nothing is
//     read back from `out`.
//   * Device memory in the order of the wavefront.  The lanes of a warp are
//     on 32 different rows, so a load or store a lane for its own strip would
//     touch 32 cache lines an instruction, which the SM's memory pipe takes
//     one by one.  So two small kernels that fill the card re-order the data:
//     `skew_in` writes what the lanes of super-tile T read at time t (seeds,
//     the substitution rows into each column, the step's deletion costs) as
//     one row [T][t] of a scratch buffer, lane after lane, and `skew_out` puts
//     the rows the sweep wrote back into the layout of the seeds.  In the
//     sweep a lane then moves its strip as 16 bytes beside its neighbours':
//     512 bytes an instruction.
//   * Loads that hold no register and no scoreboard.  A lane copies its part
//     of a scratch row into a ring of 3 or 4 rows in shared memory with
//     cp.async, two or three time steps before it reads it back with one
//     wait_group: a step never waits for device memory (plain loads into a
//     second set of registers, two steps ahead, still cost a third of a
//     flanked step).  Each lane reads only what it copied itself, so the ring
//     needs no barrier.
//   * A single warp on its scheduler starts its instructions in order, and a
//     branch costs it about 20 clocks.  So a step has few: a lane whose row lies
//     outside the field (the first and last 31 row times of a super-tile) or
//     whose columns do works like the others, on whatever the scratch rows
//     hold there, into its own part of the scratch rows (nothing of it can
//     reach a cell of the field); lane 31's hand-over store is predicated
//     inside the instruction; all lanes read the hand-over slot, lane 0 keeps
//     it by a select; the lane index is pinned in a register.
//   * Every clamped add is one DPX instruction (__viaddmin_s32), the three-way
//     min another (__vimin3_s32).
//   * 32 K columns are a super-tile.  Warp w of the block takes super-tiles
//     w, w + warps, ... and hands the last column of each step to the warp
//     of the next super-tile through a ring of 256 slots (64 at F > 1) in
//     shared memory: each value of a triple is one 64-bit word with the
//     triple's tag, so a reader needs no fence to know a value from a stale
//     one (of the parts of one 16-byte vector access the memory model
//     promises no order); the consumer
//     reads a slot a row time ahead and again only if the tags are not there
//     yet; the count of triples taken, published with release semantics
//     (every 16 rows at F = 1, every row else) and read with acquire
//     semantics every 16 (4) rows, holds the producer back.  Where a row has
//     more super-tiles than the block has warps (the CROSS instantiation), the
//     column goes from the last warp to warp 0's next super-tile, a whole
//     sweep later, through the scratch rows: 32 / F rows at a time, after the
//     last warp has published that they are stored (__threadfence_block(),
//     then a volatile counter).  All warps of a block are resident, a super-tile
//     waits only for the one to its left, and super-tile 0 never waits, so no
//     wait can deadlock.  A lane that waited alone is brought back by a
//     __syncwarp(): left to itself the compiler lets it run the rest of the
//     step apart from the others.
//   * K is a template constant (a multiple of 4, for the 16-byte accesses)
//     with one instantiation, 4: beside 2, 8 and 16 it was the fastest at
//     500 x 420 and 1000 x 1000, F = 1 and F = 5, and the larger ones take
//     151-222 registers.  A launch takes as many warps as the row has
//     super-tiles, up to 8 (scripts/torch_port_sweep_probe.py --tune times
//     fewer).
// One block runs one pair; filling the other SMs is the batched engine's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEV_INF = (1 << 30) - 1;
constexpr int MAX_WARPS = 8;
constexpr size_t MAX_SHARED = 232448;  // bytes of shared memory a block can take
constexpr int SLOT_INTS = 6;  // of a hand-over slot: three values, each beside the triple's tag
// Boundary triples in flight between two warps (a power of 2), and the rows
// between two looks for room in that ring (of up to 16 layers each).
__host__ __device__ constexpr int hand_slots(bool flanked) { return flanked ? 64 : 256; }
__host__ __device__ constexpr int room_rows(bool flanked) { return flanked ? 4 : 16; }
// Scratch rows on their way into a warp's shared memory, the one in use
// included (at F > 1 one less, so that 8 warps of 4 columns a lane fit a block).
__host__ __device__ constexpr int ahead(bool flanked) { return flanked ? 3 : 4; }

// Scratch rows of a super-tile: a time each, (n_rows + 31) F of them, and
// those that the copies running ahead of the last time touch.
__host__ __device__ inline long long tile_times(int n_rows, int F) {
  return (long long)(n_rows + 31) * F + ahead(false);
}

// min(a + b, c); a, b <= DEV_INF, so the sum stays inside int32.
__device__ __forceinline__ int addmin(int a, int b, int c) { return __viaddmin_s32(a, b, c); }
__device__ __forceinline__ int sat(int a, int b) { return __viaddmin_s32(a, b, DEV_INF); }
__device__ __forceinline__ int min3(int a, int b, int c) { return __vimin3_s32(a, b, c); }

struct Params {
  const int* subs;
  const int* ddrows;
  const int* seeds;
  const int* io;
  const int* ie;
  int* out;
  int* skewed_in;   // [super-tile][time][P planes of 32 K, 32 x 4 deletion costs]
  int* skewed_out;  // [super-tile][time][3 planes of 32 K]
  int n_rows, Wq, L, R, climb, dd_stride;
  long long row_stride, plane_stride;
};

// Table (1 left flank, 2 right flank) of the climb edges into layer fi, or -1.
__host__ __device__ __forceinline__ int climb_table(int fi, int R, int climb) {
  return (fi > 0 && fi <= R) ? 2 : ((fi > R && climb) ? 1 : -1);
}

// Ints of a scratch row: the seeds' three planes, the primary substitution
// row, at F > 1 the climb table's, and (open, ext) of both tables a lane.
__host__ __device__ constexpr int in_row_ints(int K, bool flanked) {
  return (flanked ? 5 : 4) * 32 * K + 128;
}
__host__ __device__ constexpr int out_row_ints(int K) { return 3 * 32 * K; }

// Ints of shared memory a warp (the ring of scratch rows; at F > 1 the
// insertion costs, the previous-row tile and the last columns) and a block (with the hand-over rings of tagged triples, a
// count of the triples taken from each; the counter and the 32 triples of the
// hand-over through the scratch rows).
__host__ __device__ inline int warp_ints(int K, bool flanked, int F) {
  const int ints = ahead(flanked) * in_row_ints(K, flanked) +
                   (flanked ? 6 * K * 32 + 3 * F * K * 32 + 3 * F * 99 + 1 : 0);
  return (ints + 3) & ~3;  // the rings take 16-byte accesses
}
__host__ __device__ inline size_t block_ints(int K, bool flanked, int F, int warps) {
  return (size_t)warps * (warp_ints(K, flanked, F) + SLOT_INTS * hand_slots(flanked) + 1) + 4 + 96;
}

// Words in shared memory that one warp publishes to another: a store with
// release and a load with acquire semantics in the block's scope.  What the
// writer stored before the one is seen by whoever reads after the other.
__device__ __forceinline__ void publish(int* word, int value) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(word);
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(a), "r"(value) : "memory");
}
__device__ __forceinline__ int observe(const int* word) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(word);
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// A slot of a hand-over ring: three 64-bit words, each a value of the triple
// under the tag of the triple.  A vector access is no single access to the
// memory model, a 64-bit scalar one is: whichever of a slot's words a reader
// finds under the tag it waits for is the value of that triple, with no fence.
// (The store is predicated inside the instruction: a lane that does not store
// takes no branch of its own, which would cost a lone warp about 20 clocks.)
__device__ __forceinline__ void tagged_store(int* word, int value, int tag, bool on) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(word);
  asm volatile(
      "{ .reg .b64 t; .reg .pred p; setp.ne.s32 p, %3, 0; mov.b64 t, {%1, %2};\n"
      "  @p st.volatile.shared.b64 [%0], t; }" ::"r"(a),
      "r"(value), "r"(tag), "r"((int)on)
      : "memory");
}
__device__ __forceinline__ int2 tagged_load(const int* word) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(word);
  int2 v;
  asm volatile("{ .reg .b64 t; ld.volatile.shared.b64 t, [%2]; mov.b64 {%0, %1}, t; }"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void hand_store(int* slot, int n, int i, int d, int tag, bool on) {
  tagged_store(slot, n, tag, on);
  tagged_store(slot + 2, i, tag, on);
  tagged_store(slot + 4, d, tag, on);
}
// The triple of a slot; .w is its tag, or -1 (no triple's) while the words disagree.
__device__ __forceinline__ int4 hand_load(const int* slot) {
  const int2 n = tagged_load(slot), i = tagged_load(slot + 2), d = tagged_load(slot + 4);
  return make_int4(n.x, i.x, d.x, (n.y == i.y && i.y == d.y) ? n.y : -1);
}

// A lane's strip of K neighbouring ints: out of a ring slot, into a scratch row.
template <int K>
__device__ __forceinline__ void load_strip(int (&dst)[K], const int* src) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const int4 v = *reinterpret_cast<const int4*>(src + k);
    dst[k] = v.x;
    dst[k + 1] = v.y;
    dst[k + 2] = v.z;
    dst[k + 3] = v.w;
  }
}

template <int K>
__device__ __forceinline__ void store_strip(int* dst, const int (&src)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4)
    *reinterpret_cast<int4*>(dst + k) = make_int4(src[k], src[k + 1], src[k + 2], src[k + 3]);
}

// Asynchronous copies from device memory into shared memory (cp.async): they
// complete in the order of their groups and hold no register while under way.
__device__ __forceinline__ void copy_16(int* dst, const int* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(src) : "memory");
}
template <int K>
__device__ __forceinline__ void copy_strip(int* dst, const int* src) {
#pragma unroll
  for (int k = 0; k < K; k += 4) copy_16(dst + k, src + k);
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// Wait until at most N of the thread's groups of copies are under way.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One block a (step, super-tile): the inputs of step s = r F + fi, re-ordered.
template <int K, bool FLANKED>
__global__ void skew_in_kernel(Params p) {
  constexpr int TW = 32 * K;
  constexpr int P = FLANKED ? 5 : 4;
  constexpr int ROW = in_row_ints(K, FLANKED);
  const int F = p.L + p.R + 1;
  const int s = blockIdx.x, tile = blockIdx.y;
  const int r = s / F, fi = s - r * F;
  const long long T = tile_times(p.n_rows, F);
  const int ct = FLANKED ? climb_table(fi, p.R, p.climb) : -1;
  const bool prim = fi == p.R;
  const int* seed = p.seeds + r * p.row_stride + (long long)(3 * fi) * p.plane_stride;
  const int* sub_p = p.subs + (size_t)r * p.Wq;
  const int* sub_c = sub_p + (size_t)(ct > 0 ? ct : 0) * p.n_rows * p.Wq;
  const int* dd = p.ddrows + (size_t)r * p.dd_stride;
  int* rows = p.skewed_in + ((size_t)tile * T + s) * ROW;  // lane k: row s + k F
  for (int c = threadIdx.x; c < TW; c += blockDim.x) {
    const int j = tile * TW + c;
    if (j >= p.Wq) break;
    int* dst = rows + (size_t)(c / K) * F * ROW + c;
    dst[0] = seed[j];
    dst[TW] = seed[p.plane_stride + j];
    dst[2 * TW] = seed[2 * p.plane_stride + j];
    if (j > 0) {
      if (prim) dst[3 * TW] = sub_p[j - 1];
      if (FLANKED && ct > 0) dst[4 * TW] = sub_c[j - 1];
    }
  }
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    const int k = i >> 2, q = i & 3;
    int v = DEV_INF;
    if (q < 2 ? prim : ct > 0) v = dd[q < 2 ? q : 2 * ct + q - 2];
    rows[(size_t)k * F * ROW + P * TW + i] = v;
  }
}

// One block a (step, super-tile): the results of step s, back in place.
template <int K>
__global__ void skew_out_kernel(Params p) {
  constexpr int TW = 32 * K;
  constexpr int ROW = out_row_ints(K);
  const int F = p.L + p.R + 1;
  const int s = blockIdx.x, tile = blockIdx.y;
  const int r = s / F, fi = s - r * F;
  const long long T = tile_times(p.n_rows, F);
  int* dst = p.out + r * p.row_stride + (long long)(3 * fi) * p.plane_stride;
  const int* rows = p.skewed_out + ((size_t)tile * T + s) * ROW;
  for (int c = threadIdx.x; c < TW; c += blockDim.x) {
    const int j = tile * TW + c;
    if (j >= p.Wq) break;
    const int* src = rows + (size_t)(c / K) * F * ROW + c;
    dst[j] = src[0];
    dst[p.plane_stride + j] = src[TW];
    dst[2 * p.plane_stride + j] = src[2 * TW];
  }
}

template <int K, bool FLANKED, bool CROSS>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) sweep_kernel(Params p) {
  static_assert(K % 4 == 0, "a strip moves as 16-byte accesses");
  extern __shared__ __align__(16) int smem[];
  constexpr int TW = 32 * K;  // columns of a super-tile
  constexpr int P = FLANKED ? 5 : 4;
  constexpr int IN_ROW = in_row_ints(K, FLANKED);
  constexpr int OUT_ROW = out_row_ints(K);
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int AHEAD = ahead(FLANKED);
  constexpr int HAND_SLOTS = hand_slots(FLANKED);
  constexpr int ROOM_ROWS = room_rows(FLANKED);
  int lane = threadIdx.x & 31;
  asm volatile("" : "+r"(lane));  // (kept in its register: not read anew from the thread index)
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int F = FLANKED ? p.L + p.R + 1 : 1;
  const int R = p.R;
  const int Wq = p.Wq;
  const int n_rows = p.n_rows;
  const int S = n_rows * F;                   // steps
  const int TT = (n_rows + 31) * F;           // times a super-tile is worked on
  const long long T = tile_times(n_rows, F);  // its scratch rows
  const int CR = 32 / F;                      // rows of a refill of cross_buf (F <= 16)
  const int n_tiles = (Wq + TW - 1) / TW;

  // A warp's shared memory: the ring of scratch rows on their way in; then, at
  // F > 1, lane-private [table][open, ext][k][lane] and [layer][gap][k][lane],
  // and the last columns, [row slot][layer][gap][lane + 1], read by the lane
  // to the right (hist[0] is the left lane's column, hist[1] the lane's own).
  int* ring = smem + (size_t)warp * warp_ints(K, FLANKED, F) + lane * K;
  int* tab = ring - lane * K + AHEAD * IN_ROW + lane;
  int* tile_s = tab + 6 * K * 32;
  int* hist = tile_s + 3 * F * K * 32;
  int* hist0 = hist - lane;
  // Hand-over of boundary columns: warp w fills ring w, warp w + 1 empties it.
  int* hand = smem + (size_t)warps * warp_ints(K, FLANKED, F);
  int* hand_out = hand + warp * SLOT_INTS * HAND_SLOTS;
  const int left_warp = warp == 0 ? warps - 1 : warp - 1;
  const int* hand_in = hand + left_warp * SLOT_INTS * HAND_SLOTS;
  int* taken = hand + warps * SLOT_INTS * HAND_SLOTS;  // triples taken out of ring w
  // From the last warp to warp 0 the column goes through the scratch rows.
  // cross_done is the last row of it that is stored (super-tile * n_rows +
  // row), cross_buf the triples of CR rows of it.
  volatile int* cross_done = (volatile int*)(taken + warps);
  int* cross_buf = hand + warps * (SLOT_INTS * HAND_SLOTS + 1) + 4;
  for (int i = threadIdx.x; i < warps * SLOT_INTS * HAND_SLOTS; i += blockDim.x) hand[i] = -1;
  if (threadIdx.x < warps) taken[threadIdx.x] = 0;
  if (threadIdx.x == 0) *cross_done = -1;
  __syncthreads();  // the only block barrier; none in the step loop
  int handed = 0, seen_taken = 0;  // lane 31: triples put into hand_out, taken as last seen
  int received = 0;                // triples taken out of hand_in

  for (int tile = warp; tile < n_tiles; tile += warps) {
    const int j0 = tile * TW + lane * K;
    // the boundary column goes to the next warp, or through the scratch to warp 0
    const bool cross_out = CROSS && tile + 1 < n_tiles && warp == warps - 1;
    const bool cross_in = CROSS && tile > 0 && warp == 0;
    const bool ring_in = tile > 0 && warp != 0;
    const bool ring_out = tile + 1 < n_tiles && !cross_out;
    const bool first_column = j0 == 0;  // column 0 of the field has no left neighbour
    // the lane's part of the scratch rows: of the next copy, of this time's store
    const int* in_row = p.skewed_in + (size_t)tile * T * IN_ROW + lane * K;
    int* out_row = p.skewed_out + (size_t)tile * T * OUT_ROW + lane * K;

    // Insertion costs into each column of the strip (from column j - 1): in
    // registers at F = 1, of the three tables in shared memory else.
    int iop[K], iep[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + k;
      const bool ok = j > 0 && j < Wq;
      if constexpr (FLANKED) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          tab[((2 * t) * K + k) * 32] = ok ? p.io[(size_t)t * Wq + j - 1] : DEV_INF;
          tab[((2 * t + 1) * K + k) * 32] = ok ? p.ie[(size_t)t * Wq + j - 1] : DEV_INF;
        }
      } else {
        iop[k] = ok ? p.io[j - 1] : DEV_INF;
        iep[k] = ok ? p.ie[j - 1] : DEV_INF;
      }
    }

    // The strip of the step just finished (none, ins, del).
    int cn[K], ci[K], cd[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cn[k] = ci[k] = cd[k] = DEV_INF;
    // F = 1: the left lane's last column of this row and of the row above.
    int ln_ = DEV_INF, li_ = DEV_INF, ld_ = DEV_INF, on_ = DEV_INF, oi_ = DEV_INF, od_ = DEV_INF;
    int fi = 0, r0 = 0;  // all lanes are in layer fi, lane k in row r0 - k
    // F = 1: the next slot of hand_in (its place in smem, the last slot's) as last read
    int4 v_ahead = make_int4(0, 0, 0, -1);
    const int slot_last = (int)(hand_in - smem) + SLOT_INTS * (HAND_SLOTS - 1);
    int slot_from = (int)(hand_in - smem) + SLOT_INTS * (received & (HAND_SLOTS - 1));
    int* taken_in = taken + left_warp;
    int slot_in = 0, slot_use = 0;  // ring slots (in ints) of the next copy and of this time's row
    // row slots of the last columns: written in this row time, the one
    // before (the left lane's same row) and two before (its row above)
    int o_mine = 0, o_cur = F * 99, o_prv = 2 * F * 99;

    // The lane's part of the next scratch row, on its way into a ring slot.
    auto copy_inputs = [&]() {
      int* dst = ring + slot_in;
#pragma unroll
      for (int pl = 0; pl < P; ++pl) copy_strip<K>(dst + pl * TW, in_row + pl * TW);
      copy_16(dst + P * TW + (4 - K) * lane, in_row + P * TW + (4 - K) * lane);
      copy_commit();
      in_row += IN_ROW;
      slot_in = slot_in == (AHEAD - 1) * IN_ROW ? 0 : slot_in + IN_ROW;
    };

    // The next CR rows' triples of the column left of warp 0's super-tile,
    // once the last warp has published that they are stored.
    auto cross_refill = [&]() {
      const int last = min(r0 + CR - 1, n_rows - 1);
      if (lane == 0) {
        while (*cross_done < (tile - 1) * n_rows + last) {
        }
      }
      __threadfence_block();
      __syncwarp();
      const int s = r0 * F + lane;  // lane 31 of that super-tile stored step s at time s + 31 F
      if (lane < CR * F && s < S) {
        const volatile int* src =
            p.skewed_out + ((size_t)(tile - 1) * T + s + 31 * F) * OUT_ROW + TW - 1;
        cross_buf[3 * lane] = src[0];
        cross_buf[3 * lane + 1] = src[TW];
        cross_buf[3 * lane + 2] = src[2 * TW];
      }
      __syncwarp();
    };

    // Once a row, before its layer 0: the last column of the lane (or the
    // warp) to the left; every few rows, room in the ring to the right.
    auto row_start = [&]() {
      if (ring_out && (r0 & (ROOM_ROWS - 1)) == 0) {
        if (lane == 31 && handed + ROOM_ROWS * F - seen_taken > HAND_SLOTS) {
          do {
            seen_taken = observe(taken + warp);
          } while (handed + ROOM_ROWS * F - seen_taken > HAND_SLOTS);
        }
        __syncwarp();  // (a lane that waited alone comes back here)
      }
      if constexpr (FLANKED) {
        const bool receive = r0 < n_rows && (ring_in || cross_in);
        __syncwarp();  // the left lane's writes of the last row time, before this one's reads
        const int o = o_prv;
        o_prv = o_cur;
        o_cur = o_mine;
        o_mine = o;
        if (receive) {
          // lane fi takes layer fi's triple, as if a lane to the left had written it
          if (ring_in) {
            if (lane < F) {
              const int want = received + lane;
              const int* from = hand_in + SLOT_INTS * (want & (HAND_SLOTS - 1));
              int4 v = hand_load(from);
              while (v.w != want) v = hand_load(from);
              int* h = hist0 + o_cur + lane * 99;
              h[0] = v.x;
              h[33] = v.y;
              h[66] = v.z;
            }
            received += F;
            __syncwarp();
            // (every row: at 16 layers the producer waits for all it handed to be taken)
            if (lane == 0) publish(taken + left_warp, received);
          } else {
            if (r0 % CR == 0) cross_refill();
            if (lane < F) {
              const int* c = cross_buf + 3 * ((r0 % CR) * F + lane);
              int* h = hist0 + o_cur + lane * 99;
              h[0] = c[0];
              h[33] = c[1];
              h[66] = c[2];
            }
          }
          __syncwarp();
        }
      } else {
        on_ = ln_;
        oi_ = li_;
        od_ = ld_;
        ln_ = __shfl_up_sync(FULL, cn[K - 1], 1);
        li_ = __shfl_up_sync(FULL, ci[K - 1], 1);
        ld_ = __shfl_up_sync(FULL, cd[K - 1], 1);
        if (ring_in) {
          // (the shuffles above had every lane past its last reads of the slots taken so far)
          if (lane == 0 && (r0 & (ROOM_ROWS - 1)) == 0) publish(taken_in, received);
          if (r0 < n_rows) {
            // every lane reads the one slot (no lane branches alone), a row time ahead
            while (v_ahead.w != received) v_ahead = hand_load(smem + slot_from);
            ++received;
            ln_ = lane == 0 ? v_ahead.x : ln_;
            li_ = lane == 0 ? v_ahead.y : li_;
            ld_ = lane == 0 ? v_ahead.z : ld_;
            slot_from = slot_from == slot_last ? slot_last - SLOT_INTS * (HAND_SLOTS - 1)
                                               : slot_from + SLOT_INTS;
          }
        }
        if constexpr (CROSS) {
          if (cross_in && r0 < n_rows) {
            if ((r0 & 31) == 0) cross_refill();
            const int vx = cross_buf[3 * (r0 & 31)];
            const int vy = cross_buf[3 * (r0 & 31) + 1];
            const int vz = cross_buf[3 * (r0 & 31) + 2];
            __syncwarp();
            ln_ = lane == 0 ? vx : ln_;
            li_ = lane == 0 ? vy : li_;
            ld_ = lane == 0 ? vz : ld_;
          }
        }
      }
    };

    // Once a row of the last warp, behind its last layer: lane 31 has finished
    // row r0 - 31; every CR rows the warp publishes that its column is stored.
    auto row_end = [&]() {
      const int rr = r0 - 31;
      if (rr >= 0 && rr < n_rows && (rr % CR == CR - 1 || rr == n_rows - 1)) {
        __threadfence_block();
        __syncwarp();
        if (lane == 31) *cross_done = tile * n_rows + rr;
      }
    };

    // One time step: all lanes in layer fi, the lane in row r0 - lane.  A lane
    // whose row is not one of the field (the first and last 31 row times of a
    // super-tile) or whose columns lie beyond it works like the others, on
    // what the scratch rows hold there, into its own part of the scratch rows:
    // nothing of that reaches a cell of the field, since values only move to
    // later rows and columns and a lane's first row takes nothing from above.
    auto step = [&]() {
      copy_inputs();
      if (!FLANKED || fi == 0) row_start();
      const int r = r0 - lane;
      const bool primary = !FLANKED || fi == R;  // the same for all lanes
      const int ct = FLANKED ? climb_table(fi, R, p.climb) : -1;
      const bool climbs = ct > 0;
      const bool row_above = r > 0;
      copy_wait<AHEAD - 1>();  // this time's row has arrived
      const int* in = ring + slot_use;
      slot_use = slot_use == (AHEAD - 1) * IN_ROW ? 0 : slot_use + IN_ROW;
      int sn[K], si[K], sd[K];
      load_strip<K>(sn, in);
      load_strip<K>(si, in + TW);
      load_strip<K>(sd, in + 2 * TW);
      const int4 dd = *reinterpret_cast<const int4*>(in + P * TW + (4 - K) * lane);
      const int lo = fi * 99;
      int* tb = tile_s + (fi == 0 ? F - 1 : fi - 1) * (3 * K * 32);
      if constexpr (FLANKED) if (climbs) {  // edges out of the layer below
        const int* hb = hist + o_cur + lo - 99;  // the left lane's, this row
        const int* hp = hist + o_prv + lo - 99;  // and the row above
        int wn = hb[0], wi = hb[33], wd = hb[66];
        int pn = hp[0], pi = hp[33], pd = hp[66];
        const int* io_c = tab + (2 * ct) * K * 32;
        const int* ie_c = io_c + K * 32;
        const int c_open = dd.z, c_ext = dd.w;
        int sc[K], gn[K], gi[K], gd[K], ioc[K], iec[K];
        load_strip<K>(sc, in + 4 * TW);
#pragma unroll
        for (int k = 0; k < K; ++k) {  // its previous row out of the tile
          gn[k] = tb[k * 32];
          gi[k] = tb[(K + k) * 32];
          gd[k] = tb[(2 * K + k) * 32];
          ioc[k] = io_c[k * 32];
          iec[k] = ie_c[k * 32];
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool from_left = k > 0 || !first_column;
          const int diag = sat(min3(pn, pi, pd), sc[k]);
          sn[k] = min(sn[k], (row_above && from_left) ? diag : DEV_INF);
          const int dnew = min(sat(min(gn[k], gi[k]), c_open), sat(gd[k], c_ext));
          sd[k] = min(sd[k], row_above ? dnew : DEV_INF);
          const int inew = min(sat(min(wn, wd), ioc[k]), sat(wi, iec[k]));
          si[k] = min(si[k], from_left ? inew : DEV_INF);
          pn = gn[k];
          pi = gi[k];
          pd = gd[k];
          wn = cn[k];
          wi = ci[k];
          wd = cd[k];
        }
      }
      int an[K], ai[K], ad[K];  // own layer, previous row
      if constexpr (FLANKED) {
        // the last step's strip into the tile; the own layer's previous row out
        const int* to = tile_s + fi * (3 * K * 32);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          tb[k * 32] = cn[k];
          tb[(K + k) * 32] = ci[k];
          tb[(2 * K + k) * 32] = cd[k];
        }
        if (primary) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            an[k] = to[k * 32];
            ai[k] = to[(K + k) * 32];
            ad[k] = to[(2 * K + k) * 32];
            iop[k] = tab[k * 32];
            iep[k] = tab[(K + k) * 32];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          an[k] = cn[k];
          ai[k] = ci[k];
          ad[k] = cd[k];
        }
      }
      if (primary) {  // the own previous row and the insertion chain
        int ln, li, ld, on, oi, od;
        if constexpr (FLANKED) {
          const int* h = hist + o_cur + lo;
          const int* ho = hist + o_prv + lo;
          ln = h[0], li = h[33], ld = h[66];
          on = ho[0], oi = ho[33], od = ho[66];
        } else {
          ln = ln_, li = li_, ld = ld_;
          on = on_, oi = oi_, od = od_;
        }
        int sp[K];
        load_strip<K>(sp, in + 3 * TW);
        const int p_open = dd.x, p_ext = dd.y;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool from_left = k > 0 || !first_column;
          const int diag = sat(min3(on, oi, od), sp[k]);
          const int none = min(sn[k], (row_above && from_left) ? diag : DEV_INF);
          const int dnew = min(sat(min(an[k], ai[k]), p_open), sat(ad[k], p_ext));
          const int del = min(sd[k], row_above ? dnew : DEV_INF);
          on = an[k];
          oi = ai[k];
          od = ad[k];
          // the chain, from column j - 1 of this step
          const int open = sat(min(ln, ld), iop[k]);
          const int cand = min(si[k], from_left ? open : DEV_INF);
          const int run = addmin(li, iep[k], cand);
          const int ins = from_left ? run : cand;
          ln = none;
          li = ins;
          ld = del;
          sn[k] = none;
          si[k] = ins;
          sd[k] = del;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {  // (a layer that neither climbs nor is f = 0 holds its seeds)
        cn[k] = sn[k];
        ci[k] = si[k];
        cd[k] = sd[k];
      }
      if constexpr (FLANKED) {
        int* hw = hist + o_mine + lo + 1;
        hw[0] = cn[K - 1];
        hw[33] = ci[K - 1];
        hw[66] = cd[K - 1];
      }
      store_strip<K>(out_row, cn);
      store_strip<K>(out_row + TW, ci);
      store_strip<K>(out_row + 2 * TW, cd);
      out_row += OUT_ROW;
      // the boundary column of a row of the field, to the warp of the next super-tile
      const bool hands = ring_out && lane == 31 && (unsigned)r < (unsigned)n_rows;
      hand_store(hand_out + SLOT_INTS * (handed & (HAND_SLOTS - 1)), cn[K - 1], ci[K - 1],
                 cd[K - 1], handed, hands);
      handed += hands;
      if constexpr (!FLANKED) {
        if (ring_in) v_ahead = hand_load(smem + slot_from);  // next row time's, if it is there
      }
      if constexpr (FLANKED) {
        const bool last = fi == F - 1;
        if (last && cross_out) row_end();
        r0 += last;
        fi = last ? 0 : fi + 1;
      } else {
        if (cross_out) row_end();
        ++r0;
      }
    };

    __syncwarp();
#pragma unroll
    for (int u = 0; u < AHEAD - 1; ++u) copy_inputs();  // a copy is AHEAD - 1 times ahead
#pragma unroll 1
    for (int t = 0; t < TT; ++t) step();
    copy_wait<0>();  // (the copies beyond the last time, before the next super-tile's)
  }
}

// Clocks of n dependent __viaddmin_s32 in one thread (n a multiple of 16).
__global__ void dpx_chain_kernel(long long* out, int n, int a, int b, int c) {
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = __viaddmin_s32(a, b, c);
  }
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = a;
}

template <int K, bool FLANKED>
int launch(const Params& p, int warps, cudaStream_t stream) {
  const int F = p.L + p.R + 1;
  const int n_tiles = (p.Wq + 32 * K - 1) / (32 * K);
  if (warps <= 0) warps = MAX_WARPS;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  if (warps > n_tiles) warps = n_tiles;
  while (warps > 1 && block_ints(K, FLANKED, F, warps) * sizeof(int) > MAX_SHARED) --warps;
  const size_t bytes = block_ints(K, FLANKED, F, warps) * sizeof(int);
  if (bytes > MAX_SHARED) return (int)cudaErrorInvalidValue;
  // (a row of more super-tiles than warps: the instantiation with the
  // hand-over through the scratch rows)
  auto kernel = n_tiles > warps ? sweep_kernel<K, FLANKED, true> : sweep_kernel<K, FLANKED, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SHARED);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_rows * F, n_tiles);
  skew_in_kernel<K, FLANKED><<<grid, 32 * K < 256 ? 32 * K : 256, 0, stream>>>(p);
  kernel<<<1, warps * 32, bytes, stream>>>(p);
  skew_out_kernel<K><<<grid, 32 * K < 256 ? 32 * K : 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

constexpr int COLUMNS_A_LANE = 4;  // the one instantiation (see the header note)

}  // namespace

// Ints of the two scratch buffers a sweep of this shape needs: every
// super-tile has (n_rows + 31) F rows in each.
extern "C" int tsa_sweep_scratch(int n_rows, int Wq, int F, long long* in_ints,
                                 long long* out_ints) {
  constexpr int K = COLUMNS_A_LANE;
  const long long rows = (long long)((Wq + 32 * K - 1) / (32 * K)) * tile_times(n_rows, F);
  *in_ints = rows * in_row_ints(K, F > 1);
  *out_ints = rows * out_row_ints(K);
  return 0;
}

// warps is 1 .. 8, or 0 for as many as the super-tiles of a row and the
// shared memory of a block allow.  The scratch buffers are 16-byte aligned
// and hold what tsa_sweep_scratch says.
extern "C" int tsa_sweep(const int* subs, const int* ddrows, const int* seeds, const int* io,
                         const int* ie, int* out, int* skewed_in, int* skewed_out, int n_rows,
                         int Wq, int L, int R, int climb, int dd_stride, long long row_stride,
                         long long plane_stride, int warps, void* stream) {
  Params p{subs, ddrows, seeds, io, ie, out, skewed_in, skewed_out, n_rows, Wq, L, R, climb,
           dd_stride, row_stride, plane_stride};
  cudaStream_t st = (cudaStream_t)stream;
  return L + R > 0 ? launch<COLUMNS_A_LANE, true>(p, warps, st)
                   : launch<COLUMNS_A_LANE, false>(p, warps, st);
}

// out[0] = clocks of n dependent __viaddmin_s32 in one thread, out[1] their value.
extern "C" int tsa_dpx_chain(long long* out, int n, void* stream) {
  dpx_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, n, 1, 1, DEV_INF);
  return (int)cudaGetLastError();
}
