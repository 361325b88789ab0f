// SPA (dense accumulator) numeric phase for one bucket's rows, compaction
// fused in: per output row, its distinct columns in ascending order and
// their value sums written straight into the row's row_capacity slots, plus
// the row's true nnz (which may exceed the capacity).
//
// Replaces: src/repro/kernels/accumulator.py::spa_numeric_pallas
// (_spa_numeric_kernel, _accumulate_tile), which one-hot-accumulates each
// row block's value products into dense column tiles of an extent-relative
// (R, n_tiles*tile_n) window with a presence mask beside them, and the
// XLA-side src/repro/core/spgemm.py::compact_dense that scatters that window
// into the capacity slots.
//
// Design: a row unit owns one output row at a time: a group of lanes of
// one warp (as many as a B row's entries, SPA_MIN_GROUP to 32, so 32 /
// group rows share a warp) or, in a launch too small to fill the card with
// groups (fewer than SPA_FILL warps an SM), a block of SPA_WARPS warps.
// Its workspace holds the row's tables (max_deg_a entries each) and a
// dense tile of tile_n lanes, in shared memory when a block's units fit the
// card's opt-in limit, else in a global scratch slice per unit (the host
// decides before the launch, _build.spa_numeric_shape).  The group size
// and the workspace's place are template parameters.  No atomic adds a
// value; an integer atomic sums the overflow.
//
//   1. The unit stages the row's A entries in one coalesced pass: each
//      entry's value and its truncated B row [start, end), and takes the
//      row's smallest and largest product column (lo, the extent_relative
//      offset, and hi) from each B row's first and last entry.  Nothing is
//      found by a search over a product prefix.
//   2. Tiles lo + t·tile_n, in column order; only tiles that hold a product
//      are visited, and products past the n_tiles·tile_n window are dropped.
//      When the row's remaining extent ends inside the tile (every tile of
//      the main path's SPA buckets), each B row is taken whole; else a
//      binary search finds where each B row leaves the tile, and the next
//      tile starts at that cursor, so each product is read once.
//   3. Sums follow A-entry order: for j = 0, 1, ... the lanes stride over B
//      row j's entries and add __fmul_rn(a_j, b) into the tile with
//      __fadd_rn (named roundings: nothing is contracted into an FMA).  A
//      sorted B row holds each column once, so no two lanes of one wave
//      touch one tile lane; a B row that repeats a column (from_coo with
//      dedup=False) is found with a shuffle, and its repeats are added one
//      at a time in lane order.  A sync of the group separates the waves.
//      Each lane loads SPA_WAVES waves (several B rows) before it adds the
//      first, so the dependent gathers overlap; the adds still run in wave
//      order.  A block unit first copies the tile's B entries into its
//      workspace, all its threads loading at once, and each warp then adds
//      the entries that fall in its slice of the tile from the copy.
//      Either way each column's products are added one at a time, in
//      A-entry order, from 0.0f: val is the same, bit for bit, from run to
//      run and whichever unit took the row.
//   4. Compaction reads the tile a group of lanes at a time, in column
//      order; a ballot of the lanes that hold a sum gives each its slot, so
//      the first row_capacity columns land in ascending order, and a sum
//      that cancels to 0.0 stays an entry (an empty lane is marked by a NaN
//      that no sum can be, SPA_EMPTY, not by a presence mask).  The true
//      nnz runs on past the capacity.  Compaction empties the lanes it
//      reads, so the tile is ready for the next row.
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots (8 bytes each); the tile (1 KB on a 256-column FEM extent, 64 KB
// for a forced 16384-lane tile) stays in shared memory.  What bounds the
// kernel in practice is the issue of its waves: each product is a load, a
// shared-memory read-modify-write and its share of the wave's sync.
#include "common.cuh"

// warps of a block; spa_numeric_shape in _build.py reads the three defines
#define SPA_WARPS 8
// fewest lanes a row takes in warp units: rows share a warp down to this
#define SPA_MIN_GROUP 8
static_assert(SPA_MIN_GROUP == 8,
              "spa_numeric_launch instantiates groups of 8, 16 and 32 lanes");
// a launch whose warp units would fill fewer warps than this on each SM
// takes a block a row instead
#define SPA_FILL 8
// waves of B entries each lane loads before it adds the first of them
#define SPA_WAVES 4
// An empty tile lane: a NaN that __fmul_rn and __fadd_rn never produce
// (their NaN results are the canonical 0x7fffffff), so a lane holds either
// this or a sum, and no presence mask is kept beside the tile.
#define SPA_EMPTY 0xffffffffu

// A row unit's workspace, laid out from its base: cur, end, stop and the A
// values (max_deg_a + 1 entries each, 16-byte aligned), then, in a block
// unit, pre; then the tile's tile_n lanes (float bits, SPA_EMPTY where no
// product landed); then, in a block unit, a copy of the tile's B entries
// (max_deg_a * max_deg_b columns and values) and two tables a warp.
struct SpaWork {
  int* cur;             // entry j's next B entry
  int* end;             // entry j's B row end (truncated to max_deg_b)
  int* stop;            // entry j's first B entry past the current tile
  float* av;            // entry j's value
  int* pre;             // block unit: entry j's first slot in the copy
  unsigned* tile;
  int* pcol;            // block unit: the copy's B columns and values
  float* pval;
  int* slice;           // block unit: each warp's [first, end) slots of
                        // entry j's copy that fall in its tile lanes
};

__device__ inline SpaWork spa_work(char* base, int max_deg_a, int max_deg_b,
                                   int tile_n, bool block) {
  const long long table = repro_align16(4LL * (max_deg_a + 1));
  SpaWork w;
  w.cur = reinterpret_cast<int*>(base);
  w.end = reinterpret_cast<int*>(base + table);
  w.stop = reinterpret_cast<int*>(base + 2 * table);
  w.av = reinterpret_cast<float*>(base + 3 * table);
  w.pre = block ? reinterpret_cast<int*>(base + 4 * table) : nullptr;
  w.tile = reinterpret_cast<unsigned*>(base + (block ? 5 : 4) * table);
  w.pcol = reinterpret_cast<int*>(w.tile + tile_n);
  w.pval = reinterpret_cast<float*>(
      w.pcol + static_cast<long long>(max_deg_a) * max_deg_b);
  w.slice = reinterpret_cast<int*>(repro_align16(reinterpret_cast<long long>(
      w.pval + static_cast<long long>(max_deg_a) * max_deg_b)));
  return w;
}

// The threads that own a row: a group of lanes (BLOCK false) or the whole
// block; g is the thread's group, the whole warp in a block unit.
template <bool BLOCK>
struct SpaUnit {
  ReproGroup g;
  __device__ int lane() const { return BLOCK ? threadIdx.x : g.lane; }
  __device__ int size() const { return BLOCK ? blockDim.x : g.size; }
  __device__ void sync() const {
    if (BLOCK) __syncthreads(); else __syncwarp(g.mask);
  }
  // (min of lo, max of hi) over the unit, to every thread
  __device__ void min_max(int& lo, int& hi) const {
    for (int o = g.size >> 1; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(g.mask, lo, o, g.size));
      hi = max(hi, __shfl_xor_sync(g.mask, hi, o, g.size));
    }
    if (!BLOCK) return;
    __shared__ int part[2][32];
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    if (g.lane == 0) {
      part[0][warp] = lo;
      part[1][warp] = hi;
    }
    __syncthreads();
    for (int v = 0; v < warps; ++v) {
      lo = min(lo, part[0][v]);
      hi = max(hi, part[1][v]);
    }
    __syncthreads();
  }
};

// Add p to a tile lane: from 0.0f if the lane is empty.
__device__ __forceinline__ void spa_add(unsigned* lane, float p) {
  const unsigned old = *lane;
  *lane = __float_as_uint(
      __fadd_rn(old == SPA_EMPTY ? 0.0f : __uint_as_float(old), p));
}

// A wave whose B row repeats a column: the repeats sit in neighbouring
// lanes.  A lane's rank is the number of lanes just before it holding its
// column; the wave then adds rank 0, 1, ... in turn, so each repeat is
// added on its own, in lane order, wherever the wave boundaries fall.
__device__ __forceinline__ int spa_repeat_rank(int c, ReproGroup g) {
  int rank = 0;
  for (int d = 1; d < g.size; ++d) {
    const int c2 = __shfl_up_sync(g.mask, c, d, g.size);
    const bool more = g.lane >= d && c >= 0 && c2 == c && rank == d - 1;
    if (more) rank = d;
    if (!__any_sync(g.mask, more)) break;
  }
  return rank;
}

// Step 3: add the products of B entries [cur[j], stop[j]) (of b_col and
// b_val) of every A entry j < deg that fall in tile lanes [s0, s1) (the
// tile's lane 0 is column t0) into the tile, in wave order, by the group g.
// A wave with no product in [s0, s1) is skipped.
__device__ __forceinline__ void spa_accumulate(
    const SpaWork& w, const int* cur, const int* stop, int deg, int t0,
    int s0, int s1, const int* __restrict__ b_col,
    const float* __restrict__ b_val, ReproGroup g) {
  // the next wave: entry j (value aj), its B entries from cj + off, lenj of
  // them in the tile
  int j = -1, off = 0, cj = 0, lenj = 0;
  float aj = 0.0f;
  while (true) {
    // the batch's schedule first (shared-memory reads only), then its
    // gathers back to back, so they are all in flight at once
    int at[SPA_WAVES];
    float a[SPA_WAVES];
    int n = 0;                              // waves in the batch (uniform)
#pragma unroll
    for (int u = 0; u < SPA_WAVES; ++u) {
      while (off >= lenj && j < deg) {      // uniform across the group
        ++j;
        off = 0;
        if (j < deg) {
          cj = cur[j];
          lenj = stop[j] - cj;
          aj = w.av[j];
        }
      }
      at[u] = -1;
      a[u] = aj;
      if (j < deg) {
        const int e = off + g.lane;
        if (e < lenj) at[u] = cj + e;
        off += g.size;
        n = u + 1;
      }
    }
    int col[SPA_WAVES];
    float p[SPA_WAVES];
#pragma unroll
    for (int u = 0; u < SPA_WAVES; ++u) {
      col[u] = at[u] >= 0 ? b_col[at[u]] : -1;
      p[u] = at[u] >= 0 ? b_val[at[u]] : 0.0f;
    }
    if (n == 0) break;
    // the products, and whether any wave repeats a column
    bool dup = false;
#pragma unroll
    for (int u = 0; u < SPA_WAVES; ++u) {
      p[u] = __fmul_rn(a[u], p[u]);
      const int prev = __shfl_up_sync(g.mask, col[u], 1, g.size);
      dup = dup || (g.lane > 0 && col[u] >= 0 && prev == col[u]);
    }
    if (!__any_sync(g.mask, dup)) {
#pragma unroll
      for (int u = 0; u < SPA_WAVES; ++u) {
        if (u >= n) break;
        const int l = col[u] - t0;
        const bool mine = col[u] >= 0 && l >= s0 && l < s1;
        if (!__any_sync(g.mask, mine)) continue;
        if (mine) spa_add(w.tile + l, p[u]);
        __syncwarp(g.mask);
      }
      continue;
    }
    // a B row that repeats a column: the lanes of each rank in turn
#pragma unroll
    for (int u = 0; u < SPA_WAVES; ++u) {
      if (u >= n) break;
      const int l = col[u] - t0;
      const bool mine = col[u] >= 0 && l >= s0 && l < s1;
      if (!__any_sync(g.mask, mine)) continue;
      const int rank = spa_repeat_rank(col[u], g);
      int top = rank;
      for (int o = g.size >> 1; o > 0; o >>= 1)
        top = max(top, __shfl_xor_sync(g.mask, top, o, g.size));
      for (int r = 0; r <= top; ++r) {
        if (mine && rank == r) spa_add(w.tile + l, p[u]);
        __syncwarp(g.mask);
      }
    }
  }
}

// Present lanes of tile lanes [s0, s1), to every lane of the group.
__device__ __forceinline__ int spa_count(const SpaWork& w, int s0, int s1,
                                         ReproGroup g) {
  int n = 0;
  for (int l = s0 + g.lane; l - g.lane < s1; l += g.size)
    n += __popc(__ballot_sync(g.mask, l < s1 && w.tile[l] != SPA_EMPTY) &
                g.mask);
  return n;
}

// Step 4: compact tile lanes [s0, s1) (lane 0 = column col0) into slots
// base, base + 1, ... below cap, emptying what it reads; returns their
// count of present lanes to every lane of the group.
__device__ __forceinline__ int spa_compact(const SpaWork& w, int s0, int s1,
                                           int base, int cap, int col0,
                                           int* __restrict__ col_row,
                                           float* __restrict__ val_row,
                                           ReproGroup g) {
  const unsigned below = g.mask & ((1u << (threadIdx.x & 31)) - 1u);
  int n = 0;
  for (int l = s0 + g.lane; l - g.lane < s1; l += g.size) {
    const unsigned v = l < s1 ? w.tile[l] : SPA_EMPTY;
    const unsigned set = __ballot_sync(g.mask, v != SPA_EMPTY) & g.mask;
    if (!set) continue;
    if (v != SPA_EMPTY) {
      const int slot = base + n + __popc(set & below);
      if (slot < cap) {
        col_row[slot] = col0 + l;
        val_row[slot] = __uint_as_float(v);
      }
      w.tile[l] = SPA_EMPTY;
    }
    n += __popc(set);
  }
  __syncwarp(g.mask);
  return n;
}

// GROUP > 0: a group of GROUP lanes a row (SPA_MIN_GROUP to 32 lanes,
// 32 / GROUP rows a warp), reading B as it adds.  GROUP 0 (launches
// too small to fill the card with groups): a block a row; the block first
// copies the tile's B entries into the unit's workspace, every thread
// loading a few of them at once, so the row's gathers overlap, then warp v
// of the block's W adds those in tile lanes [v·tile_n/W, (v+1)·tile_n/W)
// from the copy, in the same order and with the same roundings as a group
// (val does not depend on the unit).  Each unit's workspace is unit_bytes
// at its index in the block's shared memory or, with SCRATCH, in `scratch`
// at its index in the grid.  Both are template parameters, so a group's
// lane mask is a constant (no run-time mask to converge on) and the
// workspace's address space is known.
template <int GROUP, bool SCRATCH>
__global__ void __launch_bounds__(SPA_WARPS * 32) spa_numeric_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int tile_n, int n_tiles,
    int row_capacity, char* scratch, long long unit_bytes,
    int* __restrict__ out_col, float* __restrict__ out_val,
    int* __restrict__ row_nnz, int* __restrict__ overflow) {
  constexpr bool BLOCK = GROUP == 0;
  extern __shared__ __align__(16) char smem[];
  __shared__ int counts[32];
  constexpr int LANES = BLOCK ? 32 : GROUP;   // a warp in a block unit
  const SpaUnit<BLOCK> u{repro_group(LANES)};
  const int per_block = BLOCK ? 1 : blockDim.x / LANES;
  const int u_block = BLOCK ? 0 : threadIdx.x / LANES;
  const long long unit = static_cast<long long>(blockIdx.x) * per_block +
                         u_block;
  const long long units = static_cast<long long>(gridDim.x) * per_block;
  if (unit >= n_rows) return;        // the whole unit leaves
  const SpaWork w = spa_work(
      SCRATCH ? scratch + unit * unit_bytes : smem + u_block * unit_bytes,
      max_deg_a, max_deg_b, tile_n, BLOCK);
  // this warp's tile lanes: all of them in a group unit
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int s0 = BLOCK ? warp * (tile_n / warps) : 0;
  const int s1 = BLOCK ? s0 + tile_n / warps : tile_n;
  for (int l = u.lane(); l < tile_n; l += u.size()) w.tile[l] = SPA_EMPTY;
  const int cap = row_capacity;
  for (long long ri = unit; ri < n_rows; ri += units) {
    const int r = rows[ri];
    int start = 0, deg = 0;
    if (r >= 0 && r < m) {
      start = a_rpt[r];
      deg = max(0, min(a_rpt[r + 1] - start, max_deg_a));
    }
    // 1. stage the A entries; the row's product-column extent
    int lo = REPRO_SENTINEL, hi = -1;
    for (int j = u.lane(); j < deg; j += u.size()) {
      const int k = a_col[start + j];
      const int len =
          (k >= 0 && k < k_rows) ? max(0, min(rownnz_b[k], max_deg_b)) : 0;
      const int e0 = len ? b_rpt[k] : 0;
      w.cur[j] = e0;
      w.end[j] = e0 + len;
      w.av[j] = a_val[start + j];
      if (len) {
        lo = min(lo, b_col[e0]);
        hi = max(hi, b_col[e0 + len - 1]);
      }
    }
    u.min_max(lo, hi);
    u.sync();
    int* col_row = out_col + ri * cap;
    float* val_row = out_val + ri * cap;
    int nnz = 0;
    if (hi >= 0) {
      // 2. the window's tiles that hold products, in column order
      const long long wend =
          static_cast<long long>(lo) + static_cast<long long>(n_tiles) * tile_n;
      int t0 = lo;
      while (true) {
        const long long t_end = min(static_cast<long long>(t0) + tile_n, wend);
        const bool rest_fits = hi < t_end;
        if (!rest_fits) {
          // where each B row leaves the tile (its columns are sorted)
          for (int j = u.lane(); j < deg; j += u.size()) {
            int a = w.cur[j], b = w.end[j];
            while (a < b) {
              const int mid = (a + b) >> 1;
              if (b_col[mid] < t_end) a = mid + 1; else b = mid;
            }
            w.stop[j] = a;
          }
          u.sync();
        }
        const int* stop = rest_fits ? w.end : w.stop;
        // 3. the tile's products, in A-entry order
        if (BLOCK) {
          // the copy: entry j's B entries from slot pre[j]
          for (int j = threadIdx.x; j < deg; j += blockDim.x)
            w.pre[j] = stop[j] - w.cur[j];
          __syncthreads();
          const int total = repro_block_offsets(w.pre, deg);
          for (int q0 = threadIdx.x; q0 < total; q0 += 4 * blockDim.x) {
            int c[4];
            float v[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int q = q0 + x * blockDim.x;
              if (q < total) {
                int lo_j = 0, hi_j = deg;     // pre[lo_j] <= q < pre[hi_j]
                while (hi_j - lo_j > 1) {
                  const int mid = (lo_j + hi_j) >> 1;
                  if (w.pre[mid] <= q) lo_j = mid; else hi_j = mid;
                }
                const int e = w.cur[lo_j] + q - w.pre[lo_j];
                c[x] = b_col[e];
                v[x] = b_val[e];
              }
            }
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int q = q0 + x * blockDim.x;
              if (q < total) {
                w.pcol[q] = c[x];
                w.pval[q] = v[x];
              }
            }
          }
          __syncthreads();
          // where each entry's copy enters and leaves this warp's lanes
          const long long table = repro_align16(4LL * (max_deg_a + 1));
          int* first = reinterpret_cast<int*>(
              reinterpret_cast<char*>(w.slice) + 2 * warp * table);
          int* last = reinterpret_cast<int*>(
              reinterpret_cast<char*>(first) + table);
          for (int j = u.g.lane; j < deg; j += 32) {
            const long long edge[2] = {static_cast<long long>(t0) + s0,
                                       static_cast<long long>(t0) + s1};
            int at[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              int a = w.pre[j], b = w.pre[j + 1];
              while (a < b) {
                const int mid = (a + b) >> 1;
                if (w.pcol[mid] < edge[x]) a = mid + 1; else b = mid;
              }
              at[x] = a;
            }
            first[j] = at[0];
            last[j] = at[1];
          }
          __syncwarp();
          spa_accumulate(w, first, last, deg, t0, s0, s1, w.pcol, w.pval,
                         u.g);
        } else {
          spa_accumulate(w, w.cur, stop, deg, t0, s0, s1, b_col, b_val, u.g);
        }
        // 4. its present lanes into the next slots
        if (BLOCK) {
          const int c = spa_count(w, s0, s1, u.g);
          if (u.g.lane == 0) counts[warp] = c;
          __syncthreads();
          int before = 0, total = 0;
          for (int v = 0; v < warps; ++v) {
            before += v < warp ? counts[v] : 0;
            total += counts[v];
          }
          spa_compact(w, s0, s1, nnz + before, cap, t0, col_row, val_row,
                      u.g);
          nnz += total;
          __syncthreads();
        } else {
          nnz += spa_compact(w, s0, s1, nnz, cap, t0, col_row, val_row, u.g);
        }
        if (rest_fits || t_end >= wend) break;
        // the next tile: the one of the smallest column left
        int next = REPRO_SENTINEL, unused = -1;
        for (int j = u.lane(); j < deg; j += u.size()) {
          const int c = w.stop[j];
          w.cur[j] = c;
          if (c < w.end[j]) next = min(next, b_col[c]);
        }
        u.min_max(next, unused);
        u.sync();
        if (next == REPRO_SENTINEL || next >= wend) break;
        t0 = lo + (next - lo) / tile_n * tile_n;
      }
    }
    for (int s = min(nnz, cap) + u.lane(); s < cap; s += u.size()) {
      col_row[s] = REPRO_SENTINEL;
      val_row[s] = 0.0f;
    }
    if (u.lane() == 0) {
      row_nnz[ri] = nnz;
      if (nnz > cap) atomicAdd(overflow, nnz - cap);
    }
    // keep the next row's tables off this row's reads
    u.sync();
  }
}

template <int GROUP, bool SCRATCH>
static cudaError_t spa_run(const void* rows, int n_rows, const void* a_rpt,
                           const void* a_col, const void* a_val,
                           const void* b_rpt, const void* b_col,
                           const void* b_val, const void* rownnz_b, int m,
                           int k_rows, int max_deg_a, int max_deg_b,
                           int tile_n, int n_tiles, int row_capacity,
                           void* scratch, long long unit_bytes, int grid,
                           int threads, int smem_bytes, void* out_col,
                           void* out_val, void* row_nnz, void* overflow,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spa_numeric_kernel<GROUP, SCRATCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  spa_numeric_kernel<GROUP, SCRATCH><<<grid, threads, smem_bytes, stream>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, tile_n, n_tiles, row_capacity,
      static_cast<char*>(scratch), unit_bytes, static_cast<int*>(out_col),
      static_cast<float*>(out_val), static_cast<int*>(row_nnz),
      static_cast<int*>(overflow));
  return cudaGetLastError();
}

// group: lanes a row (SPA_MIN_GROUP to 32), or 0 for a block a row;
// scratch: each unit's workspace slice, or null for shared memory.
extern "C" int spa_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int tile_n, int n_tiles, int row_capacity,
    int group, void* scratch, long long unit_bytes, int grid, int threads,
    int smem_bytes, void* out_col, void* out_val, void* row_nnz,
    void* overflow, int device, void* stream) {
  if (threads % 32 || threads > 32 * SPA_WARPS || tile_n < 128 ||
      (tile_n & (tile_n - 1)) || (group == 0 && tile_n % (threads / 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the entries dropped for capacity, summed by the kernel
  err = cudaMemsetAsync(overflow, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
#define SPA_RUN(G, S)                                                        \
  spa_run<G, S>(rows, n_rows, a_rpt, a_col, a_val, b_rpt, b_col, b_val,      \
                rownnz_b, m, k_rows, max_deg_a, max_deg_b, tile_n, n_tiles,  \
                row_capacity, scratch, unit_bytes, grid, threads, smem_bytes, \
                out_col, out_val, row_nnz, overflow, s)
  const bool sc = scratch != nullptr;
  switch (group) {
    case 0: err = sc ? SPA_RUN(0, true) : SPA_RUN(0, false); break;
    case 8: err = sc ? SPA_RUN(8, true) : SPA_RUN(8, false); break;
    case 16: err = sc ? SPA_RUN(16, true) : SPA_RUN(16, false); break;
    case 32: err = sc ? SPA_RUN(32, true) : SPA_RUN(32, false); break;
    default: err = cudaErrorInvalidValue;
  }
#undef SPA_RUN
  return static_cast<int>(err);
}

REPRO_EXPORT_COMMON(spa_numeric)
