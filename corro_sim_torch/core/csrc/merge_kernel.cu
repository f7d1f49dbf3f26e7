// Dst-grouped CR-SQLite cell merge for Hopper (sm_90a), in place.
//
// Replaces the Pallas TPU kernel corro_sim/core/merge_kernel.py::_kernel
// (launched by grouped_merge). Same function: for every node, merge the
// node's mailbox lanes into its table planes in four passes —
//   pass 0: row causal length = max over the row's valid lanes; where it
//           grew, wipe the row's cv/vr/site (generation change);
//   pass 1: cv = max over value lanes (vr != NEG) at the row's new cl;
//   pass 2: vr = max among those lanes tying the winning cv (the stored
//           vr competes only if the stored cv survived);
//   pass 3: site = max among lanes tying cv and vr (the stored site
//           competes only if cv and vr both survived).
// Bit-equal to corro_sim_torch/core/crdt.py::apply_cell_changes.
//
// Design. Like the TPU kernel (input_output_aliases) it updates the
// (N, cells) cv/vr/site planes and the (N, rows) cl plane where they lie,
// and touches only what the lanes hit: a node no valid lane hits costs
// its mailbox's valid words, a row no lane hits nothing.
//   - One warp per node, up to 4 nodes per block, __syncwarp between
//     phases; no block-wide barrier.
//   - The node's lanes are read once, coalesced, the fields of a lane
//     only when its valid word is set, and compacted (ballot + popc) into
//     shared memory; later passes never go back to global memory.
//   - A mailbox larger than a warp's share of shared memory (the sync
//     sweep's 8192 lanes per node at 512 actors x 16 versions) is walked
//     in tiles of lanes, in lane order, each tile merged into the planes
//     before the next is staged. The merge is a join — per row the cl
//     max, per cell the lexicographic (cv, vr, site) max among the lanes
//     at the row's merged cl, with the wipe when cl grows — so merging
//     tile by tile equals merging every lane at once. Where one tile
//     holds the whole mailbox (every smaller cap), the loop runs once
//     and the kernel is the single-pass merge.
//   - What the node hits is numbered in memory order: a shared bitmap of
//     the rows hit and one of the cells hit by a value lane at its row's
//     merged generation, each with per-word prefix counts. A row's or a
//     cell's slot is its rank among those hit (a prefix count plus a
//     popc), so a lookup is O(1) and the slots of the rows and cells hit,
//     taken 32 at a time, are 32 ascending addresses. That order is what
//     makes scattered row traffic cheap on HBM: on an H100, with a third
//     of each node's rows hit, reading and writing back the hit rows in
//     ascending order takes about the time of a dense copy of the
//     planes, in shuffled order about 60 % longer
//     (corro_sim_torch/merge_probe.py; numbers in PERF.md). Shared
//     memory: 7 words per lane of a tile, 3 per row slot and 8 per cell
//     slot (at most one slot per lane, row or cell), plus two bitmaps
//     with their prefix counts (cells/16 + rows/16 words, at most 2 KB
//     each at the gate's 8192 cells).
//   - The passes are shared-memory atomicMax into the cell slots. Max is
//     order-free, so a hot row hit by every lane gives the same result in
//     any lane order.
//   - Each hit row's cv/vr/site sectors are prefetched into L2 beside its
//     cl load, so the later partial-sector writes merge in L2 instead of
//     costing a read-modify-write at eviction. The stored cv/vr/site of a
//     cell are read only if its row is kept; a row whose cl grows is
//     written whole as (0, NEG, -1), then its hit cells' winners are
//     written over it (the warp's __syncwarp orders the two writes). For
//     cols in {1, 2, 4, 8} the row is a template constant, so a row index
//     is a shift and a wiped row is one 4- to 32-byte vector store per
//     plane (one 16-byte store at cols = 4); other cols take a general
//     path with the division at run time.
//   - The lane loads are issued four groups of 32 at a time; the lanes
//     are small beside the table traffic, so no TMA pipeline is used.
//   - Tensor cores have no role in an integer max-merge.
//
// Bound: bytes. The least the function moves is the lanes' valid words
// and tested fields, the cl of each hit row, the stored cv/vr/site of the
// hit cells of kept rows, and the writes of grown cl, wiped rows and
// changed cells (corro_sim_torch/core/merge_kernel.py::merge_work). The
// card moves more: DRAM works in 32-byte sectors, so an isolated 16-byte
// row or 4-byte cl costs a whole sector, and scattered sectors do not
// stream at the peak rate (merge_sector_bytes; merge_probe.py).
// Operations: a handful of integer ops per lane, far below the card's
// rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = (-2147483647 - 1);
constexpr unsigned FULL = 0xffffffffu;
constexpr int LANE_CELL = 0, LANE_CV = 1, LANE_VR = 2, LANE_SITE = 3,
              LANE_CL = 4, LANE_VALID = 5;
constexpr int MAX_WARPS = 4;  // fastest of 1, 2, 4 and 8 on an H100
constexpr int STAGE = 4;  // groups of 32 lanes whose loads are in flight

int host_optin = 0;  // dynamic shared memory opted in (grouped_merge_init)

__host__ __device__ inline int bitmap_words(int bits) {
  return (bits + 31) >> 5;
}

// Row and cell slots a tile of `tile` lanes can fill.
__host__ __device__ inline int row_slots(int tile, int cells, int cols) {
  return tile < cells / cols ? tile : cells / cols;
}
__host__ __device__ inline int cell_slots(int tile, int cells) {
  return tile < cells ? tile : cells;
}

// int32 words of shared memory one node's warp uses for a tile of `tile`
// lanes: seven per lane (cell, cv, vr, site, cl, row slot, cell slot),
// three per row slot (row, stored cl, merged cl), eight per cell slot
// (cell, row slot, merged and stored cv/vr/site), and a bitmap plus
// prefix counts for the rows and for the cells.
__host__ __device__ inline int warp_smem_words(int tile, int cells,
                                               int cols) {
  const int rows = cells / cols;
  return 7 * tile + 3 * row_slots(tile, cells, cols) +
         8 * cell_slots(tile, cells) +
         2 * (bitmap_words(rows) + bitmap_words(cells));
}

// Exclusive prefix of the set bits over bitmap words [0, words) into
// pre[]; returns the total. Lane t takes a contiguous run of words.
__device__ inline int bitmap_prefix(const unsigned* bits, int* pre,
                                    int words, int lane) {
  const int per = (words + 31) >> 5;
  const int w0 = min(lane * per, words);
  const int w1 = min(w0 + per, words);
  int own = 0;
  for (int w = w0; w < w1; ++w) own += __popc(bits[w]);
  int incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  int run = incl - own;
  for (int w = w0; w < w1; ++w) {
    pre[w] = run;
    run += __popc(bits[w]);
  }
  return __shfl_sync(FULL, incl, 31);
}

// Rank of set bit x among the set bits: its slot.
__device__ inline int bitmap_rank(const unsigned* bits, const int* pre,
                                  int x) {
  return pre[x >> 5] + __popc(bits[x >> 5] & ((1u << (x & 31)) - 1u));
}

// keys[rank] = the bit's index, for every set bit: slots in ascending
// order of what they name.
__device__ inline void bitmap_keys(const unsigned* bits, const int* pre,
                                   int words, int* keys, int lane) {
  for (int w = lane; w < words; w += 32) {
    unsigned b = bits[w];
    int r = pre[w];
    while (b) {
      keys[r++] = (w << 5) + __ffs(b) - 1;
      b &= b - 1;
    }
  }
}

__device__ inline void prefetch_l2(const int* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Bring the 32-byte sectors of one row of a plane into L2 ahead of the
// row's writes: a partial-sector write to a sector L2 does not hold is
// merged with a read from DRAM when it is evicted, later and slower than
// this read issued beside the row's cl load.
template <int COLS>
__device__ inline void prefetch_row(const int* p, int cols) {
  if constexpr (COLS > 0) {
    prefetch_l2(p);  // a row of 1, 2, 4 or 8 ints lies in one sector
  } else {
    for (int c = 0; c < cols; c += 8) prefetch_l2(p + c);
    prefetch_l2(p + cols - 1);
  }
}

template <int COLS>
__device__ inline void fill_row(int* p, int v) {
  if constexpr (COLS == 1) {
    p[0] = v;
  } else if constexpr (COLS == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v, v);
  } else if constexpr (COLS == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v, v, v, v);
  } else {
    static_assert(COLS == 8, "fill_row: cols 1, 2, 4 or 8");
    reinterpret_cast<int4*>(p)[0] = make_int4(v, v, v, v);
    reinterpret_cast<int4*>(p)[1] = make_int4(v, v, v, v);
  }
}

// COLS > 0: cols is that constant; COLS == 0: cols is read at run time.
template <int COLS>
__global__ void __launch_bounds__(MAX_WARPS * 32) grouped_merge_kernel(
    const int* __restrict__ lanes,  // (6, n*cap)
    int* __restrict__ cv, int* __restrict__ vr,
    int* __restrict__ site,  // (n, cells) each, updated in place
    int* __restrict__ cl,    // (n, rows), updated in place
    int n, int cells, int cols_rt, int cap, int tile) {
  extern __shared__ int smem[];
  const int cols = COLS > 0 ? COLS : cols_rt;
  const int rows = cells / cols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long node = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (node >= n) return;  // whole warps only; no block barrier follows

  const int row_words = bitmap_words(rows);
  const int cell_words = bitmap_words(cells);
  const int rsl = row_slots(tile, cells, cols);
  const int csl = cell_slots(tile, cells);
  int* w = smem + warp * warp_smem_words(tile, cells, cols);
  int* l_cell = w;
  int* l_cv = l_cell + tile;
  int* l_vr = l_cv + tile;
  int* l_site = l_vr + tile;
  int* l_cl = l_site + tile;
  int* l_rs = l_cl + tile;
  int* l_cs = l_rs + tile;
  int* r_key = l_cs + tile;
  int* r_cl0 = r_key + rsl;
  int* r_cl1 = r_cl0 + rsl;
  int* c_key = r_cl1 + rsl;
  int* c_rs = c_key + csl;
  int* c_cv = c_rs + csl;
  int* c_vr = c_cv + csl;
  int* c_site = c_vr + csl;
  int* c_cv0 = c_site + csl;
  int* c_vr0 = c_cv0 + csl;
  int* c_site0 = c_vr0 + csl;
  unsigned* r_bits = reinterpret_cast<unsigned*>(c_site0 + csl);
  int* r_pre = reinterpret_cast<int*>(r_bits + row_words);
  unsigned* c_bits = reinterpret_cast<unsigned*>(r_pre + row_words);
  int* c_pre = reinterpret_cast<int*>(c_bits + cell_words);

  const long long stride = (long long)n * cap;
  const int* nl = lanes + node * cap;
  const long long base = node * (long long)cells;
  const long long rbase = node * (long long)rows;
  auto row_of = [&](int c) {
    if constexpr (COLS > 0) return c / COLS;
    else return c / cols;
  };

  // The mailbox's lanes in tiles of `tile`, in lane order; each tile is
  // merged into the planes before the next is staged (the __syncwarp at
  // the loop's end orders its writes before the next tile's reads).
  for (int t0 = 0; t0 < cap; t0 += tile) {
    const int tlen = min(tile, cap - t0);
    const int* tl = nl + t0;

    // Stage the valid, in-range lanes, compacted, into shared memory. A
    // lane's fields are loaded only when its valid word is set.
    int count = 0;
    for (int g0 = 0; g0 < tlen; g0 += 32 * STAGE) {
      int v[STAGE], f[STAGE][5];
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int l = g0 + g * 32 + lane;
        v[g] = l < tlen ? __ldcs(tl + LANE_VALID * stride + l) : 0;
      }
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int l = g0 + g * 32 + lane;
#pragma unroll
        for (int q = 0; q < 5; ++q)
          f[g][q] = v[g] ? __ldcs(tl + q * stride + l) : -1;
      }
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int c = f[g][LANE_CELL];
        const bool ok = v[g] != 0 && c >= 0 && c < cells;
        const unsigned m = __ballot_sync(FULL, ok);
        if (ok) {
          const int j = count + __popc(m & ((1u << lane) - 1u));
          l_cell[j] = c;
          l_cv[j] = f[g][LANE_CV];
          l_vr[j] = f[g][LANE_VR];
          l_site[j] = f[g][LANE_SITE];
          l_cl[j] = f[g][LANE_CL];
        }
        count += __popc(m);
      }
    }
    if (count == 0) continue;  // warp-uniform: nothing in this tile hits

    for (int k = lane; k < row_words; k += 32) r_bits[k] = 0;
    for (int k = lane; k < cell_words; k += 32) c_bits[k] = 0;
    __syncwarp();

    // Pass 0: the rows hit, numbered in row order; causal length per row.
    for (int j = lane; j < count; j += 32) {
      const int row = row_of(l_cell[j]);
      atomicOr(&r_bits[row >> 5], 1u << (row & 31));
    }
    __syncwarp();
    const int nrows = bitmap_prefix(r_bits, r_pre, row_words, lane);
    __syncwarp();
    bitmap_keys(r_bits, r_pre, row_words, r_key, lane);
    for (int j = lane; j < count; j += 32)
      l_rs[j] = bitmap_rank(r_bits, r_pre, row_of(l_cell[j]));
    __syncwarp();
    for (int k0 = 0; k0 < nrows; k0 += 32 * STAGE) {
      int c0[STAGE];
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int k = k0 + g * 32 + lane;
        c0[g] = NEG;
        if (k < nrows) {
          const int row = r_key[k];
          c0[g] = cl[rbase + row];
          const long long at = base + (long long)row * cols;
          prefetch_row<COLS>(cv + at, cols);
          prefetch_row<COLS>(vr + at, cols);
          prefetch_row<COLS>(site + at, cols);
        }
      }
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int k = k0 + g * 32 + lane;
        if (k < nrows) r_cl0[k] = r_cl1[k] = c0[g];
      }
    }
    __syncwarp();
    for (int j = lane; j < count; j += 32) atomicMax(&r_cl1[l_rs[j]], l_cl[j]);
    __syncwarp();

    // Rows whose cl grew: the new cl, and the whole row wiped now, so that
    // the writes overlap the passes below; the hit cells' winners are
    // written over the wipe at the end (the __syncwarps between order the
    // two writes).
    if constexpr (COLS > 0) {
      for (int k = lane; k < nrows; k += 32) {
        if (r_cl1[k] > r_cl0[k]) {
          const int row = r_key[k];
          cl[rbase + row] = r_cl1[k];
          const long long at = base + (long long)row * COLS;
          fill_row<COLS>(cv + at, 0);
          fill_row<COLS>(vr + at, NEG);
          fill_row<COLS>(site + at, -1);
        }
      }
    } else {
      for (int k0 = 0; k0 < nrows; k0 += 32) {
        const int k = k0 + lane;
        const bool grew = k < nrows && r_cl1[k] > r_cl0[k];
        if (grew) cl[rbase + r_key[k]] = r_cl1[k];
        unsigned m = __ballot_sync(FULL, grew);
        while (m) {
          const int i = __ffs(m) - 1;
          m &= m - 1;
          const long long at = base + (long long)r_key[k0 + i] * cols;
          for (int c = lane; c < cols; c += 32) {
            cv[at + c] = 0;
            vr[at + c] = NEG;
            site[at + c] = -1;
          }
        }
      }
    }

    // The cells hit by a value lane at its row's merged generation,
    // numbered in cell order.
    for (int j = lane; j < count; j += 32) {
      if (l_cl[j] == r_cl1[l_rs[j]] && l_vr[j] != NEG)
        atomicOr(&c_bits[l_cell[j] >> 5], 1u << (l_cell[j] & 31));
    }
    __syncwarp();
    const int ncells = bitmap_prefix(c_bits, c_pre, cell_words, lane);
    __syncwarp();
    bitmap_keys(c_bits, c_pre, cell_words, c_key, lane);
    for (int j = lane; j < count; j += 32)
      l_cs[j] = l_cl[j] == r_cl1[l_rs[j]] && l_vr[j] != NEG
                    ? bitmap_rank(c_bits, c_pre, l_cell[j])
                    : -1;
    __syncwarp();

    // Pass 1: col_version. A kept row's stored cell is the base; a wiped
    // row's base is (0, NEG, -1) and its stored cells are never read.
    for (int k0 = 0; k0 < ncells; k0 += 32 * STAGE) {
      int b[STAGE][3];
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int k = k0 + g * 32 + lane;
        b[g][0] = 0;
        b[g][1] = NEG;
        b[g][2] = -1;
        if (k < ncells) {
          const int key = c_key[k];
          const int rs = bitmap_rank(r_bits, r_pre, row_of(key));
          c_rs[k] = rs;
          if (r_cl1[rs] == r_cl0[rs]) {
            b[g][0] = cv[base + key];
            b[g][1] = vr[base + key];
            b[g][2] = site[base + key];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < STAGE; ++g) {
        const int k = k0 + g * 32 + lane;
        if (k < ncells) {
          c_cv0[k] = b[g][0];
          c_vr0[k] = b[g][1];
          c_site0[k] = b[g][2];
          c_cv[k] = b[g][0];
          c_vr[k] = NEG;
          c_site[k] = NEG;
        }
      }
    }
    __syncwarp();
    for (int j = lane; j < count; j += 32)
      if (l_cs[j] >= 0) atomicMax(&c_cv[l_cs[j]], l_cv[j]);
    __syncwarp();

    // Pass 2: value rank among lanes tying the winning col_version.
    for (int k = lane; k < ncells; k += 32)
      if (c_cv[k] == c_cv0[k]) atomicMax(&c_vr[k], c_vr0[k]);
    for (int j = lane; j < count; j += 32) {
      const int cs = l_cs[j];
      if (cs >= 0 && l_cv[j] == c_cv[cs]) atomicMax(&c_vr[cs], l_vr[j]);
    }
    __syncwarp();

    // Pass 3: site among lanes tying col_version and value rank.
    for (int k = lane; k < ncells; k += 32)
      if (c_cv[k] == c_cv0[k] && c_vr[k] == c_vr0[k])
        atomicMax(&c_site[k], c_site0[k]);
    for (int j = lane; j < count; j += 32) {
      const int cs = l_cs[j];
      if (cs >= 0 && l_cv[j] == c_cv[cs] && l_vr[j] == c_vr[cs])
        atomicMax(&c_site[cs], l_site[j]);
    }
    __syncwarp();

    // Write back the hit cells: every one in a wiped row, and the changed
    // ones of a kept row.
    for (int k = lane; k < ncells; k += 32) {
      const int rs = c_rs[k];
      if (r_cl1[rs] > r_cl0[rs] || c_cv[k] != c_cv0[k] ||
          c_vr[k] != c_vr0[k] || c_site[k] != c_site0[k]) {
        const int key = c_key[k];
        cv[base + key] = c_cv[k];
        vr[base + key] = c_vr[k];
        site[base + key] = c_site[k];
      }
    }
    __syncwarp();
  }  // tiles
}

template <int COLS>
cudaError_t launch(const int* lanes, int* cv, int* vr, int* site, int* cl,
                   int n, int cells, int cols, int cap, int tile, int warps,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * (size_t)warps * warp_smem_words(tile, cells, cols);
  const int blocks = (n + warps - 1) / warps;
  grouped_merge_kernel<COLS><<<blocks, warps * 32, smem, stream>>>(
      lanes, cv, vr, site, cl, n, cells, cols, cap, tile);
  return cudaGetLastError();
}

// Lanes per tile: the whole mailbox where one warp's share of it fits
// half the opted-in shared memory (two blocks per SM; every cap up to the
// delivery and config-3 sweep mailboxes), else the largest multiple of
// 128 lanes for which MAX_WARPS warps fit that half; 0 when not even 128
// lanes fit.
int pick_tile(int cap, int cells, int cols, int optin) {
  const size_t half = (size_t)optin / 2;
  if (sizeof(int) * (size_t)warp_smem_words(cap, cells, cols) <= half)
    return cap;
  int tile = 0;
  for (int t = 128; t < cap; t += 128) {
    if (sizeof(int) * MAX_WARPS * (size_t)warp_smem_words(t, cells, cols) >
        half)
      break;
    tile = t;
  }
  return tile;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one node (one warp) needs for a tile
// of `tile` lanes.
size_t grouped_merge_smem_bytes(int tile, int cells, int cols) {
  return sizeof(int) * (size_t)warp_smem_words(tile, cells, cols);
}

// Lanes per tile the launch takes for this mailbox (after
// grouped_merge_init; 0 before it, or when not even 128 lanes fit).
int grouped_merge_tile(int cap, int cells, int cols) {
  return host_optin > 0 ? pick_tile(cap, cells, cols, host_optin) : 0;
}

// Opt every instance of the kernel in to the largest dynamic shared
// memory a block may have on the current device. Returns that size in
// bytes, or a negated cudaError_t.
long long grouped_merge_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* fns[] = {
      (const void*)grouped_merge_kernel<0>,
      (const void*)grouped_merge_kernel<1>,
      (const void*)grouped_merge_kernel<2>,
      (const void*)grouped_merge_kernel<4>,
      (const void*)grouped_merge_kernel<8>,
  };
  for (const void* fn : fns)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return -(long long)err;
  host_optin = optin;
  return (long long)optin;
}

// Launch on `stream`; the planes are updated in place. Lanes per tile:
// pick_tile. Warps (nodes) per block: as many as fit half the opted-in
// shared memory, so that two blocks share an SM, at most MAX_WARPS.
// Returns a cudaError_t (0 = launched).
int grouped_merge_launch(const int* lanes, int* cv, int* vr, int* site,
                         int* cl, int n, int cells, int cols, int cap,
                         void* stream) {
  if (n == 0 || cap == 0) return 0;
  const int tile = grouped_merge_tile(cap, cells, cols);
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  const size_t per_warp = grouped_merge_smem_bytes(tile, cells, cols);
  int warps = (int)((size_t)host_optin / 2 / per_warp);
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  auto* go = cols == 1   ? launch<1>
             : cols == 2 ? launch<2>
             : cols == 4 ? launch<4>
             : cols == 8 ? launch<8>
                         : launch<0>;
  return (int)go(lanes, cv, vr, site, cl, n, cells, cols, cap, tile, warps,
                 (cudaStream_t)stream);
}

}  // extern "C"
