// The sync sweep's serve step for Hopper (sm_90a): every served lane of
// the sweep computed in registers and written once, straight into the
// node-major mailbox the merge kernel reads.
//
// Replaces no TPU kernel. The JAX package builds the sweep's lanes as XLA
// array programs (corro_sim/sync/sync.py::sync_round), and the port's
// plain version does the same in PyTorch
// (corro_sim_torch/sync/serve.py::served_lanes): about twenty full-size
// temporaries over the (N, K', cap, S) lanes, and an atomic scatter-max
// over all of them that sends every masked lane to one word. At the
// catch-up shape (16 384 nodes x 512 actors x 16 versions) that is 134 M
// lanes a sweep. This kernel computes the same values:
//
//   lane (node i, request k, version offset o, seq q), node-major in
//   (k, o, q) order, lanes_per_node = K' * cap * S, padded to box_cap;
//   v = base + o + 1, slot = (v - 1) mod L, valid = o < take;
//   cleared = log.cleared[actor, slot], live = valid & !cleared
//             & q < ncells[actor, slot];
//   mailbox rows: cell = row * num_cols + col, cv, vr,
//                 site = vr == NEG ? NEG : actor, cl, live;
//   a lane that is not live gets its live word (0) and nothing else: the
//   merge kernel reads a lane's other fields only where its live word is
//   set (merge_kernel.cu, the staging loop);
//   per node: the max of cleared_hlc[actor, slot] over its valid, cleared
//             (i, k, o) lanes (INT_MIN where none);
//   counts[0] += valid & cleared lanes (one per version, at q = 0),
//   counts[1] += live lanes whose chunk the node had not buffered
//                (bit o * bpv + q * bpv / S of win for o < vwin).
//
// Bound: bytes. The mailbox's live row is written once, 4 B a lane, and
// its other five rows for live lanes only, 20 B each; each request's
// schedule words are read once, and each served version's log record
// (the cleared byte, then ncells and S cells of 20 B where not cleared,
// or the stamp where cleared). No lane-sized temporary, no atomic per
// lane.
//
// Design.
//   - Consecutive threads take consecutive lanes of a node, so the live
//     row is written as coalesced 128-byte lines (and the other rows
//     where lanes are live), and the lanes of one (node, k) read
//     consecutive log slots of one actor.
//   - Geometry from the shape: a node's lanes are walked by 256 threads
//     (one block; at 8 192 lanes a node each thread takes 32 lanes), or,
//     where a node has only 128 lanes (K' 128, cap 1), by 128 threads, two
//     nodes to a block.
//   - The per-node stamp is a warp reduction (__reduce_max_sync), then a
//     shared-memory fold and one store per node. The two counts are a
//     block reduction and one atomicAdd per block into a two-word buffer.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = INT_MIN;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Nodes per block: two where a node has 128 lanes, else one.
inline int nodes_per_block(int box_cap) { return box_cap <= 128 ? 2 : 1; }

__global__ void __launch_bounds__(THREADS) serve_lanes_kernel(
    const int* __restrict__ topa,       // (nl, kp)
    const int* __restrict__ take,       // (nl, kp)
    const int* __restrict__ base,       // (nl, kp)
    const long long* __restrict__ win,  // (nl, kp)
    const int* __restrict__ cells,      // (A, L, S, 5)
    const int* __restrict__ ncells,     // (A, L)
    const unsigned char* __restrict__ cleared,  // (A, L)
    const int* __restrict__ cleared_hlc,        // (A, L)
    int* __restrict__ box,        // (6, nl * box_cap)
    int* __restrict__ row_stamp,  // (nl,)
    int* __restrict__ counts,     // (2,)
    int nl, int kp, int cap, int s, int log_cap, int bpv, int vwin,
    int num_cols, int box_cap, int per_block) {
  __shared__ int s_max[WARPS];
  __shared__ int s_emp[WARPS];
  __shared__ int s_ship[WARPS];
  const int tpn = THREADS / per_block;  // threads per node, a multiple of 32
  const int sub = threadIdx.x / tpn;
  const int lt = threadIdx.x - sub * tpn;
  const long long i = (long long)blockIdx.x * per_block + sub;
  const int lanes = kp * cap * s;
  const long long plane = (long long)nl * box_cap;

  int stamp = NEG, emptied = 0, shipped = 0;
  if (i < nl) {
    int* out = box + i * box_cap;
    const long long rk = i * kp;
    for (int j = lt; j < box_cap; j += tpn) {
      int f_live = 0;
      if (j < lanes) {
        const int q = j % s;
        const int ko = j / s;
        const int o = ko % cap;
        const long long idx = rk + ko / cap;
        if (o < take[idx]) {
          const int a = topa[idx];
          const int v = base[idx] + o + 1;
          const int slot = ((v < 1 ? 1 : v) - 1) % log_cap;
          const long long at = (long long)a * log_cap + slot;
          const bool cl_flag = cleared[at] != 0;
          if (cl_flag && q == 0) {
            ++emptied;
            stamp = max(stamp, cleared_hlc[at]);
          }
          if (!cl_flag && q < ncells[at]) {
            const int* c = cells + (at * s + q) * 5;
            const int row = c[0], col = c[1], vr = c[2], cv = c[3];
            out[j] = row * num_cols + col;
            out[plane + j] = cv;
            out[2 * plane + j] = vr;
            out[3 * plane + j] = vr == NEG ? NEG : a;
            out[4 * plane + j] = c[4];
            f_live = 1;
            const bool buffered =
                o < vwin &&
                ((win[idx] >> (o * bpv + q * bpv / s)) & 1LL) != 0;
            shipped += buffered ? 0 : 1;
          }
        }
      }
      out[5 * plane + j] = f_live;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wmax = __reduce_max_sync(FULL, stamp);
  const int wemp = __reduce_add_sync(FULL, emptied);
  const int wship = __reduce_add_sync(FULL, shipped);
  if (lane == 0) {
    s_max[warp] = wmax;
    s_emp[warp] = wemp;
    s_ship[warp] = wship;
  }
  __syncthreads();
  if (lt == 0 && i < nl) {
    const int w0 = sub * (tpn / 32);
    int m = NEG;
    for (int w = w0; w < w0 + tpn / 32; ++w) m = max(m, s_max[w]);
    row_stamp[i] = m;
  }
  if (threadIdx.x == 0) {
    int e = 0, sh = 0;
    for (int w = 0; w < WARPS; ++w) {
      e += s_emp[w];
      sh += s_ship[w];
    }
    if (e) atomicAdd(&counts[0], e);
    if (sh) atomicAdd(&counts[1], sh);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. `box`'s live row and `row_stamp` are written whole,
// `box`'s other rows on live lanes only; `counts`
// (two int32 words) is added to, so the caller zeroes it. `box_cap` is a
// multiple of 128 and at least kp * cap * s. Returns a cudaError_t
// (0 = launched).
int serve_lanes_launch(const int* topa, const int* take, const int* base,
                       const long long* win, const int* cells,
                       const int* ncells, const unsigned char* cleared,
                       const int* cleared_hlc, int* box, int* row_stamp,
                       int* counts, int nl, int kp, int cap, int s,
                       int log_cap, int bpv, int vwin, int num_cols,
                       int box_cap, void* stream) {
  if (nl == 0) return 0;
  if (box_cap % 128 != 0 || (long long)kp * cap * s > box_cap || s < 1 ||
      cap < 1 || log_cap < 1)
    return (int)cudaErrorInvalidValue;
  const int per_block = nodes_per_block(box_cap);
  const int blocks = (nl + per_block - 1) / per_block;
  serve_lanes_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      topa, take, base, win, cells, ncells, cleared, cleared_hlc, box,
      row_stamp, counts, nl, kp, cap, s, log_cap, bpv, vwin, num_cols,
      box_cap, per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
