// Dst-grouped CR-SQLite cell merge for Hopper (sm_90a).
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
// Design. The TPU form builds dense one-hot (cap, cells) compare
// matrices because its vector unit has no scatter. Here one thread block
// owns one node: it stages the node's per-row cl and per-cell cv/vr/site
// in shared memory and the lanes scatter into them with shared-memory
// atomicMax, one pass at a time, with a barrier between passes. Max is
// associative and commutative, so the result does not depend on lane
// order and is deterministic. The kernel is out of place: it reads the
// input planes (the stored cv/vr/site of a wiped row are never read) and
// writes every output once.
//
// Bound: bytes. The kernel must read the (N, rows) cl plane, the stored
// cv/vr/site of the rows it does not wipe and the lane fields its passes
// test, and write the three (N, cells) planes and the cl plane; it does
// a handful of integer operations per byte, far below the card's
// compute rate. Shared memory: 3 * cells + 2 * rows int32 (12.5 KB at
// 1024 cells of 4 columns); grouped_merge_init opts in to the largest
// dynamic shared memory a block may have, and the wrapper refuses cell
// spaces past it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = (-2147483647 - 1);
constexpr int LANE_CELL = 0, LANE_CV = 1, LANE_VR = 2, LANE_SITE = 3,
              LANE_CL = 4, LANE_VALID = 5;

__global__ void grouped_merge_kernel(
    const int* __restrict__ lanes,  // (6, n*cap)
    const int* __restrict__ cv_in, const int* __restrict__ vr_in,
    const int* __restrict__ site_in,  // (n, cells) each
    const int* __restrict__ cl_in,    // (n, rows)
    int* __restrict__ cv_out, int* __restrict__ vr_out,
    int* __restrict__ site_out, int* __restrict__ cl_out,
    int cells, int cols, int cap, long long lane_stride) {
  extern __shared__ int smem[];
  const int rows = cells / cols;
  int* s_cv = smem;              // (cells)
  int* s_vr = s_cv + cells;      // (cells)
  int* s_site = s_vr + cells;    // (cells)
  int* s_cl0 = s_site + cells;   // (rows) stored cl
  int* s_cl = s_cl0 + rows;      // (rows) merged cl

  const long long node = blockIdx.x;
  const long long base = node * (long long)cells;
  const long long rbase = node * (long long)rows;
  const int* lane = lanes + node * (long long)cap;
  const int tid = threadIdx.x, nth = blockDim.x;

  auto field = [&](int f, int l) { return lane[f * lane_stride + l]; };
  auto lane_ok = [&](int l, int* cell) {
    if (field(LANE_VALID, l) == 0) return false;
    int c = field(LANE_CELL, l);
    *cell = c;
    return c >= 0 && c < cells;
  };
  // A lane at its row's merged generation that carries a value.
  auto current = [&](int l, int c) {
    return field(LANE_CL, l) == s_cl[c / cols] && field(LANE_VR, l) != NEG;
  };
  auto wiped = [&](int c) { return s_cl[c / cols] > s_cl0[c / cols]; };

  for (int r = tid; r < rows; r += nth) {
    int cl0 = cl_in[rbase + r];
    s_cl0[r] = cl0;
    s_cl[r] = cl0;
  }
  __syncthreads();

  // Pass 0: causal length per row.
  for (int l = tid; l < cap; l += nth) {
    int c;
    if (lane_ok(l, &c)) atomicMax(&s_cl[c / cols], field(LANE_CL, l));
  }
  __syncthreads();
  for (int c = tid; c < cells; c += nth)
    s_cv[c] = wiped(c) ? 0 : cv_in[base + c];
  __syncthreads();

  // Pass 1: col_version over value lanes at the current generation.
  for (int l = tid; l < cap; l += nth) {
    int c;
    if (lane_ok(l, &c) && current(l, c))
      atomicMax(&s_cv[c], field(LANE_CV, l));
  }
  __syncthreads();
  for (int c = tid; c < cells; c += nth) {
    bool w = wiped(c);
    int cv0 = w ? 0 : cv_in[base + c];
    int vr0 = w ? NEG : vr_in[base + c];
    s_vr[c] = s_cv[c] > cv0 ? NEG : vr0;
  }
  __syncthreads();

  // Pass 2: value rank among lanes tying the winning col_version.
  for (int l = tid; l < cap; l += nth) {
    int c;
    if (lane_ok(l, &c) && current(l, c) && field(LANE_CV, l) == s_cv[c])
      atomicMax(&s_vr[c], field(LANE_VR, l));
  }
  __syncthreads();
  for (int c = tid; c < cells; c += nth) {
    bool w = wiped(c);
    int cv0 = w ? 0 : cv_in[base + c];
    int vr0 = w ? NEG : vr_in[base + c];
    int site0 = w ? -1 : site_in[base + c];
    s_site[c] = (s_cv[c] != cv0 || s_vr[c] != vr0) ? NEG : site0;
  }
  __syncthreads();

  // Pass 3: site among lanes tying col_version and value rank.
  for (int l = tid; l < cap; l += nth) {
    int c;
    if (lane_ok(l, &c) && current(l, c) && field(LANE_CV, l) == s_cv[c] &&
        field(LANE_VR, l) == s_vr[c])
      atomicMax(&s_site[c], field(LANE_SITE, l));
  }
  __syncthreads();

  for (int c = tid; c < cells; c += nth) {
    cv_out[base + c] = s_cv[c];
    vr_out[base + c] = s_vr[c];
    site_out[base + c] = s_site[c];
  }
  for (int r = tid; r < rows; r += nth) cl_out[rbase + r] = s_cl[r];
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t grouped_merge_smem_bytes(int cells, int cols) {
  return sizeof(int) * (3 * (size_t)cells + 2 * (size_t)(cells / cols));
}

// Opt the kernel in to the largest dynamic shared memory a block may
// have on the current device. Returns that size in bytes, or a negated
// cudaError_t.
long long grouped_merge_init(void) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  return err == cudaSuccess ? (long long)optin : -(long long)err;
}

// Launch on `stream`. Returns a cudaError_t (0 = launched).
int grouped_merge_launch(const int* lanes, const int* cv_in,
                         const int* vr_in, const int* site_in,
                         const int* cl_in, int* cv_out, int* vr_out,
                         int* site_out, int* cl_out, int n, int cells,
                         int cols, int cap, void* stream) {
  if (n == 0) return 0;
  grouped_merge_kernel<<<n, 256, grouped_merge_smem_bytes(cells, cols),
                         (cudaStream_t)stream>>>(
      lanes, cv_in, vr_in, site_in, cl_in, cv_out, vr_out, site_out, cl_out,
      cells, cols, cap, (long long)n * cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
