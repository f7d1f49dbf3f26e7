// DRAM access-pattern probe for the merge kernel's table planes.
//
// A measurement aid, not a port of a TPU kernel: it touches three
// (n, cells) int32 planes in the patterns that merge_kernel.cu makes, so
// that corro_sim_torch/merge_probe.py can set the merge kernel's time
// beside the time of its memory traffic alone. Rows are 4 ints (16 bytes,
// the slice's 256 x 4 layout), so a 32-byte DRAM sector holds 2 rows and
// a 128-byte line 8. One warp per node; `rows` is (n, width) int32, the
// rows to touch, padded with -1.
//   mode 0: each listed row written (one 16-byte store per plane)
//   mode 1: each listed row read
//   mode 2: each listed row read, then written back
//   mode 3: each line holding a listed row read whole, then written back
//   mode 4: every line of the node read, then written back (a dense copy
//           in place)
// and, apart, lane_probe_kernel reads a (6, n*cap) mailbox as the merge
// kernel stages it: every valid word, the five other fields of the valid
// lanes.
// `bump` is added to what is written back; the caller passes 0, so the
// planes keep their values, and the compiler cannot drop the stores.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32) dram_probe_kernel(
    int* cv, int* vr, int* site, const int* __restrict__ rows, int n,
    int cells, int width, int mode, int bump, int* sink) {
  const int lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (node >= n) return;
  int* planes[3] = {cv, vr, site};
  const long long base = node * (long long)cells;
  const int* nr = rows + node * (long long)width;

  if (mode <= 2) {
    int acc = 0;
    for (int j = lane; j < width; j += 32) {
      const int row = nr[j];
      if (row < 0) continue;
      int4* at[3];
      for (int p = 0; p < 3; ++p)
        at[p] = reinterpret_cast<int4*>(planes[p] + base + row * 4);
      if (mode == 0) {
        for (int p = 0; p < 3; ++p) *at[p] = make_int4(bump, bump, bump, bump);
        continue;
      }
      int4 x[3];
      for (int p = 0; p < 3; ++p) x[p] = __ldcg(at[p]);
      if (mode == 1) {
        for (int p = 0; p < 3; ++p) acc ^= x[p].x ^ x[p].y ^ x[p].z ^ x[p].w;
        continue;
      }
      for (int p = 0; p < 3; ++p)
        *at[p] = make_int4(x[p].x + bump, x[p].y, x[p].z, x[p].w);
    }
    if (acc == 0x5eed5eed) sink[0] = acc;  // keeps mode 1's loads
    return;
  }

  // modes 3 and 4: whole 128-byte lines, one int per thread per plane
  const int lines = cells / 32;
  unsigned mask = 0;
  if (mode == 4) {
    mask = lines == 32 ? 0xffffffffu : (1u << lines) - 1u;
  } else {
    for (int j = lane; j < width; j += 32)
      if (nr[j] >= 0) mask |= 1u << (nr[j] >> 3);
    for (int o = 16; o; o >>= 1) mask |= __shfl_xor_sync(0xffffffffu, mask, o);
  }
  while (mask) {
    int ls[4], k = 0;
    for (; k < 4 && mask; ++k) {
      ls[k] = __ffs(mask) - 1;
      mask &= mask - 1;
    }
    int x[4][3];
    for (int i = 0; i < 4; ++i)
      if (i < k)
        for (int p = 0; p < 3; ++p)
          x[i][p] = __ldcg(planes[p] + base + ls[i] * 32 + lane);
    for (int i = 0; i < 4; ++i)
      if (i < k)
        for (int p = 0; p < 3; ++p)
          planes[p][base + ls[i] * 32 + lane] = x[i][p] + bump;
  }
}

constexpr int STAGE = 4;

__global__ void __launch_bounds__(WARPS * 32) lane_probe_kernel(
    const int* __restrict__ lanes, int n, int cap, int* sink) {
  const int lane = threadIdx.x & 31;
  const long long node = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (node >= n) return;
  const long long stride = (long long)n * cap;
  const int* nl = lanes + node * cap;
  int acc = 0;
  for (int g0 = 0; g0 < cap; g0 += 32 * STAGE) {
    int v[STAGE];
#pragma unroll
    for (int g = 0; g < STAGE; ++g) {
      const int l = g0 + g * 32 + lane;
      v[g] = l < cap ? __ldcs(nl + 5 * stride + l) : 0;
    }
#pragma unroll
    for (int g = 0; g < STAGE; ++g) {
      const int l = g0 + g * 32 + lane;
#pragma unroll
      for (int q = 0; q < 5; ++q)
        acc ^= v[g] ? __ldcs(nl + q * stride + l) : 0;
    }
  }
  if (acc == 0x5eed5eed) sink[0] = acc;
}

}  // namespace

extern "C" int dram_probe_launch(int* cv, int* vr, int* site,
                                 const int* rows, int n, int cells,
                                 int width, int mode, int bump, int* sink,
                                 void* stream) {
  if (n == 0) return 0;
  dram_probe_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(cv, vr, site, rows, n, cells,
                                              width, mode, bump, sink);
  return (int)cudaGetLastError();
}

extern "C" int lane_probe_launch(const int* lanes, int n, int cap, int* sink,
                                 void* stream) {
  if (n == 0) return 0;
  lane_probe_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(lanes, n, cap, sink);
  return (int)cudaGetLastError();
}
