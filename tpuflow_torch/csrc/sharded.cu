// Hopper (sm_90a) kernel for the row-sharded relaxation of one pyramid level,
// every shard on one card.
//
// It replaces relax_sharded_kernel (tpuflow/parallel/halo_kernel.py:100,
// pl.pallas_call :384): a per-shard outer x (phi/ksi + inner sweeps)
// relaxation whose halo exchange runs inside the kernel. The TPU ran one
// kernel per chip and moved the halos by ring RDMA between chips, with a
// semaphore barrier between ring neighbours. Here all shards live in one
// card's memory and run in ONE cooperative launch:
//   * the exchange is plain stores of a shard's edge rows into its
//     neighbour shards' halo rows;
//   * the barrier is a grid-wide sync (cooperative_groups::this_grid()).
//     cudaLaunchCooperativeKernel starts the grid only if every block is
//     co-resident, and refuses it otherwise (an error the Python wrapper
//     raises), so the sync cannot hang.
//
// Layout. A shard owns a contiguous range of rows and keeps one buffer of
// planes over its padded rows: `top` halo rows above (halo, or 0 at the image
// top), its `rows` owned rows, `bot` halo rows below. Because a shard is
// padded only where it has a neighbour, a block that touches the image edge
// ends there, and the reflect rule at the block's edge is the image's rule,
// as in the unsharded kernels (level.cu). Planes of a shard's buffer, each
// (top + rows + bot, w):
//   0-1 T (ping), 2-3 T (pong), 4-5 uv, 6-8 fxyz, 9-17 hoist, 18-22 J (TENSOR)
//
// Phases (the syncs are grid-wide):
//   copy in   each shard copies its owned rows of uv, fxyz, J from the
//             level's fields, and T = uv
//   outer i   sync; every k outers: push the halos (at i = 0 also those of
//             uv, fxyz and J, once), sync; the prologue over all padded rows;
//             inner sweeps over all padded rows, ping-ponging T, a sync
//             between two sweeps
//   copy out  sync; each shard writes its owned rows of T
// A sweep reads the hoists only at its own pixel, which the same thread wrote
// in the prologue (both phases stride over the same pixel indices), so no
// sync separates the prologue from the first sweep. One outer consumes inner
// + 1 rows of the margin (1 for phi's gradient, 1 for phi's neighbour mean, 1
// per further sweep; halo.py:110-114), so with halo = k (inner + 1) rows the
// owned rows after k outers read only true values: they are bitwise those of
// the unsharded kernels for any shard count and k, since the per-pixel
// bodies are the same functions (level_body.cuh) under the same flags. The
// free-boundary weights take the pixel's global row. The port's levels are
// exact-size, so the TPU kernel's ghost upkeep (maintain1, top_fill) has no
// counterpart, and the ring is open at the image edges: the wrapped messages
// of the TPU's closed ring are not sent.
//
// Bytes streamed: per outer the prologue and the inner sweeps stream the
// padded rows as the unsharded kernels do (16 or 21 planes, and 17 per
// sweep), plus the exchanges (2 planes x halo rows x w per side), so at one
// shard the bytes equal those of the unsharded relax (40 + 200 launches per
// level) in one launch. The design removes the launches, not bytes; the
// function itself needs its float32 arithmetic and its planes once
// (tools/roofline.py: kernel_work), so on-chip blocking of the sweeps is
// the way toward its bound, and later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "level_body.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SHARDS = 8;  // the JAX tests' device count
constexpr int THREADS = 256;
constexpr int P_TA = 0, P_TB = 2, P_UV = 4, P_FXYZ = 6, P_HOIST = 9, P_J = 18;

struct Shard {
  float* buf;  // the shard's planes over its padded rows
  int row0;    // global row of the first owned row
  int rows;    // owned rows
  int top;     // halo rows above (0 at the image top)
  int bot;     // halo rows below (0 at the image bottom)
};

struct ShardSet {
  Shard s[MAX_SHARDS];
  int n;                 // shards
  int blocks_per_shard;  // the grid is n x blocks_per_shard blocks
};

// Store `planes` planes from plane `plane0` of shard si's edge rows into the
// neighbours' halo rows: its top `halo` owned rows into the previous shard's
// bottom halo, its bottom `halo` owned rows into the next shard's top halo.
__device__ void push_halos(const ShardSet& set, int si, int plane0, int planes, int halo,
                           int w, int tid, int stride) {
  const Shard me = set.s[si];
  const size_t n = (size_t)(me.top + me.rows + me.bot) * w;
  const int count = halo * w;
  if (si > 0) {
    const Shard up = set.s[si - 1];
    const size_t un = (size_t)(up.top + up.rows + up.bot) * w;
    const float* src = me.buf + plane0 * n + (size_t)me.top * w;
    float* dst = up.buf + plane0 * un + (size_t)(up.top + up.rows) * w;
    for (int i = tid; i < count * planes; i += stride) {
      const int p = i / count, j = i - p * count;
      dst[p * un + j] = src[p * n + j];
    }
  }
  if (si < set.n - 1) {
    const Shard down = set.s[si + 1];
    const size_t dn = (size_t)(down.top + down.rows + down.bot) * w;
    const float* src = me.buf + plane0 * n + (size_t)(me.top + me.rows - halo) * w;
    float* dst = down.buf + plane0 * dn;
    for (int i = tid; i < count * planes; i += stride) {
      const int p = i / count, j = i - p * count;
      dst[p * dn + j] = src[p * n + j];
    }
  }
}

template <bool TENSOR>
__global__ void __launch_bounds__(THREADS)
    relax_sharded_kernel(ShardSet set, const float* __restrict__ uv_in,
                         const float* __restrict__ fxyz_in, const float* __restrict__ J_in,
                         float* __restrict__ T_out, int h, int w, int halo, int outer,
                         int inner, int k, float div2hx, float div2hy, float alpha_hx2,
                         float alpha_hy2, float e_s2, float e_d2) {
  cg::grid_group grid = cg::this_grid();
  const int si = blockIdx.x / set.blocks_per_shard;
  const Shard me = set.s[si];
  const int prow = me.top + me.rows + me.bot;
  const int npix = prow * w;
  const size_t n = (size_t)npix;
  const size_t gn = (size_t)h * w;
  const int tid = (blockIdx.x - si * set.blocks_per_shard) * THREADS + threadIdx.x;
  const int stride = set.blocks_per_shard * THREADS;
  const int gy0 = me.row0 - me.top;  // global row of padded row 0
  float* const buf = me.buf;
  float* const uv = buf + P_UV * n;
  float* const fxyz = buf + P_FXYZ * n;
  float* const hoist = buf + P_HOIST * n;
  float* const J = TENSOR ? buf + P_J * n : nullptr;

  // Copy in the owned rows; T starts at uv.
  const int owned = me.rows * w;
  for (int i = tid; i < owned; i += stride) {
    const size_t g = (size_t)me.row0 * w + i;
    const size_t l = (size_t)me.top * w + i;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float u = uv_in[p * gn + g];
      uv[p * n + l] = u;
      buf[(P_TA + p) * n + l] = u;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) fxyz[p * n + l] = fxyz_in[p * gn + g];
    if (TENSOR) {
#pragma unroll
      for (int p = 0; p < 5; ++p) J[p * n + l] = J_in[p * gn + g];
    }
  }

  int cur = P_TA;
  for (int i = 0; i < outer; ++i) {
    // Every shard's owned rows are in (i = 0), or its last sweep is done.
    grid.sync();
    if (i % k == 0) {
      if (i == 0) {
        push_halos(set, si, P_UV, 5, halo, w, tid, stride);  // uv, fxyz
        if (TENSOR) push_halos(set, si, P_J, 5, halo, w, tid, stride);
      }
      push_halos(set, si, cur, 2, halo, w, tid, stride);
      grid.sync();
    }
    const float* T = buf + cur * n;
    for (int idx = tid; idx < npix; idx += stride) {
      const int y = idx / w, x = idx - y * w;
      tf_body::prologue_px<TENSOR>(T, uv, fxyz, J, hoist, y, x, prow, w, gy0 + y, h, div2hx,
                                   div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2);
    }
    for (int s = 0; s < inner; ++s) {
      if (s > 0) grid.sync();
      const int next = P_TA + P_TB - cur;
      const float* src = buf + cur * n;
      float* dst = buf + next * n;
      for (int idx = tid; idx < npix; idx += stride) {
        const int y = idx / w, x = idx - y * w;
        tf_body::sweep_px(src, uv, hoist, dst, y, x, prow, w);
      }
      cur = next;
    }
  }
  grid.sync();
  for (int i = tid; i < owned; i += stride) {
    const size_t g = (size_t)me.row0 * w + i;
    const size_t l = (size_t)me.top * w + i;
#pragma unroll
    for (int p = 0; p < 2; ++p) T_out[p * gn + g] = buf[(cur + p) * n + l];
  }
}

}  // namespace

extern "C" {

// bufs: n_y per-shard buffers, each (18 planes, or 23 with J) x its padded
// rows x w, uninitialised (every row is written before it is read: the
// owned rows at copy-in, the halos of the constants and of T at i = 0, the
// hoists and the second T over all padded rows by the prologue and the
// first sweep); row_bounds: n_y + 1 global row bounds of the owned ranges.
// J is null for grey. The grid is the co-resident maximum (blocks per SM at
// full occupancy x SMs, split evenly over the shards); a refused
// cooperative launch returns its error like any other.
int tf_relax_sharded(void* const* bufs, const int* row_bounds, int n_y, const float* uv,
                     const float* fxyz, const float* J, float* T_out, int h, int w, int halo,
                     int outer, int inner, int k, float div2hx, float div2hy, float alpha_hx2,
                     float alpha_hy2, float e_s2, float e_d2, void* stream) {
  if (n_y < 1 || n_y > MAX_SHARDS || k < 1 || halo < 0 || outer < 0 || inner < 0)
    return (int)cudaErrorInvalidValue;
  ShardSet set{};
  set.n = n_y;
  for (int s = 0; s < n_y; ++s) {
    set.s[s].buf = (float*)bufs[s];
    set.s[s].row0 = row_bounds[s];
    set.s[s].rows = row_bounds[s + 1] - row_bounds[s];
    set.s[s].top = s > 0 ? halo : 0;
    set.s[s].bot = s < n_y - 1 ? halo : 0;
  }
  const void* fn = J != nullptr ? (const void*)relax_sharded_kernel<true>
                                : (const void*)relax_sharded_kernel<false>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  set.blocks_per_shard = per_sm * sms / n_y;
  if (set.blocks_per_shard < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&set, &uv, &fxyz, &J, &T_out, &h, &w, &halo, &outer, &inner, &k,
                  &div2hx, &div2hy, &alpha_hx2, &alpha_hy2, &e_s2, &e_d2};
  err = cudaLaunchCooperativeKernel(fn, dim3(set.blocks_per_shard * n_y), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch leaves the context usable
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
