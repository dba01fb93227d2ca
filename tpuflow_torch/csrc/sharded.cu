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
// Phases (the syncs are grid-wide); a block works on one shard, and loops
// over that shard's tiles with a stride of the shard's block count:
//   copy in   each shard copies its owned rows of uv, fxyz, J from the
//             level's fields, and T = uv
//   outer i   sync; every k outers (with more than one shard): push the
//             halos of T (at i = 0 also those of uv, fxyz and J, once), sync;
//             prologue tiles over all padded rows (tf_body::prologue_tile,
//             64 x 8, phi once per pixel from shared memory: reads T, writes
//             the 9 hoists); sync, since a k-sweep region's ring reads the
//             hoists of neighbouring tiles; ceil(inner / 5) passes of k-sweep
//             regions over all padded rows (tf_body::ksweep_region, 64 x 32,
//             up to 5 sweeps in shared memory: reads T and the hoists, writes
//             the other T buffer), a sync between two passes
//   copy out  sync; each shard writes its owned rows of T
// That is 2 syncs an outer at inner <= 5 (3 with a push), where a sync
// between every two sweeps made 6. The padded buffer is the "image" of both
// tile bodies: its edges are mirror edges (the image's own where the shard
// touches the image), the free-boundary weights take the pixel's global row,
// and a k-sweep region shrinks only at sides that are not buffer edges. So
// every pixel of the buffer is bitwise what the chained one-sweep passes
// over the buffer give it (level_body.cuh), and one outer consumes inner + 1
// rows of the margin (1 for phi's gradient, 1 for phi's neighbour mean, 1
// per further sweep; halo.py:110-114): with halo = k (inner + 1) rows the
// owned rows after k outers read only true values. They are bitwise those
// of the unsharded kernels for any shard count and k, since the bodies are
// the same functions under the same flags. The port's levels are
// exact-size, so the TPU kernel's ghost upkeep (maintain1, top_fill) has no
// counterpart, and the ring is open at the image edges: the wrapped
// messages of the TPU's closed ring are not sent.
//
// Bound. The function needs its float32 arithmetic (the prologues' and the
// sweeps', over the owned pixels) and its planes once; the arithmetic binds
// (tools/roofline.py: kernel_work). What the design streams per outer over
// each shard's padded rows is what the unsharded launches stream over a
// level: the prologue tiles' 16 or 21 planes and a 2-pixel ring of T, and
// each k-sweep pass's regions (T over the tile and its ring, 13 planes where
// the first sweep updates, 2 written), plus the pushes (2 planes x halo rows
// x w per side). The block is one shape for both bodies: 64 x 8 threads.
// Inside the cooperative launch the bodies meet two costs they do not meet
// in their own launches (PERF.md, measured on an H100):
//   * registers: beside the loops' state, the k-sweep's 44 registers of
//     constants spilled at the 64 a thread that two blocks an SM allow. So
//     the kernel runs one block an SM (132 blocks on an H100) with up to
//     128 registers, and spills nothing;
//   * warps: one block an SM holds a sixth of the warps of the prologue's
//     own launch, so a block stages its next prologue tile (cp.async into
//     a second tile) while it finishes the current one.
// Shared memory is dynamic: two prologue tiles (59 KB with J) or a k-sweep
// region (32 KB), in a union.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "level_body.cuh"

namespace {

namespace cg = cooperative_groups;
using tf_body::KS_KMAX;
using tf_body::KS_RH;
using tf_body::KS_RW;
using tf_body::PRO_TH;

constexpr int MAX_SHARDS = 8;  // the JAX tests' device count
constexpr int THREADS = tf_body::KS_THREADS;  // a block: KS_RW x KS_TY threads
constexpr int SH_PRO_TW = KS_RW;              // a prologue tile is the block's width
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

// The shared memory of one block: two prologue tiles (one staged while the
// other finishes), or a k-sweep region. Dynamic: 59 KB with J.
template <bool TENSOR>
union SharedTiles {
  tf_body::ProTile<SH_PRO_TW, TENSOR> pro[2];
  float ks[tf_body::KS_SHARED];
};

// Store `planes` planes from plane `plane0` of shard si's edge rows into the
// neighbours' halo rows: its top `halo` owned rows into the previous shard's
// bottom halo, its bottom `halo` owned rows into the next shard's top halo.
__device__ void push_halos(const ShardSet& set, int si, int plane0, int planes, int halo,
                           int w, int tid, int stride) {
  const Shard me = set.s[si];
  const size_t n = (size_t)(me.top + me.rows + me.bot) * w;
  const int count = halo * w;
  for (int up = 0; up < 2; ++up) {
    const int oi = up ? si - 1 : si + 1;
    if (oi < 0 || oi >= set.n) continue;
    const Shard o = set.s[oi];
    const size_t on = (size_t)(o.top + o.rows + o.bot) * w;
    const float* src =
        me.buf + plane0 * n + (size_t)(up ? me.top : me.top + me.rows - halo) * w;
    float* dst = o.buf + plane0 * on + (size_t)(up ? o.top + o.rows : 0) * w;
    for (int p = 0; p < planes; ++p)
      for (int j = tid; j < count; j += stride) dst[p * on + j] = src[p * n + j];
  }
}

// A grid-wide sync; block 0 counts it in *syncs when syncs is not null.
__device__ __forceinline__ void grid_sync(cg::grid_group& grid, unsigned int* syncs) {
  grid.sync();
  if (syncs != nullptr && blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) ++*syncs;
}

// One pass of K sweeps over a shard's padded rows: the block's share of
// the regions, one after another.
template <int K>
__device__ void ksweep_pass(float* ts, const float* T, const float* uv, const float* hoist,
                            float* T_out, int prow, int w, int first, int stride) {
  constexpr int TW = KS_RW - 2 * K, TH = KS_RH - 2 * K;
  const int tiles_x = (w + TW - 1) / TW, tiles = tiles_x * ((prow + TH - 1) / TH);
  for (int t = first; t < tiles; t += stride) {
    const int by = t / tiles_x, bx = t - by * tiles_x;
    tf_body::ksweep_region<K>(ts, T, uv, hoist, T_out, bx * TW, by * TH, prow, w);
    __syncthreads();  // before the next region reuses ts
  }
}

template <bool TENSOR>
__global__ void __launch_bounds__(THREADS, 1)
    relax_sharded_kernel(ShardSet set, const float* __restrict__ uv_in,
                         const float* __restrict__ fxyz_in, const float* __restrict__ J_in,
                         float* __restrict__ T_out, unsigned int* __restrict__ syncs, int h,
                         int w, int halo, int outer, int inner, int k, float div2hx,
                         float div2hy, float alpha_hx2, float alpha_hy2, float e_s2,
                         float e_d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  SharedTiles<TENSOR>& sm = *reinterpret_cast<SharedTiles<TENSOR>*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int bps = set.blocks_per_shard;
  const int si = blockIdx.x / bps, bis = blockIdx.x - si * bps;  // shard, block within it
  const Shard me = set.s[si];
  const int prow = me.top + me.rows + me.bot;
  const size_t n = (size_t)prow * w;
  const size_t gn = (size_t)h * w;
  const int tid = bis * THREADS + threadIdx.y * KS_RW + threadIdx.x;
  const int stride = bps * THREADS;
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

  const int pro_x = (w + SH_PRO_TW - 1) / SH_PRO_TW;
  const int pro_tiles = pro_x * ((prow + PRO_TH - 1) / PRO_TH);
  int cur = P_TA;
  for (int i = 0; i < outer; ++i) {
    // Every shard's owned rows are in (i = 0), or its last sweep is done.
    grid_sync(grid, syncs);
    if (set.n > 1 && i % k == 0) {
      if (i == 0) {
        push_halos(set, si, P_UV, 5, halo, w, tid, stride);  // uv, fxyz
        if (TENSOR) push_halos(set, si, P_J, 5, halo, w, tid, stride);
      }
      push_halos(set, si, cur, 2, halo, w, tid, stride);
      grid_sync(grid, syncs);
    }
    // The block's prologue tiles, each staged while the one before finishes.
    const float* T = buf + cur * n;
    if (bis < pro_tiles) {
      const int ty = bis / pro_x, tx = bis - ty * pro_x;
      tf_body::prologue_stage<SH_PRO_TW, TENSOR>(sm.pro[0], T, uv, fxyz, J, tx * SH_PRO_TW,
                                                 ty * PRO_TH, prow, w);
    }
    tf_body::cp_async_commit();
    for (int t = bis, b = 0; t < pro_tiles; t += bps, b ^= 1) {
      if (t + bps < pro_tiles) {
        const int ty = (t + bps) / pro_x, tx = (t + bps) - ty * pro_x;
        tf_body::prologue_stage<SH_PRO_TW, TENSOR>(sm.pro[b ^ 1], T, uv, fxyz, J,
                                                   tx * SH_PRO_TW, ty * PRO_TH, prow, w);
      }
      tf_body::cp_async_commit();
      tf_body::cp_async_wait<1>();  // tile t's copies have landed
      __syncthreads();
      const int ty = t / pro_x, tx = t - ty * pro_x;
      tf_body::prologue_finish<SH_PRO_TW, TENSOR>(sm.pro[b], hoist, tx * SH_PRO_TW,
                                                  ty * PRO_TH, prow, w, gy0, h, div2hx, div2hy,
                                                  alpha_hx2, alpha_hy2, e_s2, e_d2);
      __syncthreads();  // before tile t + 2 bps is staged into sm.pro[b]
    }
    grid_sync(grid, syncs);
    for (int done = 0; done < inner; done += KS_KMAX) {
      if (done > 0) grid_sync(grid, syncs);
      const int next = P_TA + P_TB - cur;
      const float* src = buf + cur * n;
      float* dst = buf + next * n;
      switch (min(KS_KMAX, inner - done)) {
        case 1: ksweep_pass<1>(sm.ks, src, uv, hoist, dst, prow, w, bis, bps); break;
        case 2: ksweep_pass<2>(sm.ks, src, uv, hoist, dst, prow, w, bis, bps); break;
        case 3: ksweep_pass<3>(sm.ks, src, uv, hoist, dst, prow, w, bis, bps); break;
        case 4: ksweep_pass<4>(sm.ks, src, uv, hoist, dst, prow, w, bis, bps); break;
        default: ksweep_pass<5>(sm.ks, src, uv, hoist, dst, prow, w, bis, bps); break;
      }
      cur = next;
    }
  }
  grid_sync(grid, syncs);
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
// hoists over all padded rows by the prologue tiles, the second T by the
// first pass's regions, whose tiles partition the padded rows); row_bounds:
// n_y + 1 global row bounds of the owned ranges. J is null for grey; w >= 2,
// inner >= 1. syncs, when not null, is one device counter to which the
// launch adds the grid syncs it made. The grid is the co-resident maximum
// (blocks per SM at full occupancy x SMs, split evenly over the shards); a
// refused cooperative launch returns its error like any other.
int tf_relax_sharded(void* const* bufs, const int* row_bounds, int n_y, const float* uv,
                     const float* fxyz, const float* J, float* T_out, unsigned int* syncs,
                     int h, int w, int halo, int outer, int inner, int k, float div2hx,
                     float div2hy, float alpha_hx2, float alpha_hy2, float e_s2, float e_d2,
                     void* stream) {
  if (n_y < 1 || n_y > MAX_SHARDS || k < 1 || halo < 0 || outer < 0 || inner < 1 || w < 2)
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
  const size_t smem = J != nullptr ? sizeof(SharedTiles<true>) : sizeof(SharedTiles<false>);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  set.blocks_per_shard = per_sm * sms / n_y;
  if (set.blocks_per_shard < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&set, &uv, &fxyz, &J, &T_out, &syncs, &h, &w, &halo, &outer, &inner, &k,
                  &div2hx, &div2hy, &alpha_hx2, &alpha_hy2, &e_s2, &e_d2};
  err = cudaLaunchCooperativeKernel(fn, dim3(set.blocks_per_shard * n_y),
                                    dim3(KS_RW, tf_body::KS_TY), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: a refused launch leaves the context usable
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
