// Hopper (sm_90a) kernel for the row-sharded relaxation of one pyramid level,
// its shards on one card or spread over several cards of one host.
//
// It replaces relax_sharded_kernel (tpuflow/parallel/halo_kernel.py:100,
// pl.pallas_call :384), both halves of it: the per-shard outer x (phi/ksi +
// inner sweeps) relaxation, and the halo exchange inside the kernel. The TPU
// ran one kernel per chip, moved the halos to both ring neighbours by RDMA
// (make_async_remote_copy, :199-222) and fenced each send with a semaphore
// barrier between ring neighbours (:189-197, :351-357). Here every card of
// the row runs ONE cooperative launch over the shards it holds:
//   * the exchange is plain stores of a shard's edge rows into its
//     neighbour shards' halo rows: into the card's own memory, or through a
//     peer pointer over NVLink where the neighbour shard lives on another
//     card (the wrapper turns peer access on between the row's cards);
//   * the barrier is a grid-wide sync (cooperative_groups::this_grid()) of
//     the card's blocks. Where the row spans several cards, the two syncs
//     around a push (before it: no neighbour still writes, in its last
//     k-sweep pass, the halo rows the push overwrites; after it: the halos
//     are in before the prologue reads them) become row barriers: a grid
//     sync, a flag step with the neighbour cards, a grid sync. In the flag
//     step one thread stores the barrier's epoch into this card's flag in
//     each neighbour card's memory (a system-scope release, after a
//     system-scope fence by every thread) and spins on its own card's flags
//     (system-scope acquire loads) until every neighbour has stored that
//     epoch. CUDA 12 has no multi-device grid sync, so the flags are the
//     barrier. Epochs only grow: the host passes each launch the epoch its
//     flags hold and adds the launch's row barriers afterwards, so no flag is
//     reset (a reset on one card's stream could wipe a neighbour's signal)
//     and no flag of an earlier barrier satisfies a later wait. A spin longer
//     than SPIN_LIMIT_NS traps: a card whose neighbour never comes fails
//     loudly, never silently wrong. cudaLaunchCooperativeKernel starts a grid
//     only if every block is co-resident and refuses it otherwise; the entry
//     point computes and checks every card's grid before it launches the
//     first, so no card spins for a launch that will be refused.
//   * After a row barrier a block stages halo rows with cp.async.ca,
//     through the L1, as it stages rows that other blocks of its card wrote
//     in the one-card form: the grid sync that ends the barrier is an
//     acquire for every block, after block 0 has acquired the neighbours'
//     flags, and the peer stores are in this card's memory before the
//     neighbour's release. The race case of chip_smoke.py (one card held
//     back before its launch) checks that no halo row comes from a stale
//     line.
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
// Phases (the syncs are grid-wide, the row barriers span the row's cards);
// a block works on one shard of its card, and loops over that shard's tiles
// with a stride of the shard's block count:
//   copy in   each shard copies its owned rows of uv, fxyz, J from the
//             level's fields (on the row's first card; over processes, its
//             own card's copy), and T = uv
//   outer i   sync; every k outers (with more than one shard) a row barrier
//             in its place, the push of the halos of T (at i = 0 also those
//             of uv, fxyz and J, once), a row barrier;
//             prologue tiles over all padded rows (tf_body::prologue_tile,
//             64 x 8, phi once per pixel from shared memory: reads T, writes
//             the 9 hoists); sync, since a k-sweep region's ring reads the
//             hoists of neighbouring tiles; ceil(inner / 5) passes of k-sweep
//             regions over all padded rows (tf_body::ksweep_region, 64 x 32,
//             up to 5 sweeps in shared memory: reads T and the hoists, writes
//             the other T buffer), a sync between two passes
//   copy out  sync; each shard writes its owned rows of T (to the first card;
//             over processes to every card's T, then a row barrier over all
//             the row's cards)
// That is 2 syncs an outer at inner <= 5 (3 with a push), where a sync
// between every two sweeps made 6; over several cards each row barrier adds
// a grid sync and a flag step. The padded buffer is the "image" of both
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
// Across N cards the function's arithmetic over the owned pixels splits N
// ways, and each exchange adds one halo message a side over NVLink (2 planes
// x halo rows x w, at 450 GB/s each way on an H100 SXM), plus a row barrier's
// round trip; the copy-in and copy-out of a card's owned rows cross NVLink
// from and to the row's first card (roofline.kernel_work(..., cards=N)).
//
// Processes. A row whose shards belong to several processes, one process a
// card (or several processes on one card), runs the same kernel: each
// process makes one cooperative launch, on its own card, through the same
// entry point with a mask that names its card alone. The shard buffers,
// each card's T and the flags lie in one arena a card, allocated here
// (tf_ipc_alloc) and opened in the other processes from CUDA IPC handles
// (tf_ipc_get_handle / tf_ipc_open_handle, parallel/ipc.py), so the halo
// stores and the flags work as between the cards of one process. Two things
// differ: each card copies its owned rows in from its own copy of the
// level's fields (every process computes them, bitwise the same), and its
// copy-out stores its owned rows of T into every card's T, after which one
// more row barrier, over all the row's cards, ends the launch: every card
// then holds the whole T. On one card two processes' launches take turns
// by time slices (there is no MPS), so each row barrier between them waits
// for the other context's slice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstring>

#include "level_body.cuh"

namespace {

namespace cg = cooperative_groups;
using tf_body::KS_KMAX;
using tf_body::KS_RH;
using tf_body::KS_RW;
using tf_body::PRO_TH;

constexpr int MAX_SHARDS = 8;  // the JAX tests' device count
constexpr int MAX_CARDS = MAX_SHARDS;  // each card of a row holds a shard
// A card that spins this long on a neighbour's flag traps (10 s; one launch
// of the largest level takes tens of ms).
constexpr unsigned long long SPIN_LIMIT_NS = 10000000000ull;
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
  Shard s[MAX_SHARDS];   // every shard of the row (buf: a peer pointer on another card)
  int n;                 // shards of the row
  int mine[MAX_SHARDS];  // the shards this card's launch runs, in row order
  int n_mine;
  int blocks_per_shard;  // the grid is n_mine x blocks_per_shard blocks
};

// This card's flags with its neighbour cards (those that hold a shard next
// to one of its own). Flag j in a card's memory is stored only by card j.
struct RowLinks {
  unsigned long long* out[MAX_CARDS];       // this card's flag in each neighbour's memory
  const unsigned long long* in[MAX_CARDS];  // each neighbour's flag in this card's memory
  int n;                                    // neighbour cards: 0 on a row on one card
  unsigned long long epoch;                 // what the flags hold before this launch
};

// Where the copy-out stores T: the row's first card's T alone (one process),
// or every card's (processes; then the launch ends with a row barrier over
// all the row's cards, whose flags are the same ones).
struct Targets {
  float* T[MAX_CARDS];
  int n;
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A barrier of the row's cards at `epoch`: every block of this card and
// every neighbour card has come to it, and the stores before it, peer stores
// included, are visible after it. On a row on one card it is the grid sync
// alone. Block 0 counts the flag step in *barriers when barriers is not null.
__device__ void row_barrier(cg::grid_group& grid, const RowLinks& links,
                            unsigned long long epoch, unsigned int* syncs,
                            unsigned int* barriers) {
  if (links.n == 0) {
    grid_sync(grid, syncs);
    return;
  }
  __threadfence_system();  // this thread's stores reach every card
  grid_sync(grid, syncs);
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    for (int j = 0; j < links.n; ++j) store_release_sys(links.out[j], epoch);
    const unsigned long long t0 = global_ns();
    for (int j = 0; j < links.n; ++j)
      while (load_acquire_sys(links.in[j]) < epoch)
        if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
    if (barriers != nullptr) ++*barriers;
  }
  grid_sync(grid, syncs);
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
    relax_sharded_kernel(ShardSet set, RowLinks links, RowLinks everyone, Targets out,
                         const float* __restrict__ uv_in,
                         const float* __restrict__ fxyz_in, const float* __restrict__ J_in,
                         unsigned int* __restrict__ syncs,
                         unsigned int* __restrict__ barriers, int h, int w, int halo,
                         int outer, int inner, int k, float div2hx,
                         float div2hy, float alpha_hx2, float alpha_hy2, float e_s2,
                         float e_d2) {
  extern __shared__ __align__(16) unsigned char smem[];
  SharedTiles<TENSOR>& sm = *reinterpret_cast<SharedTiles<TENSOR>*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int bps = set.blocks_per_shard;
  const int mi = blockIdx.x / bps, bis = blockIdx.x - mi * bps;  // shard, block within it
  const int si = set.mine[mi];
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
  unsigned long long epoch = links.epoch;
  int cur = P_TA;
  for (int i = 0; i < outer; ++i) {
    const bool push = set.n > 1 && i % k == 0;
    // Every shard's owned rows are in (i = 0), or its last sweep is done;
    // before a push also on the neighbour cards, whose halo rows it writes.
    if (push) row_barrier(grid, links, ++epoch, syncs, barriers);
    else grid_sync(grid, syncs);
    if (push) {
      if (i == 0) {
        push_halos(set, si, P_UV, 5, halo, w, tid, stride);  // uv, fxyz
        if (TENSOR) push_halos(set, si, P_J, 5, halo, w, tid, stride);
      }
      push_halos(set, si, cur, 2, halo, w, tid, stride);
      row_barrier(grid, links, ++epoch, syncs, barriers);  // every halo is in
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
    for (int p = 0; p < 2; ++p) {
      const float t = buf[(cur + p) * n + l];
      for (int c = 0; c < out.n; ++c) out.T[c][p * gn + g] = t;
    }
  }
  // Processes: every card's T is whole once every card of the row is here.
  if (out.n > 1) row_barrier(grid, everyone, ++epoch, syncs, barriers);
}

}  // namespace

extern "C" {

// One cooperative launch on each card of the row's n_cards cards that
// `launch` names (bit c: card c). devices[c] is card c's CUDA device and
// streams[c] the stream of its launch (read for launched cards only). bufs:
// the n_y per-shard buffers, shard s on card shard_card[s], each (18 planes,
// or 23 with J) x its padded rows x w, uninitialised (every row is written
// before it is read: the owned rows at copy-in, the halos of the constants
// and of T at i = 0, the hoists over all padded rows by the prologue tiles,
// the second T by the first pass's regions, whose tiles partition the
// padded rows); row_bounds: n_y + 1 global row bounds of the owned ranges.
// uv, fxyz and J (null for grey): the level's fields, one pointer a card,
// each card's copy-in reading its own. T_out: n_targets pointers, 1 (the
// row's first card's T, which every shard's copy-out fills: one process,
// every card launched by this call) or n_cards (each card's own T, which
// every shard's copy-out fills, and a last row barrier over all the cards:
// a row over processes, each call launching its own card). flags (several
// cards only): each card's MAX_CARDS flags, which hold `epoch`; the launch
// adds its row barriers to them. w >= 2, inner >= 1. syncs and barriers,
// when not null, are n_cards counters to which card c's launch adds its
// grid syncs and row barriers. Leaving a card out of `launch` in one process
// makes its neighbours trap at the spin limit, which is what a test of the
// limit needs. A card's grid is the co-resident maximum (blocks per SM at
// full occupancy x SMs, split evenly over its shards); every launched
// card's grid is computed and checked before the first launch, and a
// refused launch returns its error like any other. Peer access between the
// cards must be on (between processes, the IPC handles open it).
int tf_relax_sharded(int n_cards, const int* devices, void* const* streams, void* const* bufs,
                     const int* shard_card, const int* row_bounds, int n_y, void* const* flags,
                     unsigned long long epoch, const float* const* uv,
                     const float* const* fxyz, const float* const* J, float* const* T_out,
                     int n_targets, unsigned int launch, unsigned int* syncs,
                     unsigned int* barriers, int h, int w, int halo, int outer, int inner, int k,
                     float div2hx, float div2hy, float alpha_hx2, float alpha_hy2, float e_s2,
                     float e_d2) {
  if (n_cards < 1 || n_cards > MAX_CARDS || n_y < n_cards || n_y > MAX_SHARDS || k < 1 ||
      halo < 0 || outer < 0 || inner < 1 || w < 2 || (n_cards > 1 && flags == nullptr) ||
      (n_targets != 1 && n_targets != n_cards) || (n_targets > 1 && n_cards < 2))
    return (int)cudaErrorInvalidValue;
  ShardSet set{};
  set.n = n_y;
  for (int s = 0; s < n_y; ++s) {
    if (shard_card[s] < 0 || shard_card[s] >= n_cards) return (int)cudaErrorInvalidValue;
    set.s[s].buf = (float*)bufs[s];
    set.s[s].row0 = row_bounds[s];
    set.s[s].rows = row_bounds[s + 1] - row_bounds[s];
    set.s[s].top = s > 0 ? halo : 0;
    set.s[s].bot = s < n_y - 1 ? halo : 0;
  }
  Targets out{};
  out.n = n_targets;
  for (int t = 0; t < n_targets; ++t) out.T[t] = T_out[t];
  const void* fn = J != nullptr ? (const void*)relax_sharded_kernel<true>
                                : (const void*)relax_sharded_kernel<false>;
  const size_t smem = J != nullptr ? sizeof(SharedTiles<true>) : sizeof(SharedTiles<false>);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  ShardSet sets[MAX_CARDS];
  RowLinks links[MAX_CARDS], everyone[MAX_CARDS];
  for (int c = 0; c < n_cards && err == cudaSuccess; ++c) {
    if (!(launch >> c & 1u)) continue;
    ShardSet& card = sets[c] = set;
    for (int s = 0; s < n_y; ++s)
      if (shard_card[s] == c) card.mine[card.n_mine++] = s;
    RowLinks& ln = links[c] = RowLinks{};
    RowLinks& all = everyone[c] = RowLinks{};
    ln.epoch = all.epoch = epoch;
    for (int j = 0; j < n_cards; ++j) {
      bool next_to = false;
      for (int s = 0; s < n_y; ++s)
        next_to |= j != c && shard_card[s] == c &&
                   ((s > 0 && shard_card[s - 1] == j) || (s + 1 < n_y && shard_card[s + 1] == j));
      if (next_to) {
        ln.out[ln.n] = (unsigned long long*)flags[j] + c;
        ln.in[ln.n] = (const unsigned long long*)flags[c] + j;
        ++ln.n;
      }
      if (n_targets > 1 && j != c) {
        all.out[all.n] = (unsigned long long*)flags[j] + c;
        all.in[all.n] = (const unsigned long long*)flags[c] + j;
        ++all.n;
      }
    }
    // every card holds a shard, and on several cards each has a neighbour card
    if (card.n_mine == 0 || (n_cards > 1 && ln.n == 0)) err = cudaErrorInvalidValue;
    int coop = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaSetDevice(devices[c]);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, devices[c]);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, devices[c]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess) {
      card.blocks_per_shard = per_sm * sms / card.n_mine;
      if (card.blocks_per_shard < 1) err = cudaErrorCooperativeLaunchTooLarge;
    }
  }
  for (int c = 0; c < n_cards && err == cudaSuccess; ++c) {
    if (!(launch >> c & 1u)) continue;
    unsigned int* card_syncs = syncs != nullptr ? syncs + c : nullptr;
    unsigned int* card_barriers = barriers != nullptr ? barriers + c : nullptr;
    const float* card_uv = uv[c];
    const float* card_fxyz = fxyz[c];
    const float* card_J = J != nullptr ? J[c] : nullptr;
    void* args[] = {&sets[c], &links[c], &everyone[c], &out, &card_uv, &card_fxyz, &card_J,
                    &card_syncs, &card_barriers, &h, &w, &halo, &outer, &inner, &k, &div2hx,
                    &div2hy, &alpha_hx2, &alpha_hy2, &e_s2, &e_d2};
    err = cudaSetDevice(devices[c]);
    if (err == cudaSuccess)
      err = cudaLaunchCooperativeKernel(fn, dim3(sets[c].blocks_per_shard * sets[c].n_mine),
                                        dim3(KS_RW, tf_body::KS_TY), args, smem,
                                        (cudaStream_t)streams[c]);
    if (err == cudaSuccess) err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear it: a refused launch leaves the context usable
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

// Let `device`'s kernels reach `peer`'s memory. Access that is already on
// (torch's copies between the cards turn it on too) counts as success, and
// its error is cleared.
int tf_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

// The arena of one card for a row over processes (parallel/ipc.py):
// `bytes` of device memory on `device`, zeroed (the flags start at epoch 0),
// and settled before this returns.
int tf_ipc_alloc(int device, size_t bytes, void** ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

int tf_ipc_free(int device, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaFree(ptr);
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

// The IPC handle (64 bytes into out64) of an allocation of tf_ipc_alloc: it
// names the whole cudaMalloc allocation, so `ptr` must be its start.
int tf_ipc_get_handle(void* ptr, unsigned char* out64) {
  static_assert(sizeof(cudaIpcMemHandle_t) == 64, "a CUDA IPC handle is 64 bytes");
  cudaIpcMemHandle_t handle;
  const cudaError_t err = cudaIpcGetMemHandle(&handle, ptr);
  if (err == cudaSuccess) memcpy(out64, &handle, sizeof(handle));
  return (int)err;
}

// Map another process's allocation (its 64-byte handle) into this one, on
// `device`, with peer access turned on where it lies on another card.
int tf_ipc_open_handle(const unsigned char* in64, int device, void** ptr) {
  cudaIpcMemHandle_t handle;
  memcpy(&handle, in64, sizeof(handle));
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcOpenMemHandle(ptr, handle, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) cudaGetLastError();
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

int tf_ipc_close_handle(int device, void* ptr) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  const cudaError_t restored = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : restored);
}

}  // extern "C"
