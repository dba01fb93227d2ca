// Hopper (sm_90a) kernels for one pyramid level of the flow solve, for all
// three data constancies (grey, gradient, log-derivative).
//
// They replace the TPU's level kernels, which all compute one function and
// differ only in where the TPU kept each field:
//   level_fused_whole      tpuflow/ops/pallas/level_fused.py:526  (body :246, warp :179)
//   level_fused            tpuflow/ops/pallas/level_fused.py:472
//   _relax_bucket_full     tpuflow/ops/pallas/relax_bucket.py:400
//   _relax_bucket_chunked  tpuflow/ops/pallas/relax_bucket.py:176
//   _relax_du_full         tpuflow/ops/pallas/relax_du.py:241
//   _relax_du_chunked      tpuflow/ops/pallas/relax_du.py:457
//   _relax_du_streamed     tpuflow/ops/pallas/relax_du.py:874
// For the gradient and log constancies the first two build a second-order
// motion tensor in-kernel (level_fused.py:291-322) and their prologue reads
// it (:379-392); the other five take it through their tensor= argument
// (tpuflow/solver/bucketed.py:422-444,476-530). tf_level_tensor replaces
// that tensor, and tf_outer_prologue_tensor the prologue that reads it.
// On this card a level does not fit one core's fast memory, so the level is
// a short sequence of launches over fields in device memory:
//   tf_warp                   once per level  backward bilinear warp
//   tf_level_derivs           once per level  fx, fy, ft
//   tf_level_tensor           once per level  J11..J23 (gradient and log only)
//   tf_outer_prologue         once per outer  phi/ksi and the per-outer hoists
//   tf_outer_prologue_tensor  once per outer  the same, the hoists from J
//   tf_jacobi_sweeps          once per outer  the inner loop: k <= KS_KMAX sweeps
//   tf_jacobi_sweep           (twin)          one coupled T-form sweep; k chained
//                                             launches are what tf_jacobi_sweeps
//                                             is held against, bit for bit
//   tf_add_median             once per level  u + (T - u), then the window median
//
// Every field is a contiguous float32 (h, w) plane at the level's exact
// size; stacks are planes back to back. The mirror boundary is reflect
// indexing (neighbour -1 reads 1, neighbour n reads n-2), which is what the
// TPU's ghost rows held in the valid region (tpuflow/ops/solver_ops.py:228-235).
// The one exception is the second-order tensor's stencil over derivative
// fields, which replicates (clamp: neighbour -1 reads 0, n reads n-1).
//
// warp, level_derivs, the gradient level_tensor and jacobi_sweep are one
// thread per pixel over 32x8 blocks. Each reads a few neighbouring floats and
// does ~1 FLOP per byte, so device-memory bandwidth bounds them at fine levels
// and launch latency at coarse ones; neighbour reuse comes from L1/L2, not
// shared memory. The log level_tensor, outer_prologue, jacobi_sweeps and
// add_median stage their stencil input in shared-memory tiles (their comments
// say why); the prologue's and the k-sweep's tile bodies live in
// level_body.cuh, where the row-sharded kernel (sharded.cu) runs them too.
// Pixel indices are int (a 3840x2160 level has 8.3 M pixels); plane offsets
// are size_t.
//
// Numerics: the expressions keep the association order of the JAX
// kernels term for term. The library is built without fast math and with
// --fmad=false, so sqrtf and '/' round as IEEE and no multiply-add is
// contracted: the kernels then agree with their plain PyTorch versions to
// the last bit in practice (on an H100 even log1pf matches torch.log1p,
// though nothing promises it), and the bounds in the tests have room to
// spare.
//
// Output row ranges. warp, level_derivs, level_tensor and add_median take
// rows lo .. hi - 1 of the level (0 .. h for the whole level): their grid
// covers only those output rows, which they write into the whole-size
// output, and they read their inputs by the level's own coordinates, with
// the level's height h for refl and clamp_idx. So an output row is the same,
// bit for bit, whichever range it is computed in (the pattern of
// tf_outer_prologue's gy0/gh). The row-sharded pipeline over processes
// computes each process's rows this way (solver/bands.py). The staged
// kernels (the log tensor, add_median) also stage only the rows that some
// output of the range reads.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>

#include "level_body.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

using tf_body::refl;  // the reference mirror (level_body.cuh)

__device__ __forceinline__ int clamp_idx(int i, int n) {
  // Replicate boundary of the derivative fields (solve_2d.cu:813-841).
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

dim3 grid_for(int h, int w) { return dim3((w + BX - 1) / BX, (h + BY - 1) / BY); }

// A launch over output rows lo .. hi - 1 of a level: the grid of hi - lo rows.
bool bad_rows(int lo, int hi, int h) { return lo < 0 || hi > h || lo >= hi; }

// ---------------------------------------------------------------------------
// warp: replaces the in-kernel shift-sum (level_fused.py:179-243), the XLA
// widened tier and the exact gather (bucketed.py:236-361). The TPU needed
// the tiers because its gathers run on the scalar unit; here one exact
// 4-tap gather serves every displacement.
// Bound: 4 scattered reads of f1 per pixel (L2 serves them for small flow).
// ---------------------------------------------------------------------------
__global__ void warp_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                            const float* __restrict__ uv, float* __restrict__ out,
                            int h, int w, int lo, int hi, float inv_hx, float inv_hy) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = lo + blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= hi) return;
  const size_t n = (size_t)h * w;
  const int i = y * w + x;
  const float x_f = (float)x + uv[i] * inv_hx;
  const float y_f = (float)y + uv[n + i] * inv_hy;
  // Out of [0, w-1] x [0, h-1], or NaN, copies frame_0 (registration_2d.cu:48-72).
  const bool invalid = !(x_f >= 0.0f) || x_f > (float)(w - 1) ||
                       !(y_f >= 0.0f) || y_f > (float)(h - 1);
  if (invalid) {
    out[i] = f0[i];
    return;
  }
  const float x0f = floorf(x_f);
  const float y0f = floorf(y_f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int x1 = min(w - 1, x0 + 1);
  const int y1 = min(h - 1, y0 + 1);
  const float dx = x_f - x0f;
  const float dy = y_f - y0f;
  const float w00 = (1.0f - dx) * (1.0f - dy);
  const float w01 = dx * (1.0f - dy);
  const float w10 = (1.0f - dx) * dy;
  const float w11 = dx * dy;
  // The shift-sum's association: (row y0) + (row y1).
  out[i] = (w00 * f1[y0 * w + x0] + w01 * f1[y0 * w + x1]) +
           (w10 * f1[y1 * w + x0] + w11 * f1[y1 * w + x1]);
}

// ---------------------------------------------------------------------------
// level_derivs: the grey first derivatives, once per level
// (level_fused.py:285-289, bucketed.py:389-418).
// Bound: 2 input planes read, 3 written.
// ---------------------------------------------------------------------------
__global__ void level_derivs_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                                    float* __restrict__ fxyz, int h, int w, int lo, int hi,
                                    float div4hx, float div4hy) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = lo + blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= hi) return;
  const size_t n = (size_t)h * w;
  const int c = y * w + x;
  const int xp = y * w + refl(x + 1, w), xm = y * w + refl(x - 1, w);
  const int yp = refl(y + 1, h) * w + x, ym = refl(y - 1, h) * w + x;
  fxyz[c] = (f0[xp] - f0[xm] + f1[xp] - f1[xm]) / div4hx;
  fxyz[n + c] = (f0[yp] - f0[ym] + f1[yp] - f1[ym]) / div4hy;
  fxyz[2 * n + c] = f1[c] - f0[c];
}

// ---------------------------------------------------------------------------
// level_tensor: the second-order motion tensor of the gradient and
// log-derivative data terms, once per level (level_fused.py:291-322,
// bucketed.py:422-444, reference solve_2d.cu:798-884). J at a pixel takes
// the first-derivative fields g = (gx, gy, gt) at its four clamped
// neighbours; the second differences multiply by the host-rounded hx_1 =
// f32(1/(2h)), and J is formed by the same expressions in both kernels
// (tensor_from).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tensor_from(const float* g_xp, const float* g_xm,
                                            const float* g_yp, const float* g_ym, float hx_1,
                                            float hy_1, float* __restrict__ J, size_t n,
                                            int c) {
  const float fxx = (g_xp[0] - g_xm[0]) * hx_1;
  const float fxy = (g_yp[0] - g_ym[0]) * hy_1;
  const float fyy = (g_yp[1] - g_ym[1]) * hy_1;
  const float fxt = (g_xp[2] - g_xm[2]) * hx_1;
  const float fyt = (g_yp[2] - g_ym[2]) * hy_1;
  J[c] = fxx * fxx + fxy * fxy;          // J11
  J[n + c] = fxy * fxy + fyy * fyy;      // J22
  J[2 * n + c] = fxx * fxy + fxy * fyy;  // J12
  J[3 * n + c] = fxx * fxt + fxy * fyt;  // J13
  J[4 * n + c] = fxy * fxt + fyy * fyt;  // J23
}

// The gradient tensor: g is the grey fxyz, read at the clamped neighbours.
// Bound: bytes, 3 planes read (10 neighbouring floats, from L1/L2), 5 written.
__global__ void level_tensor_kernel(const float* __restrict__ fxyz, float* __restrict__ J,
                                    int h, int w, int lo, int hi, float hx_1, float hy_1) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = lo + blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= hi) return;
  const size_t n = (size_t)h * w;
  float g[4][3];  // at x+1, x-1, y+1, y-1
  const int at[4] = {y * w + clamp_idx(x + 1, w), y * w + clamp_idx(x - 1, w),
                     clamp_idx(y + 1, h) * w + x, clamp_idx(y - 1, h) * w + x};
#pragma unroll
  for (int d = 0; d < 4; ++d) {
#pragma unroll
    for (int p = 0; p < 3; ++p) g[d][p] = fxyz[p * n + at[d]];
  }
  tensor_from(g[0], g[1], g[2], g[3], hx_1, hy_1, J, n, y * w + x);
}

// The log-derivative tensor: g is the level_derivs stencil (reflect) over
// log1pf of the two frames. Recomputing g at each of the four neighbours
// from device memory took 32 log1pf a pixel and held the kernel at 0.21 of
// its byte bound on an H100 (PERF.md); the TPU kernel took log1p of each
// frame once as a field and shifted it (level_fused.py:293-299). So, as the
// prologue computes phi once per pixel:
//   1. a 32 x 8 block owns a 32 x LT_TH tile and copies both frames over
//      it plus a 2-pixel ring into shared memory (cp.async, 4 bytes each),
//      each entry at its own image coordinate, where that lies in the image;
//   2. it applies log1pf in place: 2 x (LT_TH + 4) x 36 / (32 LT_TH)
//      evaluations a pixel for the two frames;
//   3. it forms g over the tile plus a 1-pixel ring into a second shared
//      tile: entry q holds g at image coordinate clamp(q), from the log
//      tile at refl(clamp(q) +- 1), in derivs' expressions;
//   4. each thread forms J of its LT_TH / 8 pixels of a column from the g
//      tile.
// Clamp first, then reflect, each once and in image coordinates: for h, w
// >= 2 every coordinate read lies in the staged ring (reflecting a
// reflected -2 would leave a 2-wide image). The wrapper refuses a smaller
// level; the pyramid makes none (pyramid.py: max_warp_level). Every value
// is the same log1pf of the same float and the same expression as in the
// plain version, so the kernel is bitwise equal to it where log1pf rounds
// as torch.log1p does. Over output rows lo .. hi - 1 the tiles start at row
// lo, and step 1 stages only rows max(0, lo - 2) .. min(h, hi + 2) - 1:
// every row that an output of the range reads through the clamp and the
// reflect (the rest of a tile's staged entries are never read).
// Bound: bytes, 2 planes read and 5 written.
constexpr int LT_TH = 16;                         // tile rows, LT_TH / BY a thread
constexpr int LT_RW = BX + 4, LT_RH = LT_TH + 4;  // the log tile: the tile + 2 rings
constexpr int LT_GW = BX + 2, LT_GH = LT_TH + 2;  // the g tile: + 1 ring

__global__ void __launch_bounds__(BX * BY)
    level_tensor_log_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                            float* __restrict__ J, int h, int w, int lo, int hi, float div4hx,
                            float div4hy, float hx_1, float hy_1) {
  // ls[p][r][c] = log1pf of frame p at image (y0 - 2 + r, x0 - 2 + c)
  __shared__ float ls[2][LT_RH][LT_RW];
  // gs[p][r][c] = g_p at image (clamp(y0 - 1 + r), clamp(x0 - 1 + c))
  __shared__ float gs[3][LT_GH][LT_GW];
  const int x0 = blockIdx.x * BX, y0 = lo + blockIdx.y * LT_TH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int sy0 = max(0, lo - 2), sy1 = min(h, hi + 2);  // the rows the range reads

  for (int i = tid; i < LT_RH * LT_RW; i += BX * BY) {
    const int r = i / LT_RW, c = i % LT_RW;
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    if (gy >= sy0 && gy < sy1 && gx >= 0 && gx < w) {
      const size_t g = (size_t)gy * w + gx;
      tf_body::cp_async4(&ls[0][r][c], f0 + g);
      tf_body::cp_async4(&ls[1][r][c], f1 + g);
    }
  }
  tf_body::cp_async_wait_all();
  // each thread takes log1pf of the entries it copied itself
  for (int i = tid; i < LT_RH * LT_RW; i += BX * BY) {
    const int r = i / LT_RW, c = i % LT_RW;
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    if (gy >= sy0 && gy < sy1 && gx >= 0 && gx < w) {
      ls[0][r][c] = log1pf(ls[0][r][c]);
      ls[1][r][c] = log1pf(ls[1][r][c]);
    }
  }
  __syncthreads();

  for (int i = tid; i < LT_GH * LT_GW; i += BX * BY) {
    const int r = i / LT_GW, c = i % LT_GW;
    const int qy = y0 - 1 + r, qx = x0 - 1 + c;
    if (qy > h || qx > w) continue;  // beyond the ring of the image's last row or column
    const int py = clamp_idx(qy, h), px = clamp_idx(qx, w);
    // the reflect neighbours of (py, px), as offsets into the log tile
    const int cy = py - y0 + 2, cx = px - x0 + 2;
    const int xp = refl(px + 1, w) - x0 + 2, xm = refl(px - 1, w) - x0 + 2;
    const int yp = refl(py + 1, h) - y0 + 2, ym = refl(py - 1, h) - y0 + 2;
    gs[0][r][c] = (ls[0][cy][xp] - ls[0][cy][xm] + ls[1][cy][xp] - ls[1][cy][xm]) / div4hx;
    gs[1][r][c] = (ls[0][yp][cx] - ls[0][ym][cx] + ls[1][yp][cx] - ls[1][ym][cx]) / div4hy;
    gs[2][r][c] = ls[1][cy][cx] - ls[0][cy][cx];
  }
  __syncthreads();

  const int x = x0 + tx;
  if (x >= w) return;
#pragma unroll
  for (int j = 0; j < LT_TH / BY; ++j) {
    const int r = ty + BY * j, y = y0 + r;
    if (y >= hi) return;
    float g[4][3];  // at x+1, x-1, y+1, y-1: g tile entries (r+1, tx+2), (r+1, tx), ...
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      g[0][p] = gs[p][r + 1][tx + 2];
      g[1][p] = gs[p][r + 1][tx];
      g[2][p] = gs[p][r + 2][tx + 1];
      g[3][p] = gs[p][r][tx + 1];
    }
    tensor_from(g[0], g[1], g[2], g[3], hx_1, hy_1, J, (size_t)h * w, y * w + x);
  }
}

// ---------------------------------------------------------------------------
// outer_prologue: phi, ksi and the per-outer hoists (level_fused.py:343-393),
// one tf_body::prologue_tile per block. With TENSOR (gradient and log) the
// hoists take J from level_tensor; ksi stays grey.
// Bound: bytes. 7 planes read (T x2, u, v, fx, fy, ft), plus 5 of J with
// TENSOR, 9 written. phi is the costly part of the arithmetic (4 divides, a
// sqrt and a reciprocal): evaluated at a pixel and at its four neighbours it
// held this kernel at 0.60-0.66 of its byte bound on an H100, so the tile
// body computes it once per pixel in shared memory, as the TPU kernel
// computed it once as a field and shifted it (level_fused.py:343-366). The
// tile is 32 x 8, so the pyramid's small levels still give the card many
// blocks. An earlier 32 x 32 tile, 4 rows per thread, that staged only T
// read level 0 of a 4K pair no faster (PERF.md).
// ---------------------------------------------------------------------------
constexpr int PRO_TW = 32;  // tile width: one thread per column
constexpr int PRO_THREADS = PRO_TW * tf_body::PRO_TH;

template <bool TENSOR>
__global__ void __launch_bounds__(PRO_THREADS, 6)
    outer_prologue_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                          const float* __restrict__ fxyz, const float* __restrict__ J,
                          float* __restrict__ hoist, int h, int w, int gy0, int gh,
                          float div2hx, float div2hy, float alpha_hx2, float alpha_hy2,
                          float e_s2, float e_d2) {
  __shared__ tf_body::ProTile<PRO_TW, TENSOR> sm;
  tf_body::prologue_tile<PRO_TW, TENSOR>(sm, T, uv, fxyz, J, hoist, blockIdx.x * PRO_TW,
                                         blockIdx.y * tf_body::PRO_TH, h, w, gy0, gh, div2hx,
                                         div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2);
}

dim3 prologue_grid(int h, int w) {
  return dim3((w + PRO_TW - 1) / PRO_TW, (h + tf_body::PRO_TH - 1) / tf_body::PRO_TH);
}

// ---------------------------------------------------------------------------
// jacobi_sweep: one coupled T-form sweep (sweep_core.py:45-79), new_du then
// new_dv from the fresh new_du, storing T' = u + new_d (level_fused.py:328-341);
// the body tf_body::sweep_px. Ping-pong: reads T, writes T_out.
// Bound: 15 planes read (T x2 as a 5-point stencil, u, v, 9 hoists), 2 written.
// ---------------------------------------------------------------------------
__global__ void jacobi_sweep_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                                    const float* __restrict__ hoist, float* __restrict__ T_out,
                                    int h, int w) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  tf_body::sweep_px(T, uv, hoist, T_out, y, x, h, w);
}

// ---------------------------------------------------------------------------
// jacobi_sweeps: the inner loop of one outer iteration, K <= KS_KMAX coupled
// sweeps of fixed uv and hoists in one launch, one tf_body::ksweep_region
// per block (its design is there). Every sweep of every pixel is
// tf_body::sweep_vals on the operands K chained launches of
// jacobi_sweep_kernel give it, so the result is theirs, bit for bit.
// Bound: bytes. The function reads 13 planes once (T x2, u, v, 9 hoists) and
// writes 2; K chained one-sweep launches move 17 planes each. Its arithmetic
// (K x 47 float32 instructions per pixel) is below the byte bound, but with
// the recompute and the shared-memory traffic, indexing and barriers around
// it, instruction issue is what this design spends most time on.
// ---------------------------------------------------------------------------
using tf_body::KS_KMAX;
using tf_body::KS_RH;
using tf_body::KS_RW;
using tf_body::KS_TY;

template <int K>
__global__ void __launch_bounds__(tf_body::KS_THREADS, 2)
    jacobi_sweeps_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                         const float* __restrict__ hoist, float* __restrict__ T_out, int h,
                         int w) {
  __shared__ float ts[tf_body::KS_SHARED];
  tf_body::ksweep_region<K>(ts, T, uv, hoist, T_out, blockIdx.x * (KS_RW - 2 * K),
                            blockIdx.y * (KS_RH - 2 * K), h, w);
}

template <int K>
int launch_sweeps(const float* T, const float* uv, const float* hoist, float* T_out, int h,
                  int w, cudaStream_t stream) {
  constexpr int TW = KS_RW - 2 * K, TH = KS_RH - 2 * K;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  jacobi_sweeps_kernel<K><<<grid, dim3(KS_RW, KS_TY), 0, stream>>>(T, uv, hoist, T_out, h, w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// add_median: u + (T - u) (the XLA op order, level_fused.py:433-435), then
// the R x R window median with reflect boundaries (median_2d.cu:87-299).
// Bound: operations at R = 5 (the selection's min and max), bytes at R = 3.
// Design: a 32 x 8 block copies T and u over its tile plus an R/2-pixel
// ring, each entry from its reflected image coordinate, into shared memory
// by cp.async, and forms the sum once per staged pixel. Each thread then
// reads its window from the shared tile and selects the median with a
// compare-exchange network: Paeth's 19 exchanges for 9 values, Devillard's
// 99 for 25 (TF_MEDIAN_9 and TF_MEDIAN_25 below, the one place they are
// written; tests/test_torch_median.py reads them there and proves by the 0-1
// principle that each selects the median). 49 values run the odd-even
// transposition sort. Min and max are exact, so any exact selection returns
// the value of the plain version's sort, bit for bit.
// Needs min(h, w) > R/2, where one reflection stays in the image; the plain
// version's reflect padding has the same limit. Over output rows lo .. hi - 1
// the blocks start at row lo and stage only the entries whose unreflected
// row lies in lo - R/2 .. hi - 1 + R/2, the rows the range's windows read.
// ---------------------------------------------------------------------------
// (i, j): min to a[i], max to a[j]; the median is then a[4], resp. a[12].
#define TF_MEDIAN_9(X)                                                                    \
  X(1, 2) X(4, 5) X(7, 8) X(0, 1) X(3, 4) X(6, 7) X(1, 2) X(4, 5) X(7, 8) X(0, 3) X(5, 8) \
  X(4, 7) X(3, 6) X(1, 4) X(2, 5) X(4, 7) X(4, 2) X(6, 4) X(4, 2)
#define TF_MEDIAN_25(X)                                                                    \
  X(0, 1) X(3, 4) X(2, 4) X(2, 3) X(6, 7) X(5, 7) X(5, 6) X(9, 10) X(8, 10) X(8, 9)        \
  X(12, 13) X(11, 13) X(11, 12) X(15, 16) X(14, 16) X(14, 15) X(18, 19) X(17, 19)          \
  X(17, 18) X(21, 22) X(20, 22) X(20, 21) X(23, 24) X(2, 5) X(3, 6) X(0, 6) X(0, 3)        \
  X(4, 7) X(1, 7) X(1, 4) X(11, 14) X(8, 14) X(8, 11) X(12, 15) X(9, 15) X(9, 12)          \
  X(13, 16) X(10, 16) X(10, 13) X(20, 23) X(17, 23) X(17, 20) X(21, 24) X(18, 24)          \
  X(18, 21) X(19, 22) X(8, 17) X(9, 18) X(0, 18) X(0, 9) X(10, 19) X(1, 19) X(1, 10)       \
  X(11, 20) X(2, 20) X(2, 11) X(12, 21) X(3, 21) X(3, 12) X(13, 22) X(4, 22) X(4, 13)      \
  X(14, 23) X(5, 23) X(5, 14) X(15, 24) X(6, 24) X(6, 15) X(7, 16) X(7, 19) X(13, 21)      \
  X(15, 23) X(7, 13) X(7, 15) X(1, 9) X(3, 11) X(5, 17) X(11, 17) X(9, 17) X(4, 10)        \
  X(6, 12) X(7, 14) X(4, 6) X(4, 7) X(12, 14) X(10, 14) X(6, 7) X(10, 12) X(6, 10)         \
  X(6, 17) X(12, 17) X(7, 17) X(7, 10) X(12, 18) X(7, 12) X(10, 18) X(12, 20) X(10, 20)    \
  X(10, 12)
#define TF_CX(i, j)                         \
  {                                         \
    const float lo_ = fminf(a[i], a[j]);    \
    const float hi_ = fmaxf(a[i], a[j]);    \
    a[i] = lo_;                             \
    a[j] = hi_;                             \
  }

template <int R>
__device__ __forceinline__ float select_median(float (&a)[R * R]) {
  constexpr int N = R * R;
  if constexpr (R == 3) {
    TF_MEDIAN_9(TF_CX)
  } else if constexpr (R == 5) {
    TF_MEDIAN_25(TF_CX)
  } else {
#pragma unroll
    for (int pass = 0; pass < N; ++pass) {
#pragma unroll
      for (int k = pass & 1; k + 1 < N; k += 2) TF_CX(k, k + 1)
    }
  }
  return a[N / 2];
}

template <int R>
__global__ void add_median_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                                  float* __restrict__ out, int h, int w, int lo, int hi) {
  constexpr int R2 = R / 2, SW = BX + 2 * R2, SH = BY + 2 * R2;
  // st[p][r][c]: plane p of T, then of the sum, at image coordinate
  // (refl(y0 - R2 + r), refl(x0 - R2 + c)); su: the same of u.
  __shared__ float st[2][SH][SW];
  __shared__ float su[2][SH][SW];
  const int x0 = blockIdx.x * BX, y0 = lo + blockIdx.y * BY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const size_t n = (size_t)h * w;
  for (int i = tid; i < SH * SW; i += BX * BY) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - R2 + r, gx = x0 - R2 + c;
    if (gy >= hi + R2 || gx > w - 1 + R2) continue;  // beyond the range's or the last column's ring
    const size_t g = (size_t)refl(gy, h) * w + refl(gx, w);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      tf_body::cp_async4(&st[p][r][c], T + p * n + g);
      tf_body::cp_async4(&su[p][r][c], uv + p * n + g);
    }
  }
  tf_body::cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < SH * SW; i += BX * BY) {
    const int r = i / SW, c = i % SW;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float base = su[p][r][c];
      st[p][r][c] = base + (st[p][r][c] - base);
    }
  }
  __syncthreads();
  const int x = x0 + tx, y = y0 + ty;
  if (x >= w || y >= hi) return;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float a[R * R];
#pragma unroll
    for (int dy = 0; dy < R; ++dy) {
#pragma unroll
      for (int dx = 0; dx < R; ++dx) a[dy * R + dx] = st[p][ty + dy][tx + dx];
    }
    out[p * n + y * w + x] = select_median<R>(a);
  }
}

}  // namespace

extern "C" {

const char* tf_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// [lo, hi): the output rows of warp, level_derivs, level_tensor and
// add_median (0, h for the whole level).
int tf_warp(const float* f0, const float* f1, const float* uv, float* out, int h, int w,
            int lo, int hi, float inv_hx, float inv_hy, void* stream) {
  if (bad_rows(lo, hi, h)) return (int)cudaErrorInvalidValue;
  warp_kernel<<<grid_for(hi - lo, w), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      f0, f1, uv, out, h, w, lo, hi, inv_hx, inv_hy);
  return (int)cudaGetLastError();
}

int tf_level_derivs(const float* f0, const float* f1, float* fxyz, int h, int w, int lo,
                    int hi, float div4hx, float div4hy, void* stream) {
  if (bad_rows(lo, hi, h)) return (int)cudaErrorInvalidValue;
  level_derivs_kernel<<<grid_for(hi - lo, w), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      f0, f1, fxyz, h, w, lo, hi, div4hx, div4hy);
  return (int)cudaGetLastError();
}

// log: 0 for the gradient tensor (reads fxyz), 1 for the log-derivative one
// (reads f0 and f1; h, w >= 2).
int tf_level_tensor(const float* f0, const float* f1, const float* fxyz, float* J, int h,
                    int w, int lo, int hi, float div4hx, float div4hy, float hx_1, float hy_1,
                    int log, void* stream) {
  if (bad_rows(lo, hi, h)) return (int)cudaErrorInvalidValue;
  const dim3 block(BX, BY);
  cudaStream_t s = (cudaStream_t)stream;
  if (log) {
    if (h < 2 || w < 2) return (int)cudaErrorInvalidValue;
    level_tensor_log_kernel<<<dim3((w + BX - 1) / BX, (hi - lo + LT_TH - 1) / LT_TH), block, 0,
                              s>>>(f0, f1, J, h, w, lo, hi, div4hx, div4hy, hx_1, hy_1);
  } else {
    level_tensor_kernel<<<grid_for(hi - lo, w), block, 0, s>>>(fxyz, J, h, w, lo, hi, hx_1,
                                                                hy_1);
  }
  return (int)cudaGetLastError();
}

// The h rows are rows gy0 .. gy0 + h - 1 of a level gh rows high (a shard's
// padded block; gy0 = 0, gh = h for a whole level): the free-boundary
// weights take the level's rows, the mirror boundary the block's.
int tf_outer_prologue(const float* T, const float* uv, const float* fxyz, float* hoist,
                      int h, int w, int gy0, int gh, float div2hx, float div2hy,
                      float alpha_hx2, float alpha_hy2, float e_s2, float e_d2, void* stream) {
  outer_prologue_kernel<false>
      <<<prologue_grid(h, w), dim3(PRO_TW, tf_body::PRO_TH), 0, (cudaStream_t)stream>>>(
          T, uv, fxyz, nullptr, hoist, h, w, gy0, gh, div2hx, div2hy, alpha_hx2, alpha_hy2,
          e_s2, e_d2);
  return (int)cudaGetLastError();
}

int tf_outer_prologue_tensor(const float* T, const float* uv, const float* fxyz,
                             const float* J, float* hoist, int h, int w, int gy0, int gh,
                             float div2hx, float div2hy, float alpha_hx2, float alpha_hy2,
                             float e_s2, float e_d2, void* stream) {
  outer_prologue_kernel<true>
      <<<prologue_grid(h, w), dim3(PRO_TW, tf_body::PRO_TH), 0, (cudaStream_t)stream>>>(
          T, uv, fxyz, J, hoist, h, w, gy0, gh, div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2,
          e_d2);
  return (int)cudaGetLastError();
}

int tf_jacobi_sweep(const float* T, const float* uv, const float* hoist, float* T_out,
                    int h, int w, void* stream) {
  jacobi_sweep_kernel<<<grid_for(h, w), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      T, uv, hoist, T_out, h, w);
  return (int)cudaGetLastError();
}

// k: the sweeps of this launch, 1..KS_KMAX.
int tf_jacobi_sweeps(const float* T, const float* uv, const float* hoist, float* T_out,
                     int h, int w, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch_sweeps<1>(T, uv, hoist, T_out, h, w, s);
    case 2: return launch_sweeps<2>(T, uv, hoist, T_out, h, w, s);
    case 3: return launch_sweeps<3>(T, uv, hoist, T_out, h, w, s);
    case 4: return launch_sweeps<4>(T, uv, hoist, T_out, h, w, s);
    case 5: return launch_sweeps<5>(T, uv, hoist, T_out, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// radius: the window side after the reference guards (1, 3, 5 or 7).
int tf_add_median(const float* T, const float* uv, float* out, int h, int w, int lo, int hi,
                  int radius, void* stream) {
  if (bad_rows(lo, hi, h)) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_for(hi - lo, w), block(BX, BY);
  cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 1: add_median_kernel<1><<<grid, block, 0, s>>>(T, uv, out, h, w, lo, hi); break;
    case 3: add_median_kernel<3><<<grid, block, 0, s>>>(T, uv, out, h, w, lo, hi); break;
    case 5: add_median_kernel<5><<<grid, block, 0, s>>>(T, uv, out, h, w, lo, hi); break;
    case 7: add_median_kernel<7><<<grid, block, 0, s>>>(T, uv, out, h, w, lo, hi); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
