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
// warp, level_derivs, level_tensor and jacobi_sweep are one thread per pixel
// over 32x8 blocks. Each reads a few neighbouring floats and does ~1 FLOP per
// byte, so device-memory bandwidth bounds them at fine levels and launch
// latency at coarse ones; neighbour reuse comes from L1/L2, not shared
// memory. outer_prologue, jacobi_sweeps and add_median stage their stencil
// input in shared-memory tiles (their comments say why).
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

// ---------------------------------------------------------------------------
// warp: replaces the in-kernel shift-sum (level_fused.py:179-243), the XLA
// widened tier and the exact gather (bucketed.py:236-361). The TPU needed
// the tiers because its gathers run on the scalar unit; here one exact
// 4-tap gather serves every displacement.
// Bound: 4 scattered reads of f1 per pixel (L2 serves them for small flow).
// ---------------------------------------------------------------------------
__global__ void warp_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                            const float* __restrict__ uv, float* __restrict__ out,
                            int h, int w, float inv_hx, float inv_hy) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
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
                                    float* __restrict__ fxyz, int h, int w,
                                    float div4hx, float div4hy) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w;
  const int c = y * w + x;
  const int xp = y * w + refl(x + 1, w), xm = y * w + refl(x - 1, w);
  const int yp = refl(y + 1, h) * w + x, ym = refl(y - 1, h) * w + x;
  fxyz[c] = (f0[xp] - f0[xm] + f1[xp] - f1[xm]) / div4hx;
  fxyz[n + c] = (f0[yp] - f0[ym] + f1[yp] - f1[ym]) / div4hy;
  fxyz[2 * n + c] = f1[c] - f0[c];
}

// ---------------------------------------------------------------------------
// level_tensor: the second-order motion tensor of the gradient (LOG=false)
// and log-derivative (LOG=true) data terms, once per level
// (level_fused.py:291-322, bucketed.py:422-444, reference solve_2d.cu:798-884).
// The first-derivative fields g = (gx, gy, gt) are the grey fxyz for
// gradient; for log they are the same reflect stencil over log1pf of the
// frames, recomputed here at each of the four clamped neighbours. The
// second differences multiply by the host-rounded hx_1 = f32(1/(2h)).
// Bound: gradient reads 10 neighbouring floats of fxyz, log 4 x 6 frame
// values through log1pf; 5 planes written. Once per level: never the
// bottleneck next to 240 sweeps and prologues.
// ---------------------------------------------------------------------------
template <bool LOG>
__device__ __forceinline__ void derivs_at(const float* __restrict__ f0,
                                          const float* __restrict__ f1,
                                          const float* __restrict__ fxyz, size_t n, int y,
                                          int x, int h, int w, float div4hx, float div4hy,
                                          float g[3]) {
  const int c = y * w + x;
  if constexpr (LOG) {
    const int xp = y * w + refl(x + 1, w), xm = y * w + refl(x - 1, w);
    const int yp = refl(y + 1, h) * w + x, ym = refl(y - 1, h) * w + x;
    g[0] = (log1pf(f0[xp]) - log1pf(f0[xm]) + log1pf(f1[xp]) - log1pf(f1[xm])) / div4hx;
    g[1] = (log1pf(f0[yp]) - log1pf(f0[ym]) + log1pf(f1[yp]) - log1pf(f1[ym])) / div4hy;
    g[2] = log1pf(f1[c]) - log1pf(f0[c]);
  } else {
    g[0] = fxyz[c];
    g[1] = fxyz[n + c];
    g[2] = fxyz[2 * n + c];
  }
}

template <bool LOG>
__global__ void level_tensor_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                                    const float* __restrict__ fxyz, float* __restrict__ J,
                                    int h, int w, float div4hx, float div4hy, float hx_1,
                                    float hy_1) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w;
  const int c = y * w + x;
  float g_xp[3], g_xm[3], g_yp[3], g_ym[3];
  derivs_at<LOG>(f0, f1, fxyz, n, y, clamp_idx(x + 1, w), h, w, div4hx, div4hy, g_xp);
  derivs_at<LOG>(f0, f1, fxyz, n, y, clamp_idx(x - 1, w), h, w, div4hx, div4hy, g_xm);
  derivs_at<LOG>(f0, f1, fxyz, n, clamp_idx(y + 1, h), x, h, w, div4hx, div4hy, g_yp);
  derivs_at<LOG>(f0, f1, fxyz, n, clamp_idx(y - 1, h), x, h, w, div4hx, div4hy, g_ym);
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

// ---------------------------------------------------------------------------
// outer_prologue: phi, ksi and the per-outer hoists (level_fused.py:343-393).
// With TENSOR (gradient and log) the hoists take J from level_tensor; ksi
// stays grey.
// Bound: bytes. 7 planes read (T x2, u, v, fx, fy, ft), plus 5 of J with
// TENSOR, 9 written. phi is the costly part of the arithmetic (4 divides, a
// sqrt and a reciprocal): evaluated at a pixel and at its four neighbours,
// as tf_body::prologue_px does, it held this kernel at 0.60-0.66 of its byte
// bound on an H100. So phi is computed once per pixel, as the TPU kernel
// computed it once as a field and shifted it (level_fused.py:343-366):
//   1. a block of one thread per pixel owns a PRO_TW x PRO_TH tile and
//      copies into shared memory, with cp.async and all at once, the two T
//      planes over the tile plus a 2-pixel ring and the tile of every plane
//      it reads once (u, v, fx, fy, ft and J): one wait for device memory
//      per block, with the tile's whole input in flight. The copies are 4
//      bytes each: a row of a level is rarely 16-byte aligned;
//   2. it evaluates tf_body::phi_of over the tile plus a 1-pixel ring into a
//      second shared tile (1.33 evaluations per pixel);
//   3. each thread forms its pixel's hoists with tf_body::hoists_px and
//      writes them, coalesced along the row.
// The tile is 8 rows tall, so the pyramid's small levels still give the card
// many blocks. An earlier 32 x 32 tile, 4 rows per thread, that staged only
// T read level 0 of a 4K pair no faster (PERF.md).
// The mirror rule: phi tile entry q holds phi at image coordinate refl(q),
// for q in [-1, n] (one reflection stays in the image for n >= 2), and its
// T neighbours are refl(refl(q) +- 1) in image coordinates, which the T tile
// holds at that coordinate's own offset. So no coordinate is reflected
// twice: with w = 2, refl(-2) = 2 would leave the image. Every value is then
// the one prologue_px computes, in the same association, bitwise.
// ---------------------------------------------------------------------------
constexpr int PRO_TW = 32;                   // tile width: one thread per column
constexpr int PRO_TH = 8;                    // tile height: one thread per row
constexpr int PRO_THREADS = PRO_TW * PRO_TH;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <bool TENSOR>
__global__ void __launch_bounds__(PRO_THREADS, 6)
    outer_prologue_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                          const float* __restrict__ fxyz, const float* __restrict__ J,
                          float* __restrict__ hoist, int h, int w, float div2hx, float div2hy,
                          float alpha_hx2, float alpha_hy2, float e_s2, float e_d2) {
  constexpr int NS = TENSOR ? 10 : 5;  // planes read once: u, v, fx, fy, ft (, J x5)
  // ts[p][r][c] = plane p of T at image (y0 - 2 + r, x0 - 2 + c), where that
  // lies in the image; ps[r][c] = phi at (refl(y0 - 1 + r), refl(x0 - 1 + c));
  // ss[p][r][c] = plane p at (y0 + r, x0 + c).
  __shared__ float ts[2][PRO_TH + 4][PRO_TW + 4];
  __shared__ float ps[PRO_TH + 2][PRO_TW + 2];
  __shared__ float ss[NS][PRO_TH][PRO_TW];
  const int x0 = blockIdx.x * PRO_TW, y0 = blockIdx.y * PRO_TH;
  const int tx = threadIdx.x, ty = threadIdx.y, x = x0 + tx, y = y0 + ty;
  const bool inside = x < w && y < h;
  const size_t n = (size_t)h * w;

  for (int i = ty * PRO_TW + tx; i < (PRO_TH + 4) * (PRO_TW + 4); i += PRO_THREADS) {
    const int r = i / (PRO_TW + 4), c = i % (PRO_TW + 4);
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t g = (size_t)gy * w + gx;
      cp_async4(&ts[0][r][c], T + g);
      cp_async4(&ts[1][r][c], T + n + g);
    }
  }
  if (inside) {
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const float* src = p < 2 ? uv + p * n : (p < 5 ? fxyz + (p - 2) * n : J + (p - 5) * n);
      cp_async4(&ss[p][ty][tx], src + (size_t)y * w + x);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int i = ty * PRO_TW + tx; i < (PRO_TH + 2) * (PRO_TW + 2); i += PRO_THREADS) {
    const int r = i / (PRO_TW + 2), c = i % (PRO_TW + 2);
    const int qy = y0 - 1 + r, qx = x0 - 1 + c;
    if (qy > h || qx > w) continue;  // beyond the ring of the image's last row or column
    const int py = refl(qy, h), px = refl(qx, w);
    // phi_at's neighbours of (py, px), as offsets into the T tile
    const int cy = py - y0 + 2, cx = px - x0 + 2;
    const int xp = refl(px + 1, w) - x0 + 2, xm = refl(px - 1, w) - x0 + 2;
    const int yp = refl(py + 1, h) - y0 + 2, ym = refl(py - 1, h) - y0 + 2;
    ps[r][c] = tf_body::phi_of(ts[0][cy][xp], ts[0][cy][xm], ts[0][yp][cx], ts[0][ym][cx],
                               ts[1][cy][xp], ts[1][cy][xm], ts[1][yp][cx], ts[1][ym][cx],
                               div2hx, div2hy, e_s2);
  }
  __syncthreads();

  if (!inside) return;
  tf_body::PixelPlanes planes{ss[0][ty][tx], ss[1][ty][tx], ss[2][ty][tx], ss[3][ty][tx],
                              ss[4][ty][tx]};
  if constexpr (TENSOR) {
    planes.j11 = ss[5][ty][tx];
    planes.j22 = ss[6][ty][tx];
    planes.j12 = ss[7][ty][tx];
    planes.j13 = ss[8][ty][tx];
    planes.j23 = ss[9][ty][tx];
  }
  tf_body::hoists_px<TENSOR>(ps[ty + 1][tx + 1], ps[ty + 1][tx + 2], ps[ty + 1][tx],
                             ps[ty + 2][tx + 1], ps[ty][tx + 1], ts[0][ty + 2][tx + 2],
                             ts[1][ty + 2][tx + 2], planes, hoist, n, y * w + x, x, w, y, h,
                             alpha_hx2, alpha_hy2, e_d2);
}

dim3 prologue_grid(int h, int w) {
  return dim3((w + PRO_TW - 1) / PRO_TW, (h + PRO_TH - 1) / PRO_TH);
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
// sweeps of fixed uv and hoists in one launch. Every sweep of every pixel is
// tf_body::sweep_vals on the operands K chained launches of
// jacobi_sweep_kernel give it, so the result is theirs, bit for bit.
// Bound: bytes. The function reads 13 planes once (T x2, u, v, 9 hoists) and
// writes 2; K chained one-sweep launches move 17 planes each. Its arithmetic
// (K x 47 float32 instructions per pixel) is below the byte bound, but with
// the recompute below and the shared-memory traffic, indexing and barriers
// around it, instruction issue is what this design spends most time on.
// Design:
//   * a block of KS_RW x KS_TY threads owns a region of KS_RW x KS_RH
//     pixels: its output tile, (KS_RW - 2K) x (KS_RH - 2K), plus a K-pixel
//     ring, at image coordinates (blockIdx * tile - K), clipped to the
//     image. Each thread owns one column of KS_RH / KS_TY region pixels
//     (rows ty, ty + KS_TY, ...), so a warp touches 32 consecutive floats of
//     a row. T's two buffers take 32 KB of shared memory, below the 48 KB a
//     launch gets without opting in;
//   * T's two planes over the region are copied into shared memory by
//     cp.async, 4 bytes each: rows of most levels are not 16-byte aligned,
//     and TMA's tensor maps need 16-byte global strides, which widths such
//     as 3111 do not have. u, v and the 9 hoists are read only at a pixel's
//     own thread, and only where the first sweep updates: each thread loads
//     its pixels' into registers;
//   * sweep s = 1..K reads T from one shared buffer and writes the other,
//     over the region shrunk by s on every side that is not an image edge
//     (the trapezoid). At an image edge the mirror neighbour refl(+-1) lies
//     inside the region and holds the same sweep's value, so no pixel reads
//     a value the chained launches would not give it;
//   * after sweep K the tile's own pixels are written to device memory.
// At K = 5 the ring costs 64 x 32 / (54 x 22) = 1.7x the tile's
// T bytes (neighbouring blocks read the overlap, mostly from L2) and the
// trapezoid 1.3x the tile's sweeps.
// ---------------------------------------------------------------------------
constexpr int KS_KMAX = 5;     // sweeps per launch (ops/level.py: KMAX)
constexpr int KS_RW = 64;      // region columns, one thread each (ops/level.py: KSWEEP_RW)
constexpr int KS_TY = 8;       // thread rows
constexpr int KS_RH = 32;      // region rows (ops/level.py: KSWEEP_RH)
constexpr int KS_THREADS = KS_RW * KS_TY;

template <int K>
__global__ void __launch_bounds__(KS_THREADS, 2)
    jacobi_sweeps_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                         const float* __restrict__ hoist, float* __restrict__ T_out, int h,
                         int w) {
  static_assert(K >= 1 && K <= KS_KMAX && KS_RH % KS_TY == 0 && KS_RH > 2 * K,
                "bad k-sweep geometry");
  constexpr int TW = KS_RW - 2 * K, TH = KS_RH - 2 * K;
  constexpr int P = KS_RH / KS_TY;        // region pixels per thread
  constexpr int PLANE = KS_RH * KS_RW;    // floats of one shared plane
  // ts: [buffer][plane][row][col] of T
  __shared__ float ts[4 * PLANE];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int rx0 = blockIdx.x * TW - K, ry0 = blockIdx.y * TH - K;  // region origin
  const size_t n = (size_t)h * w;
  // A side of the region shrinks by one pixel a sweep unless it is an image
  // edge; the region's first and last columns and rows inside the image.
  const bool shrink_l = rx0 > 0, shrink_r = rx0 + KS_RW - 1 < w - 1;
  const bool shrink_t = ry0 > 0, shrink_b = ry0 + KS_RH - 1 < h - 1;
  const int c_first = max(0, -rx0), c_last = min(KS_RW - 1, w - 1 - rx0);
  const int r_first = max(0, -ry0), r_last = min(KS_RH - 1, h - 1 - ry0);
  const int gx = rx0 + tx;
  // the mirror neighbours of column tx, as region columns
  const int xp = gx == w - 1 ? tx - 1 : tx + 1;
  const int xm = gx == 0 ? tx + 1 : tx - 1;

  tf_body::SweepConsts kc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int r = ty + KS_TY * j, gy = ry0 + r;
    if (tx < c_first || tx > c_last || r < r_first || r > r_last) continue;
    const size_t g = (size_t)gy * w + gx;
    const int i = r * KS_RW + tx;
    cp_async4(&ts[i], T + g);
    cp_async4(&ts[PLANE + i], T + n + g);
    // u, v and the hoists only where the first sweep updates
    const bool first = tx >= (shrink_l ? 1 : c_first) && tx <= (shrink_r ? KS_RW - 2 : c_last) &&
                       r >= (shrink_t ? 1 : r_first) && r <= (shrink_b ? KS_RH - 2 : r_last);
    if (first) kc[j] = tf_body::load_sweep_consts(uv, hoist, n, (int)g);
  }
  cp_async_wait_all();
  __syncthreads();

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    const float* tu = ts + ((s - 1) & 1) * 2 * PLANE;
    const float* tv = tu + PLANE;
    float* dst = ts + (s & 1) * 2 * PLANE;
    const bool col_ok = tx >= (shrink_l ? s : c_first) && tx <= (shrink_r ? KS_RW - 1 - s : c_last);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int r = ty + KS_TY * j, gy = ry0 + r;
      if (!col_ok || r < (shrink_t ? s : r_first) || r > (shrink_b ? KS_RH - 1 - s : r_last))
        continue;
      const int i = r * KS_RW + tx;
      const int row = r * KS_RW;
      const int yp = (gy == h - 1 ? r - 1 : r + 1) * KS_RW + tx;
      const int ym = (gy == 0 ? r + 1 : r - 1) * KS_RW + tx;
      const float2 t = tf_body::sweep_vals(kc[j], tu[row + xp], tu[row + xm], tu[yp], tu[ym],
                                           tv[row + xp], tv[row + xm], tv[yp], tv[ym], tv[i]);
      dst[i] = t.x;
      dst[PLANE + i] = t.y;
    }
    __syncthreads();
  }

  // the tile: region columns and rows [K, size - K), inside the image
  if (tx < K || tx >= KS_RW - K || gx >= w) return;
  const float* fin = ts + (K & 1) * 2 * PLANE;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int r = ty + KS_TY * j, gy = ry0 + r;
    if (r < K || r >= KS_RH - K || gy >= h) continue;
    const size_t g = (size_t)gy * w + gx;
    T_out[g] = fin[r * KS_RW + tx];
    T_out[n + g] = fin[PLANE + r * KS_RW + tx];
  }
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
// version's reflect padding has the same limit.
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
                                  float* __restrict__ out, int h, int w) {
  constexpr int R2 = R / 2, SW = BX + 2 * R2, SH = BY + 2 * R2;
  // st[p][r][c]: plane p of T, then of the sum, at image coordinate
  // (refl(y0 - R2 + r), refl(x0 - R2 + c)); su: the same of u.
  __shared__ float st[2][SH][SW];
  __shared__ float su[2][SH][SW];
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const size_t n = (size_t)h * w;
  for (int i = tid; i < SH * SW; i += BX * BY) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - R2 + r, gx = x0 - R2 + c;
    if (gy > h - 1 + R2 || gx > w - 1 + R2) continue;  // beyond the last row's or column's ring
    const size_t g = (size_t)refl(gy, h) * w + refl(gx, w);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      cp_async4(&st[p][r][c], T + p * n + g);
      cp_async4(&su[p][r][c], uv + p * n + g);
    }
  }
  cp_async_wait_all();
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
  if (x >= w || y >= h) return;
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

int tf_warp(const float* f0, const float* f1, const float* uv, float* out, int h, int w,
            float inv_hx, float inv_hy, void* stream) {
  warp_kernel<<<grid_for(h, w), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      f0, f1, uv, out, h, w, inv_hx, inv_hy);
  return (int)cudaGetLastError();
}

int tf_level_derivs(const float* f0, const float* f1, float* fxyz, int h, int w,
                    float div4hx, float div4hy, void* stream) {
  level_derivs_kernel<<<grid_for(h, w), dim3(BX, BY), 0, (cudaStream_t)stream>>>(
      f0, f1, fxyz, h, w, div4hx, div4hy);
  return (int)cudaGetLastError();
}

// log: 0 for the gradient tensor (reads fxyz), 1 for the log-derivative one.
int tf_level_tensor(const float* f0, const float* f1, const float* fxyz, float* J, int h,
                    int w, float div4hx, float div4hy, float hx_1, float hy_1, int log,
                    void* stream) {
  const dim3 grid = grid_for(h, w), block(BX, BY);
  cudaStream_t s = (cudaStream_t)stream;
  if (log)
    level_tensor_kernel<true><<<grid, block, 0, s>>>(f0, f1, fxyz, J, h, w, div4hx, div4hy,
                                                     hx_1, hy_1);
  else
    level_tensor_kernel<false><<<grid, block, 0, s>>>(f0, f1, fxyz, J, h, w, div4hx, div4hy,
                                                      hx_1, hy_1);
  return (int)cudaGetLastError();
}

int tf_outer_prologue(const float* T, const float* uv, const float* fxyz, float* hoist,
                      int h, int w, float div2hx, float div2hy, float alpha_hx2,
                      float alpha_hy2, float e_s2, float e_d2, void* stream) {
  outer_prologue_kernel<false>
      <<<prologue_grid(h, w), dim3(PRO_TW, PRO_TH), 0, (cudaStream_t)stream>>>(
          T, uv, fxyz, nullptr, hoist, h, w, div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2);
  return (int)cudaGetLastError();
}

int tf_outer_prologue_tensor(const float* T, const float* uv, const float* fxyz,
                             const float* J, float* hoist, int h, int w, float div2hx,
                             float div2hy, float alpha_hx2, float alpha_hy2, float e_s2,
                             float e_d2, void* stream) {
  outer_prologue_kernel<true>
      <<<prologue_grid(h, w), dim3(PRO_TW, PRO_TH), 0, (cudaStream_t)stream>>>(
          T, uv, fxyz, J, hoist, h, w, div2hx, div2hy, alpha_hx2, alpha_hy2, e_s2, e_d2);
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
int tf_add_median(const float* T, const float* uv, float* out, int h, int w, int radius,
                  void* stream) {
  const dim3 grid = grid_for(h, w), block(BX, BY);
  cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 1: add_median_kernel<1><<<grid, block, 0, s>>>(T, uv, out, h, w); break;
    case 3: add_median_kernel<3><<<grid, block, 0, s>>>(T, uv, out, h, w); break;
    case 5: add_median_kernel<5><<<grid, block, 0, s>>>(T, uv, out, h, w); break;
    case 7: add_median_kernel<7><<<grid, block, 0, s>>>(T, uv, out, h, w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
