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
//   tf_jacobi_sweep           outer x inner   one coupled T-form sweep
//   tf_add_median             once per level  u + (T - u), then the window median
//
// Every field is a contiguous float32 (h, w) plane at the level's exact
// size; stacks are planes back to back. The mirror boundary is reflect
// indexing (neighbour -1 reads 1, neighbour n reads n-2), which is what the
// TPU's ghost rows held in the valid region (tpuflow/ops/solver_ops.py:228-235).
// The one exception is the second-order tensor's stencil over derivative
// fields, which replicates (clamp: neighbour -1 reads 0, n reads n-1).
//
// All kernels but outer_prologue are one thread per pixel over 32x8 blocks.
// Each reads a few neighbouring floats and does ~1 FLOP per byte, so
// device-memory bandwidth bounds them at fine levels and launch latency at
// coarse ones; neighbour reuse comes from L1/L2, not shared memory.
// outer_prologue stages its stencil input and phi in shared-memory tiles
// (its comment says why). Shared-memory k-sweep blocking is later work.
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
// add_median: u + (T - u) (the XLA op order, level_fused.py:433-435), then
// the R x R window median with reflect boundaries (median_2d.cu:87-299).
// The window is sorted in registers by a fully unrolled odd-even
// transposition network: an exact selection, so the result equals the
// TPU's Batcher network. Each thread recomputes the sum at its R*R window
// points instead of storing the summed field.
// Bound: R*R reads of T and u per pixel per plane (L1 serves the overlap).
// ---------------------------------------------------------------------------
template <int R>
__global__ void add_median_kernel(const float* __restrict__ T, const float* __restrict__ uv,
                                  float* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t n = (size_t)h * w;
  constexpr int N = R * R;
  constexpr int R2 = R / 2;
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    const float* t = T + p * n;
    const float* b = uv + p * n;
    float a[N];
#pragma unroll
    for (int dy = 0; dy < R; ++dy) {
      const int row = refl(y + dy - R2, h) * w;
#pragma unroll
      for (int dx = 0; dx < R; ++dx) {
        const int j = row + refl(x + dx - R2, w);
        const float base = b[j];
        a[dy * R + dx] = base + (t[j] - base);
      }
    }
#pragma unroll
    for (int pass = 0; pass < N; ++pass) {
#pragma unroll
      for (int k = pass & 1; k + 1 < N; k += 2) {
        const float lo = a[k + 1] < a[k] ? a[k + 1] : a[k];
        const float hi = a[k + 1] < a[k] ? a[k] : a[k + 1];
        a[k] = lo;
        a[k + 1] = hi;
      }
    }
    out[p * n + y * w + x] = a[N / 2];
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
