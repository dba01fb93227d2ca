// Bodies of the relaxation, shared by the level kernels (level.cu:
// outer_prologue_kernel<TENSOR>, jacobi_sweep_kernel, jacobi_sweeps_kernel<K>)
// and the row-sharded relaxation (sharded.cu: relax_sharded_kernel<TENSOR>),
// so all of them run the same code in the same association order:
//   hoists_px, sweep_vals   the per-pixel arithmetic of a prologue and a sweep
//   sweep_px                one sweep of one pixel from device memory (the
//                           one-sweep twin)
//   prologue_tile           the prologue of one PRO_TH-row tile, phi once per
//                           pixel from a shared-memory tile (prologue_stage,
//                           then prologue_finish)
//   ksweep_region           K <= KS_KMAX sweeps of one KS_RW x KS_RH region in
//                           shared memory
// A tile body takes its tile's origin and its shared memory as arguments; a
// level kernel runs one tile per block, the sharded kernel loops over tiles.
//
// A body works on one block of rows: contiguous float32 (h, w) planes, stacks
// of planes back to back (plane stride n = h * w). The mirror boundary is
// reflect indexing at the block's own edges (neighbour -1 reads 1, neighbour
// h reads h - 2). For a whole level the block is the level; for a shard it is
// the shard's padded rows, which end at the image edge wherever the shard
// touches it, so the image's rule holds there as well. The free-boundary
// weights depend on the pixel's global row gy in a level of gh rows: a body
// takes both extents, the block's h for the mirror and gh for the weights,
// with gy0 the global row of the block's first row.

#pragma once

#include <cuda_runtime.h>

namespace tf_body {

// 4-byte asynchronous copies into shared memory: a row of a level is rarely
// 16-byte aligned, and TMA's tensor maps need 16-byte global strides.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int refl(int i, int n) {
  // Reference mirror: x < 0 -> -x, x >= n -> 2n - x - 2 (solve_2d.cu:75-76).
  return i < 0 ? -i : (i >= n ? 2 * n - i - 2 : i);
}

// phi = 1 / (2 sqrt(|grad T|^2 + e_s^2)) of one pixel from T's values at its
// four neighbours (level_fused.py:348-353).
__device__ __forceinline__ float phi_of(float tu_xp, float tu_xm, float tu_yp, float tu_ym,
                                        float tv_xp, float tv_xm, float tv_yp, float tv_ym,
                                        float div2hx, float div2hy, float e_s2) {
  const float dux = (tu_xp - tu_xm) / div2hx;
  const float duy = (tu_yp - tu_ym) / div2hy;
  const float dvx = (tv_xp - tv_xm) / div2hx;
  const float dvy = (tv_yp - tv_ym) / div2hy;
  const float grad2 = dux * dux + duy * duy + dvx * dvx + dvy * dvy + e_s2;
  return 1.0f / (2.0f * sqrtf(grad2));
}

// A pixel's values of the planes the prologue reads once per pixel: the
// flow the level started from, the grey derivatives and, for the gradient
// and log constancies, the tensor J (else the j fields are unused).
struct PixelPlanes {
  float u, v, fx, fy, ft, j11, j22, j12, j13, j23;
};

// The 9 per-outer hoists of pixel c = (y, x) from phi at the pixel and its
// four (reflected) neighbours, the iterate's centre (tu_c, tv_c) and the
// pixel's planes, term for term level_fused.py:354-393. hoist planes: pw_xp,
// pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv. With TENSOR (gradient and
// log) the a12/a13/a23/dnu/dnv hoists take J (level_fused.py:379-392); ksi
// stays grey. gy is the pixel's global row in a level of gh rows.
template <bool TENSOR>
__device__ __forceinline__ void hoists_px(float phi_c, float phi_xp, float phi_xm,
                                          float phi_yp, float phi_ym, float tu_c, float tv_c,
                                          const PixelPlanes& p, float* __restrict__ hoist,
                                          size_t n, int c, int x, int w, int gy, int gh,
                                          float alpha_hx2, float alpha_hy2, float e_d2) {
  // Free-boundary weights alpha/h^2, zero at the image border, at global
  // rows (solve_2d.cu:333-340; halo.py:163-173).
  const float xp_w = x < w - 1 ? alpha_hx2 : 0.0f;
  const float xm_w = x > 0 ? alpha_hx2 : 0.0f;
  const float yp_w = gy < gh - 1 ? alpha_hy2 : 0.0f;
  const float ym_w = gy > 0 ? alpha_hy2 : 0.0f;
  const float pw_xp = (phi_xp + phi_c) * 0.5f * xp_w;
  const float pw_xm = (phi_xm + phi_c) * 0.5f * xm_w;
  const float pw_yp = (phi_yp + phi_c) * 0.5f * yp_w;
  const float pw_ym = (phi_ym + phi_c) * 0.5f * ym_w;
  const float sum_h = pw_xp + pw_xm + pw_yp + pw_ym;

  // ksi from the GREY tensor at du = T - u (reference quirk:
  // cuda_operation_solve_2d.cpp:84).
  const float du_c = tu_c - p.u;
  const float dv_c = tv_c - p.v;
  const float fx = p.fx;
  const float fy = p.fy;
  const float ft = p.ft;
  const float sq = (fx * fx * du_c + fx * fy * dv_c + fx * ft) * du_c +
                   (fx * fy * du_c + fy * fy * dv_c + fy * ft) * dv_c +
                   (fx * ft * du_c + fy * ft * dv_c + ft * ft);
  const float sq0 = sq < 0.0f ? 0.0f : sq;  // max(sq, 0), NaN passes through
  const float ksi = 1.0f / (2.0f * sqrtf(sq0 + e_d2));

  const float J11 = TENSOR ? p.j11 : fx * fx;
  const float J22 = TENSOR ? p.j22 : fy * fy;
  const float J12 = TENSOR ? p.j12 : fx * fy;
  const float J13 = TENSOR ? p.j13 : fx * ft;
  const float J23 = TENSOR ? p.j23 : fy * ft;

  hoist[c] = pw_xp;
  hoist[n + c] = pw_xm;
  hoist[2 * n + c] = pw_yp;
  hoist[3 * n + c] = pw_ym;
  hoist[4 * n + c] = ksi * J12;            // a12
  hoist[5 * n + c] = ksi * J13;            // a13
  hoist[6 * n + c] = ksi * J23;            // a23
  hoist[7 * n + c] = ksi * J11 + sum_h;    // dnu
  hoist[8 * n + c] = ksi * J22 + sum_h;    // dnv
}

// The values one sweep reads at a pixel besides the iterate: the flow the
// level started from and the 9 per-outer hoists.
struct SweepConsts {
  float u, v, pw_xp, pw_xm, pw_yp, pw_ym, a12, a13, a23, dnu, dnv;
};

__device__ __forceinline__ SweepConsts load_sweep_consts(const float* __restrict__ uv,
                                                        const float* __restrict__ hoist,
                                                        size_t n, int c) {
  return SweepConsts{uv[c],           uv[n + c],       hoist[c],        hoist[n + c],
                     hoist[2 * n + c], hoist[3 * n + c], hoist[4 * n + c], hoist[5 * n + c],
                     hoist[6 * n + c], hoist[7 * n + c], hoist[8 * n + c]};
}

// One coupled T-form sweep at one pixel (sweep_core.py:45-79): new_du, then
// new_dv from the fresh new_du; returns T' = u + new_d (level_fused.py:328-341)
// as (tu', tv'). The arguments are T's values at the pixel's four (reflected)
// neighbours and its tv centre. sweep_px and ksweep_region both call it, so
// every sweep of the port is this one expression.
__device__ __forceinline__ float2 sweep_vals(const SweepConsts& k, float tu_xp, float tu_xm,
                                             float tu_yp, float tu_ym, float tv_xp,
                                             float tv_xm, float tv_yp, float tv_ym,
                                             float tv_c) {
  const float sum_u = k.pw_xp * (tu_xp - k.u) + k.pw_xm * (tu_xm - k.u) +
                      k.pw_yp * (tu_yp - k.u) + k.pw_ym * (tu_ym - k.u);
  const float sum_v = k.pw_xp * (tv_xp - k.v) + k.pw_xm * (tv_xm - k.v) +
                      k.pw_yp * (tv_yp - k.v) + k.pw_ym * (tv_ym - k.v);
  const float dv_c = tv_c - k.v;
  const float new_du = (-k.a13 - k.a12 * dv_c + sum_u) / k.dnu;
  const float new_dv = (-k.a23 - k.a12 * new_du + sum_v) / k.dnv;
  return make_float2(k.u + new_du, k.v + new_dv);
}

// jacobi_sweep at (y, x) of a block of h rows: sweep_vals on T read from
// device memory. Reads T, writes T_out.
__device__ __forceinline__ void sweep_px(const float* __restrict__ T,
                                         const float* __restrict__ uv,
                                         const float* __restrict__ hoist,
                                         float* __restrict__ T_out, int y, int x, int h,
                                         int w) {
  const size_t n = (size_t)h * w;
  const int c = y * w + x;
  const int xp = y * w + refl(x + 1, w), xm = y * w + refl(x - 1, w);
  const int yp = refl(y + 1, h) * w + x, ym = refl(y - 1, h) * w + x;
  const float* tu = T;
  const float* tv = T + n;
  const float2 t = sweep_vals(load_sweep_consts(uv, hoist, n, c), tu[xp], tu[xm], tu[yp],
                              tu[ym], tv[xp], tv[xm], tv[yp], tv[ym], tv[c]);
  T_out[c] = t.x;
  T_out[n + c] = t.y;
}

// ---------------------------------------------------------------------------
// prologue_tile: phi, ksi and the per-outer hoists of one TW x PRO_TH tile
// whose top-left pixel is (x0, y0) (level_fused.py:343-393). A block of TW x
// PRO_TH threads, one per pixel, runs it:
//   1. it copies into shared memory, with cp.async and all at once, the two
//      T planes over the tile plus a 2-pixel ring and the tile of every plane
//      it reads once (u, v, fx, fy, ft and J): one wait for device memory per
//      tile, with the tile's whole input in flight;
//   2. it evaluates phi_of over the tile plus a 1-pixel ring into a second
//      shared tile (1.33 evaluations per pixel at TW = 32, 1.29 at 64);
//   3. each thread forms its pixel's hoists with hoists_px and writes them,
//      coalesced along the row.
// The mirror rule: phi tile entry q holds phi at block coordinate refl(q),
// for q in [-1, n] (one reflection stays in the block for n >= 2), and its
// T neighbours are refl(refl(q) +- 1) in block coordinates, which the T tile
// holds at that coordinate's own offset. So no coordinate is reflected
// twice: with w = 2, refl(-2) = 2 would leave the block. Every value is then
// the one phi at each neighbour would give, in the same association,
// bitwise. prologue_stage issues step 1's copies and prologue_finish runs
// steps 2-3 once they have landed and the block has synced, so a caller can
// stage the next tile while it finishes this one (the sharded kernel);
// prologue_tile runs the three in turn. The caller syncs the block before it
// reuses the tile's memory.
// ---------------------------------------------------------------------------
constexpr int PRO_TH = 8;  // tile height: one thread per row

template <int TW, bool TENSOR>
struct ProTile {
  static constexpr int NS = TENSOR ? 10 : 5;  // planes read once: u, v, fx, fy, ft (, J x5)
  // ts[p][r][c] = plane p of T at block (y0 - 2 + r, x0 - 2 + c), where that
  // lies in the block; ps[r][c] = phi at (refl(y0 - 1 + r), refl(x0 - 1 + c));
  // ss[p][r][c] = plane p at (y0 + r, x0 + c).
  float ts[2][PRO_TH + 4][TW + 4];
  float ps[PRO_TH + 2][TW + 2];
  float ss[NS][PRO_TH][TW];
};

template <int TW, bool TENSOR>
__device__ __forceinline__ void prologue_stage(ProTile<TW, TENSOR>& sm,
                                               const float* __restrict__ T,
                                               const float* __restrict__ uv,
                                               const float* __restrict__ fxyz,
                                               const float* __restrict__ J, int x0, int y0,
                                               int h, int w) {
  constexpr int NS = ProTile<TW, TENSOR>::NS, NT = TW * PRO_TH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int x = x0 + tx, y = y0 + ty;
  const size_t n = (size_t)h * w;
  for (int i = tid; i < (PRO_TH + 4) * (TW + 4); i += NT) {
    const int r = i / (TW + 4), c = i % (TW + 4);
    const int gy = y0 - 2 + r, gx = x0 - 2 + c;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t g = (size_t)gy * w + gx;
      cp_async4(&sm.ts[0][r][c], T + g);
      cp_async4(&sm.ts[1][r][c], T + n + g);
    }
  }
  if (x < w && y < h) {
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const float* src = p < 2 ? uv + p * n : (p < 5 ? fxyz + (p - 2) * n : J + (p - 5) * n);
      cp_async4(&sm.ss[p][ty][tx], src + (size_t)y * w + x);
    }
  }
}

template <int TW, bool TENSOR>
__device__ __forceinline__ void prologue_finish(ProTile<TW, TENSOR>& sm,
                                                float* __restrict__ hoist, int x0, int y0,
                                                int h, int w, int gy0, int gh, float div2hx,
                                                float div2hy, float alpha_hx2, float alpha_hy2,
                                                float e_s2, float e_d2) {
  constexpr int NT = TW * PRO_TH;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int x = x0 + tx, y = y0 + ty;
  const size_t n = (size_t)h * w;
  for (int i = tid; i < (PRO_TH + 2) * (TW + 2); i += NT) {
    const int r = i / (TW + 2), c = i % (TW + 2);
    const int qy = y0 - 1 + r, qx = x0 - 1 + c;
    if (qy > h || qx > w) continue;  // beyond the ring of the block's last row or column
    const int py = refl(qy, h), px = refl(qx, w);
    // the neighbours of (py, px) that phi reads, as offsets into the T tile
    const int cy = py - y0 + 2, cx = px - x0 + 2;
    const int xp = refl(px + 1, w) - x0 + 2, xm = refl(px - 1, w) - x0 + 2;
    const int yp = refl(py + 1, h) - y0 + 2, ym = refl(py - 1, h) - y0 + 2;
    sm.ps[r][c] = phi_of(sm.ts[0][cy][xp], sm.ts[0][cy][xm], sm.ts[0][yp][cx],
                         sm.ts[0][ym][cx], sm.ts[1][cy][xp], sm.ts[1][cy][xm],
                         sm.ts[1][yp][cx], sm.ts[1][ym][cx], div2hx, div2hy, e_s2);
  }
  __syncthreads();

  if (x < w && y < h) {
    PixelPlanes planes{sm.ss[0][ty][tx], sm.ss[1][ty][tx], sm.ss[2][ty][tx],
                       sm.ss[3][ty][tx], sm.ss[4][ty][tx]};
    if constexpr (TENSOR) {
      planes.j11 = sm.ss[5][ty][tx];
      planes.j22 = sm.ss[6][ty][tx];
      planes.j12 = sm.ss[7][ty][tx];
      planes.j13 = sm.ss[8][ty][tx];
      planes.j23 = sm.ss[9][ty][tx];
    }
    hoists_px<TENSOR>(sm.ps[ty + 1][tx + 1], sm.ps[ty + 1][tx + 2], sm.ps[ty + 1][tx],
                      sm.ps[ty + 2][tx + 1], sm.ps[ty][tx + 1], sm.ts[0][ty + 2][tx + 2],
                      sm.ts[1][ty + 2][tx + 2], planes, hoist, n, y * w + x, x, w, gy0 + y,
                      gh, alpha_hx2, alpha_hy2, e_d2);
  }
}

template <int TW, bool TENSOR>
__device__ __forceinline__ void prologue_tile(
    ProTile<TW, TENSOR>& sm, const float* __restrict__ T, const float* __restrict__ uv,
    const float* __restrict__ fxyz, const float* __restrict__ J, float* __restrict__ hoist,
    int x0, int y0, int h, int w, int gy0, int gh, float div2hx, float div2hy,
    float alpha_hx2, float alpha_hy2, float e_s2, float e_d2) {
  prologue_stage<TW, TENSOR>(sm, T, uv, fxyz, J, x0, y0, h, w);
  cp_async_wait_all();
  __syncthreads();
  prologue_finish<TW, TENSOR>(sm, hoist, x0, y0, h, w, gy0, gh, div2hx, div2hy, alpha_hx2,
                              alpha_hy2, e_s2, e_d2);
}

// ---------------------------------------------------------------------------
// ksweep_region: K <= KS_KMAX coupled sweeps of fixed uv and hoists over one
// region, and its tile written (the inner loop of one outer iteration).
// Every sweep of every pixel is sweep_vals on the operands K chained
// one-sweep passes give it, so the result is theirs, bit for bit.
//   * a block of KS_RW x KS_TY threads owns a region of KS_RW x KS_RH
//     pixels: its output tile, (KS_RW - 2K) x (KS_RH - 2K) from (x0, y0),
//     plus a K-pixel ring, clipped to the block of rows. Each thread owns one
//     column of KS_RH / KS_TY region pixels (rows ty, ty + KS_TY, ...), so a
//     warp touches 32 consecutive floats of a row. T's two buffers take 32 KB
//     of shared memory (``ts``, KS_SHARED floats);
//   * T's two planes over the region are copied in by cp.async. u, v and the
//     9 hoists are read only at a pixel's own thread, and only where the
//     first sweep updates: each thread loads its pixels' into registers;
//   * sweep s = 1..K reads T from one shared buffer and writes the other,
//     over the region shrunk by s on every side that is not an edge of the
//     block (the trapezoid). At an edge the mirror neighbour refl(+-1) lies
//     inside the region and holds the same sweep's value, so no pixel reads
//     a value the chained passes would not give it;
//   * after sweep K the tile's own pixels are written to device memory.
// At K = 5 the ring costs 64 x 32 / (54 x 22) = 1.7x the tile's T bytes
// (neighbouring regions read the overlap, mostly from L2) and the trapezoid
// 1.3x the tile's sweeps. The caller syncs the block before it reuses ts.
// ---------------------------------------------------------------------------
constexpr int KS_KMAX = 5;   // sweeps per region pass (ops/level.py: KMAX)
constexpr int KS_RW = 64;    // region columns, one thread each (ops/level.py: KSWEEP_RW)
constexpr int KS_TY = 8;     // thread rows
constexpr int KS_RH = 32;    // region rows (ops/level.py: KSWEEP_RH)
constexpr int KS_THREADS = KS_RW * KS_TY;
constexpr int KS_PLANE = KS_RH * KS_RW;  // floats of one shared plane
constexpr int KS_SHARED = 4 * KS_PLANE;  // [buffer][plane][row][col] of T

template <int K>
__device__ __forceinline__ void ksweep_region(float* __restrict__ ts,
                                              const float* __restrict__ T,
                                              const float* __restrict__ uv,
                                              const float* __restrict__ hoist,
                                              float* __restrict__ T_out, int x0, int y0,
                                              int h, int w) {
  static_assert(K >= 1 && K <= KS_KMAX && KS_RH % KS_TY == 0 && KS_RH > 2 * K,
                "bad k-sweep geometry");
  constexpr int P = KS_RH / KS_TY;  // region pixels per thread
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int rx0 = x0 - K, ry0 = y0 - K;  // region origin
  const size_t n = (size_t)h * w;
  // A side of the region shrinks by one pixel a sweep unless it is an edge
  // of the block; the region's first and last columns and rows inside it.
  const bool shrink_l = rx0 > 0, shrink_r = rx0 + KS_RW - 1 < w - 1;
  const bool shrink_t = ry0 > 0, shrink_b = ry0 + KS_RH - 1 < h - 1;
  const int c_first = max(0, -rx0), c_last = min(KS_RW - 1, w - 1 - rx0);
  const int r_first = max(0, -ry0), r_last = min(KS_RH - 1, h - 1 - ry0);
  const int gx = rx0 + tx;
  // the mirror neighbours of column tx, as region columns
  const int xp = gx == w - 1 ? tx - 1 : tx + 1;
  const int xm = gx == 0 ? tx + 1 : tx - 1;

  SweepConsts kc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int r = ty + KS_TY * j, gy = ry0 + r;
    if (tx < c_first || tx > c_last || r < r_first || r > r_last) continue;
    const size_t g = (size_t)gy * w + gx;
    const int i = r * KS_RW + tx;
    cp_async4(&ts[i], T + g);
    cp_async4(&ts[KS_PLANE + i], T + n + g);
    // u, v and the hoists only where the first sweep updates
    const bool first = tx >= (shrink_l ? 1 : c_first) && tx <= (shrink_r ? KS_RW - 2 : c_last) &&
                       r >= (shrink_t ? 1 : r_first) && r <= (shrink_b ? KS_RH - 2 : r_last);
    if (first) kc[j] = load_sweep_consts(uv, hoist, n, (int)g);
  }
  cp_async_wait_all();
  __syncthreads();

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    const float* tu = ts + ((s - 1) & 1) * 2 * KS_PLANE;
    const float* tv = tu + KS_PLANE;
    float* dst = ts + (s & 1) * 2 * KS_PLANE;
    const bool col_ok =
        tx >= (shrink_l ? s : c_first) && tx <= (shrink_r ? KS_RW - 1 - s : c_last);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int r = ty + KS_TY * j, gy = ry0 + r;
      if (!col_ok || r < (shrink_t ? s : r_first) || r > (shrink_b ? KS_RH - 1 - s : r_last))
        continue;
      const int i = r * KS_RW + tx;
      const int row = r * KS_RW;
      const int yp = (gy == h - 1 ? r - 1 : r + 1) * KS_RW + tx;
      const int ym = (gy == 0 ? r + 1 : r - 1) * KS_RW + tx;
      const float2 t = sweep_vals(kc[j], tu[row + xp], tu[row + xm], tu[yp], tu[ym],
                                  tv[row + xp], tv[row + xm], tv[yp], tv[ym], tv[i]);
      dst[i] = t.x;
      dst[KS_PLANE + i] = t.y;
    }
    __syncthreads();
  }

  // the tile: region columns and rows [K, size - K), inside the block
  if (tx < K || tx >= KS_RW - K || gx >= w) return;
  const float* fin = ts + (K & 1) * 2 * KS_PLANE;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int r = ty + KS_TY * j, gy = ry0 + r;
    if (r < K || r >= KS_RH - K || gy >= h) continue;
    const size_t g = (size_t)gy * w + gx;
    T_out[g] = fin[r * KS_RW + tx];
    T_out[n + g] = fin[KS_PLANE + r * KS_RW + tx];
  }
}

}  // namespace tf_body
