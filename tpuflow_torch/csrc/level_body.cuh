// Per-pixel bodies of the relaxation, shared by the level kernels
// (level.cu: outer_prologue_kernel<TENSOR>, jacobi_sweep_kernel,
// jacobi_sweeps_kernel<K, CONSTS_SHARED>) and the
// row-sharded relaxation (sharded.cu: relax_sharded_kernel<TENSOR>), so both
// run the same arithmetic in the same association order.
//
// A body works on one block of rows: contiguous float32 (h, w) planes, stacks
// of planes back to back (plane stride n = h * w). The mirror boundary is
// reflect indexing at the block's own edges (neighbour -1 reads 1, neighbour
// h reads h - 2). For a whole level the block is the level; for a shard it is
// the shard's padded rows, which end at the image edge wherever the shard
// touches it, so the image's rule holds there as well. The free-boundary
// weights depend on the pixel's global row gy in a level of gh rows.

#pragma once

#include <cuda_runtime.h>

namespace tf_body {

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

// phi at (y, x) of the T iterate.
__device__ __forceinline__ float phi_at(const float* __restrict__ tu,
                                        const float* __restrict__ tv, int y, int x,
                                        int h, int w, float div2hx, float div2hy,
                                        float e_s2) {
  const int xp = y * w + refl(x + 1, w), xm = y * w + refl(x - 1, w);
  const int yp = refl(y + 1, h) * w + x, ym = refl(y - 1, h) * w + x;
  return phi_of(tu[xp], tu[xm], tu[yp], tu[ym], tv[xp], tv[xm], tv[yp], tv[ym], div2hx,
                div2hy, e_s2);
}

// A pixel's values of the planes the prologue reads once per pixel: the
// flow the level started from, the grey derivatives and, for the gradient
// and log constancies, the tensor J (else the j fields are unused).
struct PixelPlanes {
  float u, v, fx, fy, ft, j11, j22, j12, j13, j23;
};

template <bool TENSOR>
__device__ __forceinline__ PixelPlanes load_planes(const float* __restrict__ uv,
                                                   const float* __restrict__ fxyz,
                                                   const float* __restrict__ J, size_t n,
                                                   int c) {
  PixelPlanes p{uv[c], uv[n + c], fxyz[c], fxyz[n + c], fxyz[2 * n + c]};
  if constexpr (TENSOR) {
    p.j11 = J[c];
    p.j22 = J[n + c];
    p.j12 = J[2 * n + c];
    p.j13 = J[3 * n + c];
    p.j23 = J[4 * n + c];
  }
  return p;
}

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

// outer_prologue at (y, x) of a block of h rows, phi included: each call
// evaluates phi at the pixel and at its four (reflected) neighbours.
// relax_sharded_kernel runs it; the level's outer_prologue_kernel (level.cu)
// computes each phi once in a shared tile and calls hoists_px.
template <bool TENSOR>
__device__ __forceinline__ void prologue_px(const float* __restrict__ T,
                                            const float* __restrict__ uv,
                                            const float* __restrict__ fxyz,
                                            const float* __restrict__ J,
                                            float* __restrict__ hoist, int y, int x, int h,
                                            int w, int gy, int gh, float div2hx, float div2hy,
                                            float alpha_hx2, float alpha_hy2, float e_s2,
                                            float e_d2) {
  const size_t n = (size_t)h * w;
  const int c = y * w + x;
  const float* tu = T;
  const float* tv = T + n;
  hoists_px<TENSOR>(phi_at(tu, tv, y, x, h, w, div2hx, div2hy, e_s2),
                    phi_at(tu, tv, y, refl(x + 1, w), h, w, div2hx, div2hy, e_s2),
                    phi_at(tu, tv, y, refl(x - 1, w), h, w, div2hx, div2hy, e_s2),
                    phi_at(tu, tv, refl(y + 1, h), x, h, w, div2hx, div2hy, e_s2),
                    phi_at(tu, tv, refl(y - 1, h), x, h, w, div2hx, div2hy, e_s2), tu[c],
                    tv[c], load_planes<TENSOR>(uv, fxyz, J, n, c), hoist, n, c, x, w, gy, gh,
                    alpha_hx2, alpha_hy2, e_d2);
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
// neighbours and its tv centre. sweep_px and the k-sweep kernel (level.cu)
// both call it, so every sweep of the port is this one expression.
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

}  // namespace tf_body
