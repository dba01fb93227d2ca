// Hopper (sm_90a) microbenchmark kernels: the port's two measurement probes.
//
//   roofline_micro_kernel<BODY>  replaces tools/roofline.py:88 (microkernel,
//                                pl.pallas_call :104)
//   probe_matmul_kernel          replaces tools/probe_kernel_matmul.py:26
//                                (in_kernel, pl.pallas_call :27)
//
// Built into the same library as level.cu (without fast math, --fmad=false).

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// roofline_micro: T_LOOP x UNROLL passes x = body(x, a_j) over N_IN read-only
// fields a_0..a_7, starting from x = a_0 * 0.5; pass j of each group of
// UNROLL reads a_j. The TPU kernel kept all 8 fields in VMEM and measured
// the rate of on-chip loads and of each body's arithmetic; this twin
// measures the same on one H100 for shared memory, the on-chip store a
// k-sweep relaxation would run from.
//
// Design: 8 fields of 392x640 are 8 MB, about 61 KB for each of 132 SMs.
// Each block owns a band of BAND rows and loads that band of all 8 fields
// (plus one halo row for shift_y) into dynamic shared memory once; one
// thread per column carries x for its BAND pixels in registers for every
// pass and writes it once. The shifts act only on the read-only fields,
// never on the carry, so one halo row is enough. Every pass issues one
// ld.volatile.shared per pixel: without volatile, nvcc would hoist the 8
// loop-invariant loads into registers and the probe would measure
// registers, not shared memory.
// Bound: operations (passes x pixels x the body's float32 ops), or the
// shared-memory load rate; device memory is touched once (9 planes).
//
// Edge rule of the shifted bodies (tools/roofline.py:57-62): the last column
// (row) takes the second-to-last, a mirror, not a clamp.
// The "fma" body is a multiply and an add, each rounded (--fmad=false), as
// PyTorch computes x * a + 1.25; it grows geometrically to inf at full depth,
// as on the TPU.
// ---------------------------------------------------------------------------

constexpr int N_IN = 8;
constexpr int UNROLL = 8;
constexpr int BAND = 3;

enum Body { STREAM = 0, SHIFT_X = 1, SHIFT_Y = 2, FMA = 3, DIV = 4, PHI = 5 };

template <int B>
__device__ __forceinline__ float body(float x, float a) {
  if constexpr (B == FMA) {
    return x * a + 1.25f;
  } else if constexpr (B == DIV) {
    return a / (x + 1.0f);
  } else if constexpr (B == PHI) {
    return 1.0f / (2.0f * sqrtf(x * x + a));
  } else {
    return x + a;
  }
}

// Shared layout: [N_IN][BAND + 1][w]; slot BAND of each field holds the row
// after the band (the mirror row h-2 for the band that ends the field).
template <int B>
__global__ void roofline_micro_kernel(const float* __restrict__ x0,
                                      const float* __restrict__ rest, float* __restrict__ out,
                                      int h, int w, int t_loop) {
  extern __shared__ float smem[];
  const int y0 = blockIdx.x * BAND;
  const int rows = min(BAND, h - y0);
  const int x = threadIdx.x;
  const size_t n = (size_t)h * w;
  const int plane = (BAND + 1) * w;
  const int halo = y0 + rows < h ? y0 + rows : h - 2;
  for (int j = 0; j < N_IN; ++j) {
    const float* src = j == 0 ? x0 : rest + (size_t)(j - 1) * n;
    for (int r = 0; r <= BAND; ++r) {
      const int row = r < rows ? y0 + r : (r == BAND ? halo : -1);
      if (row >= 0) smem[j * plane + r * w + x] = src[(size_t)row * w + x];
    }
  }
  __syncthreads();

  const int col = B == SHIFT_X ? (x + 1 < w ? x + 1 : w - 2) : x;
  int off[BAND];
  float xr[BAND];
#pragma unroll
  for (int r = 0; r < BAND; ++r) {
    const int slot = B == SHIFT_Y ? (r + 1 < rows ? r + 1 : BAND) : r;
    off[r] = slot * w + col;
    xr[r] = smem[r * w + x] * 0.5f;
  }
  const volatile float* vs = smem;
  for (int t = 0; t < t_loop; ++t) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
#pragma unroll
      for (int r = 0; r < BAND; ++r) xr[r] = body<B>(xr[r], vs[j * plane + off[r]]);
    }
  }
#pragma unroll
  for (int r = 0; r < BAND; ++r)
    if (r < rows) out[(size_t)(y0 + r) * w + x] = xr[r];
}

template <int B>
cudaError_t launch_micro(const float* x0, const float* rest, float* out, int h, int w,
                         int t_loop, cudaStream_t s) {
  const int smem = N_IN * (BAND + 1) * w * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(roofline_micro_kernel<B>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  roofline_micro_kernel<B><<<(h + BAND - 1) / BAND, w, smem, s>>>(x0, rest, out, h, w, t_loop);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// probe_matmul: C = A @ B in float32, (M, K) @ (K, N) -> (M, N). The TPU
// probe asked whether an in-kernel HIGHEST-precision matmul (a multi-pass
// bf16 product on the MXU) matches XLA's. Here it is a simple SIMT GEMM:
// 64x64 output tiles, 16-deep slabs of A and B in shared memory, 4x4 outputs
// in registers per thread, each product accumulated in k order with an
// explicit __fmaf_rn (which --fmad=false leaves alone). cuBLAS's SGEMM sums in
// another order, so the two agree to rounding, not bitwise.
// Bound: operations (2 M N K flops) at the probe's shape; this kernel uses
// no tensor cores and, at (64, 448) @ (448, 640), only 10 of 132 SMs.
// ---------------------------------------------------------------------------

constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 16, MM_T = 4;
constexpr int MM_THREADS = (MM_BM / MM_T) * (MM_BN / MM_T);  // 256

__global__ void probe_matmul_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                                    float* __restrict__ C, int M, int K, int N) {
  __shared__ float As[MM_BK][MM_BM];  // A's slab, transposed
  __shared__ float Bs[MM_BK][MM_BN];
  const int tx = threadIdx.x % (MM_BN / MM_T);
  const int ty = threadIdx.x / (MM_BN / MM_T);
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  float acc[MM_T][MM_T];
#pragma unroll
  for (int i = 0; i < MM_T; ++i)
#pragma unroll
    for (int j = 0; j < MM_T; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    for (int i = threadIdx.x; i < MM_BM * MM_BK; i += MM_THREADS) {
      const int m = i / MM_BK, k = i % MM_BK;
      As[k][m] = (m0 + m < M && k0 + k < K) ? A[(size_t)(m0 + m) * K + k0 + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < MM_BK * MM_BN; i += MM_THREADS) {
      const int k = i / MM_BN, c = i % MM_BN;
      Bs[k][c] = (k0 + k < K && n0 + c < N) ? Bm[(size_t)(k0 + k) * N + n0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MM_BK; ++k) {
      float a[MM_T], b[MM_T];
#pragma unroll
      for (int i = 0; i < MM_T; ++i) a[i] = As[k][ty * MM_T + i];
#pragma unroll
      for (int j = 0; j < MM_T; ++j) b[j] = Bs[k][tx * MM_T + j];
#pragma unroll
      for (int i = 0; i < MM_T; ++i)
#pragma unroll
        for (int j = 0; j < MM_T; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MM_T; ++i) {
    const int m = m0 + ty * MM_T + i;
#pragma unroll
    for (int j = 0; j < MM_T; ++j) {
      const int c = n0 + tx * MM_T + j;
      if (m < M && c < N) C[(size_t)m * N + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// body: the index of the body in tpuflow_torch/tools/roofline.py BODIES
// (stream, shift_x, shift_y, fma, div, phi). x0 (h, w) is a_0, rest
// (7, h, w) holds a_1..a_7; needs 2 <= h, 2 <= w <= 1024.
int tf_roofline_micro(const float* x0, const float* rest, float* out, int h, int w,
                      int t_loop, int body, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (body) {
    case STREAM: return (int)launch_micro<STREAM>(x0, rest, out, h, w, t_loop, s);
    case SHIFT_X: return (int)launch_micro<SHIFT_X>(x0, rest, out, h, w, t_loop, s);
    case SHIFT_Y: return (int)launch_micro<SHIFT_Y>(x0, rest, out, h, w, t_loop, s);
    case FMA: return (int)launch_micro<FMA>(x0, rest, out, h, w, t_loop, s);
    case DIV: return (int)launch_micro<DIV>(x0, rest, out, h, w, t_loop, s);
    case PHI: return (int)launch_micro<PHI>(x0, rest, out, h, w, t_loop, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int tf_probe_matmul(const float* A, const float* B, float* C, int M, int K, int N,
                    void* stream) {
  const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  probe_matmul_kernel<<<grid, MM_THREADS, 0, (cudaStream_t)stream>>>(A, B, C, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
