// Hopper (sm_90a) microbenchmark kernels: the port's two measurement probes.
//
//   roofline_micro_kernel<BODY>  replaces tools/roofline.py:88 (microkernel,
//                                pl.pallas_call :104)
//   probe_matmul_kernel          replaces tools/probe_kernel_matmul.py:26
//                                (in_kernel, pl.pallas_call :27)
//
// Built into the same library as level.cu (without fast math, --fmad=false).

#include <cuda_runtime.h>

#include <cstdint>

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
// bf16 product on the MXU) matches XLA's. Here it stays float32 FFMA (TF32
// would be another function): each output is one __fmaf_rn chain from 0 in
// k order (which --fmad=false leaves alone), so its bits do not depend on
// the tiling. cuBLAS's SGEMM sums in another order: the two agree to
// rounding, not bitwise.
// Bound: operations (M N K FFMA). At the probe's (64, 448) @ (448, 640) that
// is 0.55 us of the card, and each output's chain of K dependent FFMAs
// (about 4 clocks each) takes about 0.9 us alone, so the kernel is held by
// latency: of the chains, and of the panels' first bytes. Design:
//   * small output tiles, MM_BM x MM_BN = 16 x 20, to spread the chains over
//     the card: the probe's shape gives 4 x 32 = 128 CTAs for 132 SMs. The
//     whole K stays in the CTA (no split-K, which would change the order);
//   * A's 16-row panel and B's 20-column panel go through a MM_STAGES-deep
//     cp.async ring of MM_KC-deep chunks, so the FFMAs of one chunk run while
//     the next ones land. 16-byte copies where K and N are multiples of 4 and
//     the operands 16-byte aligned, else 4-byte ones, which issue 4 times as
//     many copies: at the probe's shape on an H100 the 4-byte path takes
//     about 1.3x as long, slower than cuBLAS's SGEMM (ms_unaligned in
//     probe_kernel_matmul.run(), PERF.md). Out-of-range elements are
//     zero-filled by the copy (src-size 0), which adds only fma(0, 0, acc);
//   * A stays row-major in shared memory with its rows MM_KC + 4 floats
//     apart: a warp's float4 loads of 4 rows fall in distinct banks, and the
//     copies write whole 16-byte words, so no access is bank-conflicted;
//   * a thread owns 2 adjacent outputs of one row: per 4 k it loads one
//     float4 of A and four float2 of B for 8 FFMAs. 160 threads, 5 warps.
// The ring is MM_STAGES x (16 x 68 + 64 x 20) floats = 27.75 KB of static
// shared memory, under the 48 KB a launch gets without an attribute.
// ---------------------------------------------------------------------------

constexpr int MM_BM = 16, MM_BN = 20;        // output tile
constexpr int MM_KC = 64, MM_STAGES = 3;     // k-chunk depth, ring depth
constexpr int MM_TN = 2;                     // outputs per thread, along n
constexpr int MM_THREADS = MM_BM * (MM_BN / MM_TN);  // 160
constexpr int MM_ALD = MM_KC + 4;            // A's row pitch in shared memory

// One cp.async of V floats (4 or 16 bytes); only the first `bytes` are read
// from src, the rest of the destination is zero-filled.
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Chunk k0 of A's rows m0.. and B's columns n0.. into one stage of the ring.
template <int V>
__device__ __forceinline__ void mm_load_chunk(float (*As)[MM_ALD], float (*Bs)[MM_BN],
                                              const float* __restrict__ A,
                                              const float* __restrict__ Bm, int M, int K,
                                              int N, int m0, int n0, int k0) {
  for (int i = threadIdx.x; i < MM_BM * (MM_KC / V); i += MM_THREADS) {
    const int r = i / (MM_KC / V), c = (i % (MM_KC / V)) * V;
    const bool in = m0 + r < M && k0 + c < K;
    cp_async<V>(&As[r][c], in ? A + (size_t)(m0 + r) * K + k0 + c : A, in ? 4 * V : 0);
  }
  for (int i = threadIdx.x; i < MM_KC * (MM_BN / V); i += MM_THREADS) {
    const int r = i / (MM_BN / V), c = (i % (MM_BN / V)) * V;
    const bool in = k0 + r < K && n0 + c < N;
    cp_async<V>(&Bs[r][c], in ? Bm + (size_t)(k0 + r) * N + n0 + c : Bm, in ? 4 * V : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int V>
__global__ void __launch_bounds__(MM_THREADS)
    probe_matmul_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                        float* __restrict__ C, int M, int K, int N) {
  __shared__ __align__(16) float As[MM_STAGES][MM_BM][MM_ALD];
  __shared__ __align__(16) float Bs[MM_STAGES][MM_KC][MM_BN];
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int tm = threadIdx.x / (MM_BN / MM_TN);
  const int tn = (threadIdx.x % (MM_BN / MM_TN)) * MM_TN;
  const int chunks = (K + MM_KC - 1) / MM_KC;

  // Fill all stages but one; every thread commits one group per chunk slot,
  // empty or not, so wait_group counts chunks.
#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < chunks)
      mm_load_chunk<V>(As[s], Bs[s], A, Bm, M, K, N, m0, n0, s * MM_KC);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<MM_STAGES - 2>();  // chunk ch has landed (this thread's copies)
    __syncthreads();                         // ... everyone's; stage ch - 1 is free
    const int next = ch + MM_STAGES - 1;
    if (next < chunks)
      mm_load_chunk<V>(As[next % MM_STAGES], Bs[next % MM_STAGES], A, Bm, M, K, N, m0, n0,
                       next * MM_KC);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float(*as)[MM_ALD] = As[ch % MM_STAGES];
    const float(*bs)[MM_BN] = Bs[ch % MM_STAGES];
#pragma unroll
    for (int k = 0; k < MM_KC; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&as[tm][k]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 b = *reinterpret_cast<const float2*>(&bs[k + kk][tn]);
        acc0 = __fmaf_rn(av[kk], b.x, acc0);
        acc1 = __fmaf_rn(av[kk], b.y, acc1);
      }
    }
  }
  const int m = m0 + tm, c = n0 + tn;
  if (m < M) {
    if (c < N) C[(size_t)m * N + c] = acc0;
    if (c + 1 < N) C[(size_t)m * N + c + 1] = acc1;
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
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) & 15) == 0;
  if (vec)
    probe_matmul_kernel<4><<<grid, MM_THREADS, 0, s>>>(A, B, C, M, K, N);
  else
    probe_matmul_kernel<1><<<grid, MM_THREADS, 0, s>>>(A, B, C, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
