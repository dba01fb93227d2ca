// Hopper (sm_90a) kernel for the banded 1-D pass of the presmooth and of the
// box resample: each output is a sum over its own window of the input along
// one axis, in ascending input order, scaled once:
//
//   acc = 0;  for j in [0, count): acc = acc + x[first + j] * weight_j;  out = acc * norm
//
// It replaces the JAX package's block-banded resample on its main path,
// resample_rows_blocked and resample_cols_blocked (tpuflow/ops/resample.py:233,
// :252, called from _resample_trim, tpuflow/solver/bucketed.py:903, and
// _resample_top, :588), and its presmooth as two banded Toeplitz products
// (tpuflow/ops/gaussian.py:92). Those are XLA matmuls on the TPU, whose MXU
// wants dense blocks; here each output reads only its own window. The sum is
// the reference's own (resample_2d.cu:44-74 for the resample; the zero-padded
// convolution_2d.cu:74-261 for the Gaussian, whose padded terms add +0 to a
// sum that is never -0 and so change nothing): with --fmad=false every
// product and every sum rounds as float32 on its own, so the kernel is
// bitwise its plain PyTorch version (ops/banded.py), which is bitwise the
// NumPy oracle's resample_x/resample_y and convolve_separable.
//
// The table (ops/banded.py: Band.packed) is int32 (out_n, stride) with rows
// [first, count, weight_0 .. weight_{stride-3}], the weights as float32 bits,
// zero beyond count. first and first + count never decrease with the output
// index, so a block's outputs read one contiguous span of the input.
//
// Bound: device memory, each input read once and each output written once;
// the resample's coarse levels add up to ceil(in/out) + 1 terms an output
// (176 at the 4K schedule's 22 x 13), still far below the issue rate.
//   banded_x_kernel  along the contiguous axis. A block stages XROWS rows of
//                    its outputs' input span in shared memory, XCHUNK floats
//                    at a time, with coalesced asynchronous copies (staged
//                    through a register, each store would wait for its
//                    load, and a thread's loads would go one at a time);
//                    each thread sums one output of each row from it, chunk
//                    after chunk in ascending order, so the order is the
//                    reference's.
//   banded_y_kernel  along the strided axis: one thread an output, the
//                    threads of a warp on neighbouring columns, so every
//                    load of the window is coalesced; a warp shares first,
//                    count and the weights.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int XT = 128;       // banded_x: outputs of a row per block, one a thread
constexpr int XROWS = 4;      // banded_x: rows a block sums at once
constexpr int XCHUNK = 1024;  // banded_x: floats of each row's span staged at a time
constexpr int YT = 128;       // banded_y: columns per block, one a thread
constexpr int MAX_GRID_Y = 65535;
// Enough blocks to fill the card several times over; a grid-stride loop
// covers the rest.
constexpr int TARGET_BLOCKS = 132 * 16 * 4;

__device__ __forceinline__ float weight(const int* row, int j) {
  return __int_as_float(__ldg(row + 2 + j));
}

// x (rows, in_n) -> out (rows, out_n)
__global__ void __launch_bounds__(XT)
    banded_x_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ table, int stride, int rows, int in_n, int out_n,
                    float norm) {
  __shared__ float s[XROWS][XCHUNK];
  const int o_lo = blockIdx.x * XT;
  const int o = o_lo + threadIdx.x;
  const int o_hi = min(o_lo + XT, out_n) - 1;
  const int* last = table + (size_t)o_hi * stride;
  const int s0 = __ldg(table + (size_t)o_lo * stride);
  const int s1 = __ldg(last) + __ldg(last + 1);
  const int* mine = table + (size_t)min(o, out_n - 1) * stride;
  const int first = __ldg(mine);
  const int count = o < out_n ? __ldg(mine + 1) : 0;
  for (int r0 = blockIdx.y * XROWS; r0 < rows; r0 += gridDim.y * XROWS) {
    const int nr = min(XROWS, rows - r0);
    float acc[XROWS];
#pragma unroll
    for (int r = 0; r < XROWS; ++r) acc[r] = 0.0f;
    for (int c0 = s0; c0 < s1; c0 += XCHUNK) {
      const int n = min(XCHUNK, s1 - c0);
      __syncthreads();  // the chunk before is read
      // asynchronous copies: every load of the chunk in flight at once
      for (int r = 0; r < nr; ++r) {
        const float* xr = x + (size_t)(r0 + r) * in_n + c0;
        for (int i = threadIdx.x; i < n; i += XT) __pipeline_memcpy_async(&s[r][i], xr + i, 4);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const int jlo = max(0, c0 - first);
      const int jhi = min(count, c0 + n - first);
#pragma unroll 4
      for (int j = jlo; j < jhi; ++j) {
        const float wj = weight(mine, j);
        const int k = first + j - c0;
        // rows past nr sum stale values and are not stored
#pragma unroll
        for (int r = 0; r < XROWS; ++r) acc[r] = acc[r] + s[r][k] * wj;
      }
    }
    if (o < out_n) {
#pragma unroll
      for (int r = 0; r < XROWS; ++r)
        if (r < nr) out[(size_t)(r0 + r) * out_n + o] = acc[r] * norm;
    }
  }
}

// x (planes, in_n, w) -> out (planes, out_n, w)
__global__ void __launch_bounds__(YT)
    banded_y_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ table, int stride, int planes, int in_n, int out_n,
                    int w, float norm) {
  const int c = blockIdx.x * YT + threadIdx.x;
  if (c >= w) return;
  const int n_out = planes * out_n;
  for (int po = blockIdx.y; po < n_out; po += gridDim.y) {
    const int p = po / out_n;
    const int o = po - p * out_n;
    const int* mine = table + (size_t)o * stride;
    const int first = __ldg(mine);
    const int count = __ldg(mine + 1);
    const float* col = x + ((size_t)p * in_n + first) * w + c;
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < count; ++j) acc = acc + __ldg(col + (size_t)j * w) * weight(mine, j);
    out[(size_t)po * w + c] = acc * norm;
  }
}

}  // namespace

extern "C" {

// x: (planes, h, w). axis 0 sums along x (w -> out_n), axis 1 along y
// (h -> out_n). table: the (out_n, stride) rows described above.
int tf_banded(const float* x, float* out, const int* table, int stride, int axis, int planes,
              int h, int w, int out_n, float norm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (planes <= 0 || h <= 0 || w <= 0 || out_n <= 0 || stride < 3)
    return (int)cudaErrorInvalidValue;
  if (axis == 0) {
    const int rows = planes * h;
    const int tiles = (out_n + XT - 1) / XT;
    const int row_blocks = (rows + XROWS - 1) / XROWS;
    const int gy = max(1, min(min(row_blocks, MAX_GRID_Y), TARGET_BLOCKS / tiles));
    banded_x_kernel<<<dim3(tiles, gy), XT, 0, s>>>(x, out, table, stride, rows, w, out_n,
                                                   norm);
  } else if (axis == 1) {
    const int tiles = (w + YT - 1) / YT;
    const int gy = min(planes * out_n, MAX_GRID_Y);
    banded_y_kernel<<<dim3(tiles, gy), YT, 0, s>>>(x, out, table, stride, planes, h, out_n, w,
                                                   norm);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
