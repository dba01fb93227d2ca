// Hopper (sm_90a) kernels for the banded 1-D passes of the presmooth and of
// the box resample: each output is a sum over its own window of the input
// along one axis, in ascending input order, scaled once:
//
//   acc = 0;  for j in [0, count): acc = acc + x[first + j] * weight_j;  out = acc * norm
//
// They replace the JAX package's block-banded resample on its main path,
// resample_rows_blocked and resample_cols_blocked (tpuflow/ops/resample.py:233,
// :252, called from _resample_trim, tpuflow/solver/bucketed.py:903, and
// _resample_top, :588), and its presmooth as two banded Toeplitz products
// (tpuflow/ops/gaussian.py:92). Those are XLA matmuls on the TPU, whose MXU
// wants dense blocks; here each output reads only its own window. The sum is
// the reference's own (resample_2d.cu:44-74 for the resample; the zero-padded
// convolution_2d.cu:74-261 for the Gaussian, whose padded terms add +0 to a
// sum that is never -0 and so change nothing): with --fmad=false every
// product and every sum rounds as float32 on its own, so each kernel is
// bitwise its plain PyTorch version (ops/banded.py), which is bitwise the
// NumPy oracle's resample_x/resample_y and convolve_separable.
//
// One launch covers one or more levels: a plan (ops/banded.py: x_plan,
// y_plan), int32 on the device and built on the host once per shape, holds
// a header, one entry a level and the launch's work items. The solve
// resamples the frames of every level from the smoothed pair (reference:
// optical_flow_2d.cpp:283-304), so all of them are one X launch and one Y
// launch; the flow at each level and the presmooth are a one-level plan
// each. An output's arithmetic depends only on its own window: the same
// terms in the same order whatever rows, columns or levels a launch covers,
// so any split of a launch, or of a level's rows over cards, is bitwise the
// same.
//
// A level's weights take one of two forms, checked on the host (a band of
// neither form raises there): MODE_BOX (the resample: every interior weight
// 1, and v * 1 is v to the bit, so an interior term adds the value itself;
// the head and tail weights from the table) and MODE_TAPS (the Gaussian:
// weight j of output o is taps[origin + o - first - j]).
//
// banded_x_kernel  along the contiguous axis: every level of the plan from
//   one read of each input row. Bound: device memory, the input once and
//   every level's output once (at 4K, 66 MB in and 594 MB out for the frame
//   pyramid); then shared memory, since each staged value is read once a
//   level (49 times at 4K), by lanes whose windows lie far apart at the
//   coarse levels, so their 16-byte loads meet on banks.
//   Design: a block stages 8 input rows whole in dynamic shared memory, as
//   two planes of float4 (column k of 4 rows), so one 16-byte load serves 4
//   rows at every one of the 49 reads. That layout interleaves 4 rows, so a
//   16-byte run of one row in device memory lands in 4 float4s: the copies
//   are 4-byte cp.async (a row-major stage filled by 16-byte copies would
//   cost 4 loads a term in place of 1, on the reads that bound the launch).
//   Two buffers where they fit beside the plan's meta region (its level
//   entries, its warp runs and any taps, in shared memory): rows up to about
//   3,600 floats. Wider rows take one buffer, and 4K's 3,840 are among them
//   (4 x 3,840 x 16 = 245,760 bytes, over the 232,448 a block may opt in
//   to): its frame pyramid and its presmooth run one 1024-thread block an
//   SM, and no copy overlaps a sum. Four rows in two buffers, the same
//   bytes, was slower there (tools/variants.py x_four_rows_two_buffers;
//   PERF.md). A warp run is 32 consecutive outputs of one
//   level, one a lane: their counts differ by at most one, and their windows
//   and head and tail weights are one coalesced load a lane, the next run's
//   loaded while this one sums. Runs go to warps the largest window first.
//   The row groups go to the blocks whole while every block has one; the
//   groups left for the last turn are dealt as slices of their runs, so no
//   block runs a whole extra group while the others wait. Outputs go,
//   coalesced, into an intermediate whose levels start at multiples of 32
//   floats, so a warp's store fills whole 128-byte lines.
//   Rows too wide for one buffer of 8 rows (about 7,200 floats, less the
//   meta region's share of the 227 KB) take the unstaged instantiation: the
//   same runs and the same sums, 4 rows a group, each term read from device
//   memory through L1. No configuration of the port reaches it; it keeps
//   such rows working, bitwise.
//   A launch covers rows row0 .. row0 + band - 1 of each plane of
//   plane_rows rows: logical row g is input and output row
//   (g / band) plane_rows + row0 + g % band, so the intermediate keeps the
//   whole input's rows and the Y pass reads it unchanged. The flow's
//   resample over a process's rows gives a band of them (ops/resample.py);
//   every other launch gives band = plane_rows = rows and row0 = 0, where
//   row g is g itself. A block finds a group's rows once (one divide), not
//   at each store.
// banded_y_kernel  along the strided axis. Bound: device memory, each
//   level's columns of the intermediate once and its output once.
//   Design: work items are block-table entries (level, plane, up to YR
//   output rows, 256 columns), every field a block needs before its first
//   load in its own entry, the levels whose windows span the most input rows
//   first, so that the coarse levels' long chains run beside the fine
//   levels' streaming. A thread owns 4 adjacent columns (16-byte copies; the
//   intermediate's pitch and level offsets are multiples of 4 floats) and
//   stages them for the block's input rows, YK rows at a time, with
//   cp.async: each input row comes from device memory once, and no register
//   holds data in flight; each output row then sums its window from the
//   staged rows in ascending order, chunk after chunk.
//
// The C entry points launch on the caller's stream, allocate nothing on
// the device, and return cudaGetLastError() (or the error of an attribute
// or occupancy query; each is made once a device and size, then cached).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int XT = 1024;      // banded_x: threads a block
constexpr int NW = XT / 32;   // banded_x: warps a block
constexpr int RUN = 32;       // banded_x: outputs a warp run, one a lane
constexpr int YT = 64;        // banded_y: threads a block, 4 columns each
constexpr int YR = 4;         // banded_y: most output rows a thread owns
constexpr int YK = 16;        // banded_y: input rows a thread stages at once
constexpr int XL = 8;         // ints of an X level entry
constexpr int YL = 8;         // ints of a Y level entry
constexpr int YB = 12;        // ints of a Y block entry
constexpr int MODE_BOX = 1;   // head and tail from the table, every interior weight 1
constexpr int MODE_TAPS = 2;  // weight j of output o: taps[origin + o - first - j]

// An X plan: [levels, runs, meta ints, 0], then its meta region, copied
// whole into each block's shared memory: an XL-int entry a level [out_col,
// out_n, mode, norm bits, taps offset in the meta region (MODE_TAPS; else
// 0), origin, 0, 0], an int4 a run [level, first output, largest count,
// data offset in the plan], the taps; then each run's data in device
// memory: first[RUN], count[RUN], then MODE_BOX head[RUN], tail[RUN].
struct Lane {
  int first, count;
  float head, tail;
};

// XR rows a group: staged as XR / 4 planes of in_n float4, plane p holding
// column k of rows 4p .. 4p + 3 at k. `rows` logical rows, row g being row
// (g / band) plane_rows + row0 + g % band of x and of out.
template <bool STAGED, int XR>
__global__ void __launch_bounds__(XT)
    banded_x_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ plan, int rows, int in_n, long long in_pitch,
                    long long out_pitch, int nbuf, int n_runs, int meta_ints, int whole,
                    int parts, int band, int plane_rows, int row0) {
  constexpr int NP = XR / 4;
  auto at = [&](int g) -> long long {
    return (long long)(g / band) * plane_rows + row0 + g % band;
  };
  extern __shared__ int4 smem[];
  int* meta = reinterpret_cast<int*>(smem);
  const int* levels = meta;
  const int n_levels = __ldg(plan);
  const int4* runs = reinterpret_cast<const int4*>(meta + n_levels * XL);
  float4* stage = reinterpret_cast<float4*>(smem + (meta_ints + 3) / 4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (rows + XR - 1) / XR;
  // Work items: the first `whole` groups whole, then each group left for
  // the last turn in `parts` slices (slice s: every parts-th run from s), so
  // that no block waits through a whole group while others are done.
  const int items = whole + (groups - whole) * parts;
  auto group_of = [&](int it) { return it < whole ? it : whole + (it - whole) / parts; };
  // rows past the last are not copied: their sums use stale values and are
  // not stored
  // thread t copies row 4p + t % 4 of each plane p, every XT / 4-th
  // column from t / 4: consecutive threads fill consecutive floats, and a
  // warp reads 8 columns of 4 rows
  auto copy_group = [&](int g, float4* buf) {
    const int r = g * XR + (threadIdx.x & 3);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (r + 4 * p < rows) {
        const float* src = x + at(r + 4 * p) * in_pitch + (threadIdx.x >> 2);
        float* dst = reinterpret_cast<float*>(buf + p * in_n) + threadIdx.x;
        for (int k = threadIdx.x >> 2; k < in_n; k += XT / 4, src += XT / 4, dst += XT)
          __pipeline_memcpy_async(dst, src, 4);
      }
    }
    __pipeline_commit();
  };
  for (int e = threadIdx.x; e < meta_ints; e += XT) meta[e] = __ldg(plan + 4 + e);
  int buf = 0;
  if (STAGED && blockIdx.x < items) copy_group(group_of(blockIdx.x), stage);
  __syncthreads();  // the meta region is in place
  auto fetch = [&](int i) {
    Lane l;
    const int4 run = runs[i];
    const int* d = plan + run.w;
    l.first = __ldg(d + lane);
    l.count = __ldg(d + RUN + lane);  // 0 past the level's last output
    if (levels[run.x * XL + 2] == MODE_BOX) {
      l.head = __int_as_float(__ldg(d + 2 * RUN + lane));
      l.tail = __int_as_float(__ldg(d + 3 * RUN + lane));
    }
    return l;
  };
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int r0 = group_of(it) * XR;
    const int next = it + gridDim.x;
    const int slice = it < whole ? 0 : (it - whole) % parts;
    const int step = it < whole ? NW : NW * parts;  // a warp's runs: from slice + warp * (step / NW)
    const float4* s = stage + (size_t)buf * NP * in_n;
    if (STAGED) {
      if (nbuf == 2) {
        if (next < items) copy_group(group_of(next), stage + (size_t)(buf ^ 1) * NP * in_n);
        else __pipeline_commit();
        __pipeline_wait_prior(1);   // this group's copy has landed
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    }
    // the group's output rows, found once: logical row r0 + r is row orow[r]
    int orow[XR];
    {
      int q = r0 / band, m = r0 % band;
#pragma unroll
      for (int r = 0; r < XR; ++r) {
        orow[r] = q * plane_rows + row0 + m;
        if (++m == band) m = 0, ++q;
      }
    }
    // unstaged: each term's XR values from device memory, rows clamped
    const float* xr[XR];
#pragma unroll
    for (int r = 0; r < XR; ++r) xr[r] = x + at(min(r0 + r, rows - 1)) * in_pitch;
    const int i0 = slice + warp * (step / NW);
    Lane cur;
    if (i0 < n_runs) cur = fetch(i0);
    for (int i = i0; i < n_runs; i += step) {
      Lane nxt = cur;
      if (i + step < n_runs) nxt = fetch(i + step);  // in flight while this run sums
      const int4 run = runs[i];
      const int* lv = levels + run.x * XL;
      const int out_col = lv[0], out_n = lv[1], mode = lv[2];
      const float norm = __int_as_float(lv[3]);
      const int first = cur.first, count = cur.count;
      float acc[XR];
#pragma unroll
      for (int r = 0; r < XR; ++r) acc[r] = 0.0f;
      auto add = [&](int k) {  // acc + x: x * 1 is x, to the bit (-0 kept, NaN stays NaN)
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float4 v;
          if (STAGED) v = s[p * in_n + k];
          else v = make_float4(__ldg(xr[4 * p] + k), __ldg(xr[4 * p + 1] + k),
                               __ldg(xr[4 * p + 2] + k), __ldg(xr[4 * p + 3] + k));
          acc[4 * p] = acc[4 * p] + v.x;
          acc[4 * p + 1] = acc[4 * p + 1] + v.y;
          acc[4 * p + 2] = acc[4 * p + 2] + v.z;
          acc[4 * p + 3] = acc[4 * p + 3] + v.w;
        }
      };
      auto term = [&](int k, float w) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          float4 v;
          if (STAGED) v = s[p * in_n + k];
          else v = make_float4(__ldg(xr[4 * p] + k), __ldg(xr[4 * p + 1] + k),
                               __ldg(xr[4 * p + 2] + k), __ldg(xr[4 * p + 3] + k));
          acc[4 * p] = acc[4 * p] + v.x * w;
          acc[4 * p + 1] = acc[4 * p + 1] + v.y * w;
          acc[4 * p + 2] = acc[4 * p + 2] + v.z * w;
          acc[4 * p + 3] = acc[4 * p + 3] + v.w * w;
        }
      };
      if (mode == MODE_BOX) {
        if (count > 0) term(first, cur.head);
#pragma unroll 4
        for (int j = 1; j < run.z - 1; ++j)
          if (j < count - 1) add(first + j);
        if (count > 1) term(first + count - 1, cur.tail);
      } else {  // MODE_TAPS: weight j of this lane's window
        const float* taps = reinterpret_cast<const float*>(meta) + lv[4];
        const int tap0 = lv[5] + run.y + lane - first;
#pragma unroll 4
        for (int j = 0; j < run.z; ++j)
          if (j < count) term(first + j, taps[tap0 - j]);
      }
      const int o = run.y + lane;
      if (o < out_n) {
        float* dst = out + out_col + o;
#pragma unroll
        for (int r = 0; r < XR; ++r)
          if (r0 + r < rows) dst[orow[r] * out_pitch] = acc[r] * norm;
      }
      cur = nxt;
    }
    if (STAGED) {
      __syncthreads();  // every warp has read this group's rows
      if (nbuf == 2) {
        buf ^= 1;
      } else if (next < items) {
        copy_group(group_of(next), stage);
      }
    }
  }
}

// A Y plan: [levels, blocks, levels' offset, blocks' offset], a YL-int entry
// a level [out_n, norm bits, output offset low, high, mode, taps offset in
// the plan (MODE_TAPS; else 0), origin, taps], a
// YB-int entry a block [level, plane, first output row, first column,
// width, column of the intermediate, first input row, end input row,
// offset in the plan of the first output row's table row, table stride,
// output rows, 0], then each band's table, rows [first, count, weight_0 ..]
// (ops/banded.py: Band.packed), and the taps. A thread stages its own 4
// columns of the block's input rows, YK at a time, and reads only what it
// staged, so the block needs no barrier; each output row then sums its
// window's staged rows in ascending order, chunk after chunk.
__global__ void __launch_bounds__(YT)
    banded_y_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ plan, int levels_off, int blocks_off, int in_rows,
                    long long in_pitch) {
  __shared__ float4 tile[YK][YT];
  const int4* be = reinterpret_cast<const int4*>(plan + blocks_off) + 3 * blockIdx.x;
  const int4 b0 = __ldg(be), b1 = __ldg(be + 1), b2 = __ldg(be + 2);
  const int c = b0.w + 4 * threadIdx.x;
  const int width = b1.x;
  if (c >= width) return;
  const int k0 = b1.z, k1 = b1.w, stride = b2.y, nr = b2.z;
  const float* col = x + (long long)b0.y * in_rows * in_pitch + b1.y + 4 * threadIdx.x;
  auto copy = [&](int kc) {
    const int n = min(YK, k1 - kc);
    for (int q = 0; q < n; ++q)
      __pipeline_memcpy_async(&tile[q][threadIdx.x], col + (kc + q) * in_pitch, 16);
    __pipeline_commit();
  };
  copy(k0);
  const int* tab = plan + b2.x;
  const int* lv = plan + levels_off + b0.x * YL;
  const int out_n = __ldg(lv), mode = __ldg(lv + 4), taps = __ldg(lv + 5);
  const float norm = __int_as_float(__ldg(lv + 1));
  const long long out_off =
      (long long)(unsigned)__ldg(lv + 2) | ((long long)__ldg(lv + 3) << 32);
  const int tap0 = __ldg(lv + 6) + b0.z;  // MODE_TAPS: output row o0 + r, input row k at tap0 + r - k
  int first[YR], end[YR];
#pragma unroll
  for (int r = 0; r < YR; ++r) {
    first[r] = end[r] = 0;
    if (r < nr) {
      first[r] = __ldg(tab + r * stride);
      end[r] = first[r] + __ldg(tab + r * stride + 1);
    }
  }
  float acc[YR][4];
#pragma unroll
  for (int r = 0; r < YR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  for (int kc = k0; kc < k1; kc += YK) {
    __pipeline_wait_prior(0);
    const int kn = min(kc + YK, k1);
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int count = end[r] - first[r];
      for (int k = max(first[r], kc); k < min(end[r], kn); ++k) {
        const float4 v = tile[k - kc][threadIdx.x];
        const int j = k - first[r];
        if (mode == MODE_BOX && j > 0 && j < count - 1) {
          // v * 1 is v, to the bit (no rounding, -0 kept, NaN stays NaN)
          acc[r][0] = acc[r][0] + v.x;
          acc[r][1] = acc[r][1] + v.y;
          acc[r][2] = acc[r][2] + v.z;
          acc[r][3] = acc[r][3] + v.w;
        } else {  // a box's head or tail from the table, or a tap
          const float w = __int_as_float(mode == MODE_TAPS ? __ldg(plan + taps + tap0 + r - k)
                                                           : __ldg(tab + r * stride + 2 + j));
          acc[r][0] = acc[r][0] + v.x * w;
          acc[r][1] = acc[r][1] + v.y * w;
          acc[r][2] = acc[r][2] + v.z * w;
          acc[r][3] = acc[r][3] + v.w * w;
        }
      }
    }
    if (kn < k1) copy(kn);  // this thread's staged rows are summed
  }
  float* dst = out + out_off + ((long long)b0.y * out_n + b0.z) * width + c;
#pragma unroll
  for (int r = 0; r < YR; ++r) {
    if (r < nr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < width) dst[(long long)r * width + i] = acc[r][i] * norm;
    }
  }
}

std::mutex g_mu;  // guards the caches of the host code below

struct Card {
  int sms = 0, optin = 0;  // SMs, shared memory a block may opt in to
};

// The current device and its Card, read once a device.
cudaError_t card_of(int* dev, Card* card) {
  static std::map<int, Card> cards;
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = cards.find(*dev);
  if (it == cards.end()) {
    Card c;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    it = cards.emplace(*dev, c).first;
  }
  *card = it->second;
  return cudaSuccess;
}

struct XArgs {
  const float* x;
  float* out;
  const int* plan;
  int rows, in_n;
  long long in_pitch, out_pitch;
  int n_runs, meta_ints;
  int band, plane_rows, row0;  // rows row0 .. row0 + band - 1 of each plane
  cudaStream_t s;
};

template <bool STAGED, int XR>
cudaError_t launch_x(int dev, const Card& card, const XArgs& a, int nbuf, size_t smem) {
  // the blocks an SM holds at each (device, dynamic shared memory), found
  // once, after the opt-in to the card's shared memory
  static std::map<std::pair<int, size_t>, int> per_sm_at;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    auto it = per_sm_at.find({dev, smem});
    if (it == per_sm_at.end()) {
      cudaError_t err = cudaFuncSetAttribute(
          banded_x_kernel<STAGED, XR>, cudaFuncAttributeMaxDynamicSharedMemorySize, card.optin);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, banded_x_kernel<STAGED, XR>,
                                                            XT, smem);
      if (err != cudaSuccess) return err;
      it = per_sm_at.emplace(std::make_pair(dev, smem), per_sm).first;
    }
    per_sm = it->second;
  }
  // as many blocks as fit at once: whole groups for as many turns as every
  // block has one, then the groups left in slices, one a block (a launch
  // of fewer groups than blocks is latency-bound: no slices)
  const int groups = (a.rows + XR - 1) / XR;
  const int resident = max(1, per_sm) * card.sms;
  const int whole = groups / resident * resident, left = groups - whole;
  const int parts = whole && left ? max(1, resident / left) : 1;
  const int grid = min(resident, whole + left * parts);
  banded_x_kernel<STAGED, XR><<<grid, XT, smem, a.s>>>(a.x, a.out, a.plan, a.rows, a.in_n,
                                                       a.in_pitch, a.out_pitch, nbuf, a.n_runs,
                                                       a.meta_ints, whole, parts, a.band,
                                                       a.plane_rows, a.row0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: rows of in_n floats, in_pitch apart; out: the intermediate, out_pitch
// floats a row; plan: an X plan on the device, with n_runs runs and a meta
// region of meta_ints ints. Eight rows a group, in two buffers where they
// fit in shared memory beside the meta region, else in one; wider rows
// unstaged. The launch covers rows row0 .. row0 + band - 1 of each plane of
// plane_rows rows of x and of out, `rows` (a multiple of band) in all; band
// = plane_rows = rows and row0 = 0 is every row.
int tf_banded_x(const float* x, float* out, const int* plan, int rows, int in_n,
                long long in_pitch, long long out_pitch, int n_runs, int meta_ints, int band,
                int plane_rows, int row0, void* stream) {
  if (rows <= 0 || in_n <= 0 || in_pitch < in_n || out_pitch <= 0 || n_runs <= 0 ||
      meta_ints <= 0 || band <= 0 || rows % band != 0 || row0 < 0 || row0 + band > plane_rows)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  Card card;
  cudaError_t err = card_of(&dev, &card);
  if (err != cudaSuccess) return (int)err;
  const XArgs a{x, out, plan, rows, in_n, in_pitch, out_pitch, n_runs, meta_ints, band,
                plane_rows, row0, (cudaStream_t)stream};
  const size_t meta = (size_t)(meta_ints + 3) / 4 * sizeof(int4);
  const size_t row4 = (size_t)in_n * sizeof(float4);  // four staged rows
  const size_t room = (size_t)card.optin;
  if (meta > room) return (int)cudaErrorInvalidValue;
  if (meta + 4 * row4 <= room)
    err = launch_x<true, 8>(dev, card, a, 2, meta + 4 * row4);
  else if (meta + 2 * row4 <= room)  // 4K
    err = launch_x<true, 8>(dev, card, a, 1, meta + 2 * row4);
  else
    err = launch_x<false, 4>(dev, card, a, 0, meta);
  return (int)err;
}

// x: planes of in_rows rows, in_pitch floats a row (a multiple of 4, x
// 16-byte aligned); out: every level's (planes, out_n, width) output at its
// offset; plan: a Y plan on the device, its levels and `blocks` block
// entries at the offsets given.
int tf_banded_y(const float* x, float* out, const int* plan, int levels_off, int blocks_off,
                int blocks, int in_rows, long long in_pitch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks <= 0 || in_rows <= 0 || in_pitch <= 0 || in_pitch % 4 != 0 ||
      ((size_t)x & 15) != 0 || blocks_off % 4 != 0)
    return (int)cudaErrorInvalidValue;
  banded_y_kernel<<<blocks, YT, 0, s>>>(x, out, plan, levels_off, blocks_off, in_rows,
                                        in_pitch);
  return (int)cudaGetLastError();
}

}  // extern "C"
