// scan_probe: the prof_scan micro-benchmark's chain of row prefix scans.
//
// Replaces: scripts/prof_scan.py::make(kind) (pallas_call at :46), the probe
//   that times a lane-axis prefix scan inside one kernel three ways.
//
// What it computes: `steps` times over one (rows, 128) float32 block,
//   s = the inclusive prefix sum of each row along its 128 lanes, then
//   x = s * (1 / max(1, max |s| over the whole block)); the last x is the
//   output. The three kinds compute the same scan with other arithmetic:
//   - MATMUL: each row times the 0/1 upper-triangular (128, 128) matrix,
//     tri[i][j] = (i <= j), as the TPU runs it on its matrix unit: 128
//     multiply-adds per output, O(C^2) per row, fp32 on the CUDA cores
//     (tensor cores are for a later version);
//   - CUMSUM: each lane sums its 4 values serially, then a warp
//     __shfl_up_sync scan of the lane totals adds each lane's prefix;
//   - ROLL: the 7 Hillis-Steele log-shift steps in shared memory,
//     s[i] += (i >= k) ? s[i - k] : 0 for k = 1, 2, ..., 64 (the roll and the
//     `lane >= k` mask of prof_scan.py:34-38).
//
// Bound on this card: operations (the block is read once and written once,
// 1 MiB at rows = 1024; every step is 128 (MATMUL: 2 * 128) operations per
// value plus the max and the scale).
//
// Design: one cooperative launch, every block resident; one warp per row,
// each lane holding 4 neighbouring values in registers for all steps. The
// whole-block max of each step is a dependency across the grid: each block
// reduces its rows' max into one partial, writes it to a double-buffered
// array (step parity), meets the others at a grid barrier, and reduces all
// partials itself. The double buffer lets a block start the next step's
// partial while a slower block still reads this step's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 128;             // values per row (the TPU lane width)
constexpr int PER_LANE = C / 32;   // values a lane holds
constexpr int WARPS = 8;           // rows per block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Kind { MATMUL = 0, CUMSUM = 1, ROLL = 2 };

template <int KIND>
__device__ __forceinline__ void row_scan(float (&v)[PER_LANE],
                                         float* __restrict__ row, int lane) {
  const int base = lane * PER_LANE;
  if (KIND == CUMSUM) {
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j) v[j] += v[j - 1];
    float inc = v[PER_LANE - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(FULL_MASK, inc, off);
      if (lane >= off) inc += up;
    }
    float excl = __shfl_up_sync(FULL_MASK, inc, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) v[j] += excl;
  } else if (KIND == ROLL) {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) row[base + j] = v[j];
    __syncwarp();
#pragma unroll
    for (int k = 1; k < C; k <<= 1) {
      float r[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int i = base + j;
        r[j] = (i >= k) ? row[i - k] : 0.0f;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        v[j] += r[j];
        row[base + j] = v[j];
      }
      __syncwarp();
    }
  } else {  // MATMUL
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) row[base + j] = v[j];
    __syncwarp();
    float s[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s[j] = 0.0f;
#pragma unroll 8
    for (int i = 0; i < C; ++i) {
      const float a = row[i];  // one address for the warp: a broadcast
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const float tri = (i <= base + j) ? 1.0f : 0.0f;
        s[j] = fmaf(a, tri, s[j]);
      }
    }
    __syncwarp();  // every lane has read the row before the next step
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) v[j] = s[j];
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
scan_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ partial, int steps) {
  __shared__ float rows_s[WARPS][C];
  __shared__ float warp_max[WARPS];
  __shared__ float block_max;
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nblocks = gridDim.x;
  const size_t r = static_cast<size_t>(blockIdx.x) * WARPS + warp;
  const float4 in = reinterpret_cast<const float4*>(x + r * C)[lane];
  float v[PER_LANE] = {in.x, in.y, in.z, in.w};

  for (int step = 0; step < steps; ++step) {
    row_scan<KIND>(v, rows_s[warp], lane);
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) m = fmaxf(m, fabsf(v[j]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
    }
    if (lane == 0) warp_max[warp] = m;
    __syncthreads();
    float* buf = partial + (step & 1) * nblocks;
    if (threadIdx.x == 0) {
      float b = warp_max[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) b = fmaxf(b, warp_max[w]);
      buf[blockIdx.x] = b;
    }
    grid.sync();
    if (warp == 0) {
      float g = 0.0f;
      for (int b = lane; b < nblocks; b += 32) g = fmaxf(g, __ldcg(buf + b));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        g = fmaxf(g, __shfl_xor_sync(FULL_MASK, g, off));
      }
      if (lane == 0) block_max = g;
    }
    __syncthreads();
    const float scale = 1.0f / fmaxf(1.0f, block_max);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) v[j] *= scale;
  }
  reinterpret_cast<float4*>(out + r * C)[lane] =
      make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" int scan_probe_launch(const void* x, int rows, int kind,
                                 int steps, void* partial, void* out,
                                 void* stream) {
  if (rows <= 0 || rows % WARPS != 0 || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn;
  switch (kind) {
    case MATMUL:
      fn = reinterpret_cast<const void*>(scan_probe_kernel<MATMUL>);
      break;
    case CUMSUM:
      fn = reinterpret_cast<const void*>(scan_probe_kernel<CUMSUM>);
      break;
    case ROLL:
      fn = reinterpret_cast<const void*>(scan_probe_kernel<ROLL>);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(partial);
  void* args[] = {&xp, &op, &pp, &steps};
  // Fails (cudaErrorCooperativeLaunchTooLarge) rather than hangs when the
  // blocks cannot all be resident at once.
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(rows / WARPS), dim3(THREADS), args, 0,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* scan_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
