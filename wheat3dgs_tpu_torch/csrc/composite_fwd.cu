// composite_fwd / composite_train_fwd: front-to-back compositors over the
// sorted entry stream, one 16x16 sub-tile of a 32x32 tile per block.
//
// Replace: wheat3dgs_tpu/ops/pallas_raster.py::_fwd_only_kernel (launched
//   by _fwd_only_fns.run, pallas_call at :1256, from rasterize_pallas_fwd)
//   and ::_fwd_kernel (the training forward, pallas_call at :1374, from
//   _composite_fns.run_fwd under rasterize_pallas's custom_vjp).
//
// What they compute, per pixel of tile t, walking the tile's depth-sorted
// segment [starts[t], ends[t]) (layout in composite_common.cuh):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,
//   alpha = min(alpha_max, opacity * exp(power)), zero if power > 0 or
//           alpha < alpha_min (renderCUDA's rules);
//   log-space transmittance logT += log1p(-alpha); an entry is included
//   only while logT_after >= log(T_EPS) (the TPU kernel's rule, :1172), and
//   the walk stops at the first entry that fails it;
//   w = alpha * T_before; out[0] += w (the weight sum, which is the
//   returned alpha, not 1 - T_final), out[1 + v] += w * value_v.
// Output: (1 + NV, H, W) float32, written only inside the image, so the
// partial edge tiles are cropped by the store itself. The training entry
// also writes the (H, W) int32 stop: one past the sorted position of the
// last entry the pixel included (the segment start if none), the CUDA
// reference's n_contrib. The backward walks each pixel exactly that far, so
// it stops at the same entry even where its recomputed log T rounds the
// other way at the floor. The TPU kernel's residual (all 16 packed
// accumulators and T_final) is not needed: only the weight sum, depth and
// colours reach a loss, and the backward reads those rows of the image.
//
// Bound on this card: operations. Each visited (pixel, entry) pair costs
// ~12 float ops plus an exp; each weighted pair adds log1p and 2 (1 + NV)
// ops. Bytes are small beside that: 8 bytes of key and 4 (6 + NV) bytes of
// features per entry, and 4 (1 + NV) (+ 4 for the stop) bytes per pixel.
//
// Design (PERF.md §6 has the measurements and the designs tried):
// - Work below the tile. A block is one 16x16 sub-tile, one pixel a thread
//   of 256, and a warp covers 8x4 of its pixels (a compact patch, so more
//   of a small footprint's pixels share a warp than in a 16x2 strip). A
//   busy tile's walk spreads over four blocks on four SMs, and a
//   near-empty frame's few busy tiles over four times as many SMs.
// - The sub-tile cull. The block walks its tile's segment in batches of
//   256 entries, one a thread: each thread tests its entry against the
//   sub-tile's pixel box (box_keep below; 16x16 rather than 32x8 because a
//   square box is the tightest for round footprints), and the kept ones
//   are compacted in shared memory by a block-wide ballot and prefix (so in
//   depth order), each with its sorted position (so the stop stays exact).
//   The pixels then walk only the kept entries.
// - The footprint skip. Each staged entry carries the power below which its
//   alpha is under alpha_min (as composite_bwd.cu's s_power_min); a lane
//   below it skips the exp, so a warp none of whose lanes reaches it jumps
//   over the entry after the conic. A lane leaves the walk when its pixel
//   is done, and a warp when all its lanes have. Both are plain branches:
//   warp votes per entry (composite_bwd.cu's __any_sync, and an __all_sync
//   for the warp's exit) cost more here than they saved.
// - Empty work cheaply. A block whose tile has no entries stores its zeros
//   and leaves before anything else. The launch allows programmatic
//   dependent launch: the grid is set up while the kernel before it in the
//   stream drains, and every thread waits (griddepcontrol.wait) for that
//   kernel's results before it touches global memory.
// - Occupancy and arithmetic. 6 blocks (1536 threads) per SM at up to 40
//   registers a thread (at 8 blocks, 32 registers, ptxas spilled); a
//   block's barriers (three a batch) stall only its own 256 threads. The
//   pixel's state (weight sum, values, log T, T, stop) waits in shared
//   memory while a batch is culled, so the cull's temporaries have the
//   registers. The weight takes a running product T *= 1 - alpha (no exp
//   of log T), while the include rule keeps the log-space sum with accurate
//   log1pf, so the stop agrees with the plain version as before. Accurate
//   expf / log1pf / logf, no fast-math intrinsics.
// Each pixel is summed by one thread in depth order, so two launches are
// bit-identical, and composite_fwd and composite_train_fwd (two
// instantiations of one template) give identical images.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using w3::TILE;

constexpr int SUB = TILE / 2;            // sub-tile side: 4 blocks a tile
constexpr int THREADS = SUB * SUB;       // one pixel a thread
constexpr int WARPS = THREADS / 32;
constexpr int BATCH = THREADS;           // entries a batch, one a thread
constexpr int BLOCKS_PER_SM = 6;         // 1536 resident threads
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// Minimum of the conic quadratic along one box edge: the edge's fixed
// coordinate d_fix, the free one clamped to [lo, hi] (decode_cull.cu's).
__device__ __forceinline__ float edge_min(float d_fix, float lo, float hi,
                                          float c_fix, float c_free,
                                          float cb) {
  const float t = min_nan(max_nan(-cb * d_fix / c_free, lo), hi);
  return c_fix * d_fix * d_fix + 2.0f * cb * d_fix * t + c_free * t * t;
}

// Whether an entry at (x, y) with conic (a, b, c) and opacity o may reach
// alpha_min at some pixel of the box [bx0, bx1] x [by0, by1]: the minimum of
// the conic quadratic over the box (decode_cull's exact tile test, on the
// sub-tile's box) against 2 ln(o / alpha_min) with its 1e-3 margin, plus an
// allowance for rounding: 2^-16 of the quadratic's largest term over the
// box, far above the few ulps by which this evaluation and a pixel's may
// differ (so no pair the walk would include is culled, even for a needle
// whose terms cancel). Conservative throughout: an entry whose conic is not
// positive definite (the edge minima assume it), or any NaN, is kept.
// cuda_raster.py::_box_keep is its plain mirror.
__device__ __forceinline__ bool box_keep(float x, float y, float a, float b,
                                         float c, float o, float bx0,
                                         float bx1, float by0, float by1,
                                         float alpha_min) {
  if (!(a > 0.0f && c > 0.0f && a * c > b * b)) return true;
  const float x0 = bx0 - x, x1 = bx1 - x;
  const float y0 = by0 - y, y1 = by1 - y;
  const bool inside = x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f && y1 >= 0.0f;
  const float qmin =
      inside ? 0.0f
             : min_nan(min_nan(edge_min(x0, y0, y1, a, c, b),
                               edge_min(x1, y0, y1, a, c, b)),
                       min_nan(edge_min(y0, x0, x1, c, a, b),
                               edge_min(y1, x0, x1, c, a, b)));
  const float dx = fmaxf(fabsf(x0), fabsf(x1));
  const float dy = fmaxf(fabsf(y0), fabsf(y1));
  const float slack =
      (a * dx * dx + 2.0f * fabsf(b) * dx * dy + c * dy * dy) * 0x1p-16f;
  const float q_max = 2.0f * logf(o / alpha_min);
  return !(qmin > q_max + 1e-3f + slack);
}

// Block b: sub-tile s = b % 4 (column half + 2 * row half) of tile b / 4.
template <int NV, bool STOP>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
composite_fwd_kernel(const long long* __restrict__ skeys,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ feat, int feat_cols,
                     long long rank_mask, int tiles_x, int width, int height,
                     float alpha_min, float alpha_max, float log_t_eps,
                     float* __restrict__ out, int* __restrict__ stop_out) {
  __shared__ float4 s_geo[BATCH];       // x, y, power floor, sorted position
  __shared__ float4 s_conic_o[BATCH];
  __shared__ float s_val[NV > 0 ? NV : 1][BATCH];
  // The pixel's state while a batch is culled: [weight sum, values...,
  // log T, T] and the stop.
  __shared__ float s_state[NV + 3][THREADS];
  __shared__ int s_last[STOP ? THREADS : 1];
  __shared__ int s_warp_kept[WARPS];

  // The stream's previous kernel may still be draining (see launch).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = static_cast<int>(blockIdx.x >> 2);
  const int sub = static_cast<int>(blockIdx.x & 3);
  const int bx = (t % tiles_x) * TILE + (sub & 1) * SUB;
  const int by = (t / tiles_x) * TILE + (sub >> 1) * SUB;
  if (bx >= width || by >= height) return;   // wholly past the image
  const int seg_start = starts[t];
  const int seg_end = ends[t];
  if (seg_start == seg_end) {
    // Row-major here: a warp stores two 64-byte rows.
    const int xi = bx + (tid & (SUB - 1)), yi = by + tid / SUB;
    if (xi < width && yi < height) {
      const size_t plane = static_cast<size_t>(width) * height;
      const size_t p = static_cast<size_t>(yi) * width + xi;
#pragma unroll
      for (int v = 0; v <= NV; ++v) out[v * plane + p] = 0.0f;
      if (STOP) stop_out[p] = seg_start;
    }
    return;
  }
  // Warp w covers the 8x4 pixels at ((w & 1) * 8, (w >> 1) * 4) of the
  // sub-tile, lane l the pixel (l & 7, l >> 3) of those.
  const int pxi = bx + (warp & 1) * 8 + (lane & 7);
  const int pyi = by + (warp >> 1) * 4 + (lane >> 3);
  const float px = static_cast<float>(pxi);
  const float py = static_cast<float>(pyi);

  float log_t = 0.0f;
  float trans = 1.0f;
  float wsum = 0.0f;
  float acc[NV > 0 ? NV : 1];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
  int last = seg_start;
  bool done = !(pxi < width && pyi < height);

  for (int b0 = seg_start; b0 < seg_end; b0 += BATCH) {
    // Also the barrier that keeps the previous batch's readers ahead of
    // this batch's stores.
    if (__syncthreads_count(done) == THREADS) break;
    s_state[0][tid] = wsum;
#pragma unroll
    for (int v = 0; v < NV; ++v) s_state[1 + v][tid] = acc[v];
    s_state[NV + 1][tid] = log_t;
    s_state[NV + 2][tid] = trans;
    if (STOP) s_last[tid] = last;

    const int k = b0 + tid;
    bool keep = false;
    const float* f = feat;
    if (k < seg_end) {
      f = feat + (skeys[k] & rank_mask) * feat_cols;
      keep = box_keep(f[0], f[1], f[2], f[3], f[4], f[5],
                      static_cast<float>(bx),
                      static_cast<float>(min(bx + SUB, width) - 1),
                      static_cast<float>(by),
                      static_cast<float>(min(by + SUB, height) - 1),
                      alpha_min);
    }
    // Stable compaction of the kept entries: warp ballots, then each warp's
    // offset from the counts of the warps before it.
    const unsigned ballot = __ballot_sync(FULL_MASK, keep);
    if (lane == 0) s_warp_kept[warp] = __popc(ballot);
    __syncthreads();
    int slot = __popc(ballot & ((1u << lane) - 1u));
    int n_kept = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int n = s_warp_kept[w];
      slot += w < warp ? n : 0;
      n_kept += n;
    }
    if (keep) {
      // Below this power the pair's alpha is under alpha_min: o e^power <
      // alpha_min, with a 1e-3 margin over the rounding of expf and logf
      // (composite_bwd.cu's floor).
      s_geo[slot] = make_float4(f[0], f[1], logf(alpha_min / f[5]) - 1e-3f,
                                __int_as_float(k));
      s_conic_o[slot] = make_float4(f[2], f[3], f[4], f[5]);
#pragma unroll
      for (int v = 0; v < NV; ++v) s_val[v][slot] = f[6 + v];
    }
    __syncthreads();

    wsum = s_state[0][tid];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = s_state[1 + v][tid];
    log_t = s_state[NV + 1][tid];
    trans = s_state[NV + 2][tid];
    if (STOP) last = s_last[tid];
    for (int i = 0; i < n_kept && !done; ++i) {
      const float4 g = s_geo[i];
      const float4 co = s_conic_o[i];
      const float power = w3::conic_power(co, px - g.x, py - g.y);
      const bool maybe = !(power < g.z);
      if (maybe) {
        const float alpha = fminf(alpha_max, co.w * expf(power));
        if (w3::alpha_live(power, alpha, alpha_min)) {
          const float log_t_after = log_t + log1pf(-alpha);
          if (log_t_after < log_t_eps) {
            done = true;
          } else {
            const float w = alpha * trans;
            wsum += w;
#pragma unroll
            for (int v = 0; v < NV; ++v) acc[v] += w * s_val[v][i];
            trans *= 1.0f - alpha;
            log_t = log_t_after;
            if (STOP) last = __float_as_int(g.w) + 1;
          }
        }
      }
    }
  }

  if (pxi < width && pyi < height) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pyi) * width + pxi;
    out[p] = wsum;
#pragma unroll
    for (int v = 0; v < NV; ++v) out[(v + 1) * plane + p] = acc[v];
    if (STOP) stop_out[p] = last;
  }
}

// Launched with programmatic stream serialization: the grid may be set up
// while the stream's previous kernel drains, and the kernel waits for that
// kernel's results (griddepcontrol.wait) before it reads or writes global
// memory, so stream order holds for what it reads and writes.
template <int NV, bool STOP>
cudaError_t launch(const void* skeys, const void* starts, const void* ends,
                   const void* feat, long long rank_mask, int tiles_x,
                   int tiles_y, int width, int height, float alpha_min,
                   float alpha_max, float log_t_eps, void* out, void* stop,
                   cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4 * tiles_x * tiles_y);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, composite_fwd_kernel<NV, STOP>,
      static_cast<const long long*>(skeys), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float*>(feat), 6 + NV,
      rank_mask, tiles_x, width, height, alpha_min, alpha_max, log_t_eps,
      static_cast<float*>(out), static_cast<int*>(stop));
}

template <bool STOP>
int dispatch(const void* skeys, const void* starts, const void* ends,
             const void* feat, int nv, int rank_bits, int tiles_x,
             int tiles_y, int width, int height, float alpha_min,
             float alpha_max, float log_t_eps, void* out, void* stop,
             void* stream) {
  if (nv < 0 || nv > w3::MAX_NV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles_x * tiles_y == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mask = (1LL << rank_bits) - 1;
  cudaError_t err = cudaErrorInvalidValue;
#define W3_CASE(N)                                                          \
  case N:                                                                   \
    err = launch<N, STOP>(skeys, starts, ends, feat, mask, tiles_x,         \
                          tiles_y, width, height, alpha_min, alpha_max,     \
                          log_t_eps, out, stop, s);                         \
    break;
  switch (nv) {
    W3_CASE(0) W3_CASE(1) W3_CASE(2) W3_CASE(3) W3_CASE(4)
    W3_CASE(5) W3_CASE(6) W3_CASE(7) W3_CASE(8) W3_CASE(9)
  }
#undef W3_CASE
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int composite_fwd_launch(const void* skeys, const void* starts,
                                    const void* ends, const void* feat,
                                    int nv, int rank_bits, int tiles_x,
                                    int tiles_y, int width, int height,
                                    float alpha_min, float alpha_max,
                                    float log_t_eps, void* out,
                                    void* stream) {
  return dispatch<false>(skeys, starts, ends, feat, nv, rank_bits, tiles_x,
                         tiles_y, width, height, alpha_min, alpha_max,
                         log_t_eps, out, nullptr, stream);
}

extern "C" int composite_train_fwd_launch(
    const void* skeys, const void* starts, const void* ends,
    const void* feat, int nv, int rank_bits, int tiles_x, int tiles_y,
    int width, int height, float alpha_min, float alpha_max,
    float log_t_eps, void* out, void* stop, void* stream) {
  return dispatch<true>(skeys, starts, ends, feat, nv, rank_bits, tiles_x,
                        tiles_y, width, height, alpha_min, alpha_max,
                        log_t_eps, out, stop, stream);
}

extern "C" const char* composite_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
