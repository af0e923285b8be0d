// composite_fwd / composite_train_fwd: front-to-back compositors over the
// sorted entry stream, one 32x32 tile per block.
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
//   w = alpha * exp(logT_before); out[0] += w (the weight sum, which is the
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
// ~12 float ops plus an exp; each weighted pair adds log1p, exp and
// 2 (1 + NV) ops. Bytes are small beside that: 8 bytes of key and
// 4 (6 + NV) bytes of features per entry, read once per tile, and
// 4 (1 + NV) (+ 4 for the stop) bytes per output pixel.
// Design: 1024 threads per block, one pixel each; the segment is staged
// through shared memory in batches of BATCH entries (one entry per loading
// thread, gathered by rank from the N-scale table, as the CUDA reference's
// point_list does, instead of sorting an E-scale payload); the block leaves
// as soon as every pixel is done (__syncthreads_count). Accurate expf /
// log1pf, no fast-math intrinsics.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using w3::THREADS;

constexpr int BATCH = 256;

template <int NV, bool STOP>
__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const long long* __restrict__ skeys,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ feat, int feat_cols,
                     long long rank_mask, int tiles_x, int width, int height,
                     float alpha_min, float alpha_max, float log_t_eps,
                     float* __restrict__ out, int* __restrict__ stop_out) {
  __shared__ float2 s_xy[BATCH];
  __shared__ float4 s_conic_o[BATCH];
  __shared__ float s_val[NV > 0 ? NV : 1][BATCH];

  const int t = blockIdx.x;
  const w3::Pixel pix = w3::tile_pixel(t, tiles_x, width, height);
  const float px = static_cast<float>(pix.x);
  const float py = static_cast<float>(pix.y);
  const int seg_start = starts[t];
  const int seg_end = ends[t];

  float log_t = 0.0f;
  float wsum = 0.0f;
  float acc[NV > 0 ? NV : 1];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
  int last = seg_start;
  bool done = !pix.in_image;

  for (int b0 = seg_start; b0 < seg_end; b0 += BATCH) {
    // Also the barrier that keeps the previous batch's readers ahead of
    // this batch's loads.
    if (__syncthreads_count(done) == THREADS) break;
    const int k = b0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < BATCH && k < seg_end) {
      const float* f = feat + (skeys[k] & rank_mask) * feat_cols;
      s_xy[threadIdx.x] = make_float2(f[0], f[1]);
      s_conic_o[threadIdx.x] = make_float4(f[2], f[3], f[4], f[5]);
#pragma unroll
      for (int v = 0; v < NV; ++v) s_val[v][threadIdx.x] = f[6 + v];
    }
    __syncthreads();
    const int nb = min(BATCH, seg_end - b0);
    for (int i = 0; i < nb && !done; ++i) {
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
      const float power = w3::conic_power(co, px - xy.x, py - xy.y);
      const float alpha = fminf(alpha_max, co.w * expf(power));
      // alpha == 0 for this pixel: no weight and log1p(-0) == 0, so the
      // transmittance and the include rule are unchanged.
      if (!w3::alpha_live(power, alpha, alpha_min)) continue;
      const float log_t_after = log_t + log1pf(-alpha);
      if (log_t_after < log_t_eps) {
        done = true;
        break;
      }
      const float w = alpha * expf(log_t);
      wsum += w;
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += w * s_val[v][i];
      log_t = log_t_after;
      if (STOP) last = b0 + i + 1;
    }
  }

  if (pix.in_image) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pix.y) * width + pix.x;
    out[p] = wsum;
#pragma unroll
    for (int v = 0; v < NV; ++v) out[(v + 1) * plane + p] = acc[v];
    if (STOP) stop_out[p] = last;
  }
}

template <int NV, bool STOP>
void launch(const void* skeys, const void* starts, const void* ends,
            const void* feat, long long rank_mask, int tiles_x, int tiles_y,
            int width, int height, float alpha_min, float alpha_max,
            float log_t_eps, void* out, void* stop, cudaStream_t s) {
  composite_fwd_kernel<NV, STOP><<<tiles_x * tiles_y, THREADS, 0, s>>>(
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
#define W3_CASE(N)                                                          \
  case N:                                                                   \
    launch<N, STOP>(skeys, starts, ends, feat, mask, tiles_x, tiles_y,      \
                    width, height, alpha_min, alpha_max, log_t_eps, out,    \
                    stop, s);                                               \
    break;
  switch (nv) {
    W3_CASE(0) W3_CASE(1) W3_CASE(2) W3_CASE(3) W3_CASE(4)
    W3_CASE(5) W3_CASE(6) W3_CASE(7) W3_CASE(8) W3_CASE(9)
  }
#undef W3_CASE
  return static_cast<int>(cudaGetLastError());
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
