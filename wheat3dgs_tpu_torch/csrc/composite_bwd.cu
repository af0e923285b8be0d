// composite_bwd: the training compositor's backward replay, one 32x32 tile
// per block, writing one gradient row per entry.
//
// Replaces: wheat3dgs_tpu/ops/pallas_raster.py::_bwd_kernel (pallas_call at
//   :1449, from _composite_fns.comp_bwd under rasterize_pallas's custom_vjp).
//
// What it computes. Inputs: the forward's image rows img (1 + NV, H, W) =
// [weight sum, values...], its per-pixel stop (one past the last included
// sorted position), and the image's cotangent g (1 + NV, H, W). The weight
// sum is treated as a value row of ones; then JAX's separate T_final chain
// (-g_T T_final / (1 - alpha_k)) is already inside the suffix term, since
// sum_{j>k} w_j = T_{k+1} - T_final. Per pixel, walking front to back
// exactly as the forward does, up to its stop:
//   A      = sum_rows g_row img_row                (the suffix total),
//   u_k    = g_0 + sum_v g_{1+v} value_k_v,
//   P_k    = sum_{j<=k} w_j u_j,
//   dα_k   = T_before u_k - (A - P_k) / (1 - α_k), zero unless the entry is
//            live at the pixel and its raw o e^power < alpha_max (:980),
//   dpow_k = dα_k α_k.
// Per entry, summed over the tile's pixels (its 6 + NV gradient columns):
//   d (x, y)     = Σ dpow (a dx + b dy, b dx + c dy),
//   d (a, b, c)  = Σ dpow (-dx²/2, -dx dy, -dy²/2),
//   d opacity    = Σ dα e^power,
//   d value_v    = Σ w g_{1+v}.
// The row goes once to the entry's pre-sort slot perm[k] of the (E, 6 + NV)
// output, which the wrapper zero-fills, so entries no pixel reached keep
// exact zeros (JAX's aliased zero seed). Every entry belongs to one tile,
// so no slot is written twice and the TPU kernel's cross-tile carry of a
// shared 128-entry window has no counterpart.
//
// Bound on this card: operations. A visited (pixel, entry) pair replays the
// forward's ~12 ops and exp; a weighted pair adds ~25 + 3 NV ops, exp and
// log1p; bytes are the features per entry, the 3 (1 + NV) + 1 words per
// pixel and the (6 + NV) output row per entry.
// Design: as the forward, one pixel a thread and BATCH entries staged in
// shared memory. The per-entry sums are deterministic: a warp-shuffle tree
// per column (skipped, with zeros stored, when no lane of the warp touched
// the entry), the 32 warp partials in shared memory, then one fixed-order
// sum per (entry, column). No atomics on the output. Float32 throughout,
// accurate expf / log1pf; the direct form, not the TPU's moment matmuls.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using w3::THREADS;

constexpr int WARPS = THREADS / 32;
constexpr int BATCH = 16;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int NV>
__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const long long* __restrict__ skeys,
                     const long long* __restrict__ perm,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const float* __restrict__ feat, long long rank_mask,
                     int tiles_x, int width, int height, float alpha_min,
                     float alpha_max, const float* __restrict__ img,
                     const int* __restrict__ stop,
                     const float* __restrict__ grad,
                     float* __restrict__ out) {
  constexpr int COLS = 6 + NV;
  __shared__ float2 s_xy[BATCH];
  __shared__ float4 s_conic_o[BATCH];
  __shared__ float s_val[NV > 0 ? NV : 1][BATCH];
  __shared__ float s_part[WARPS][BATCH][COLS];
  __shared__ int s_walk_end;

  const int t = blockIdx.x;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const w3::Pixel pix = w3::tile_pixel(t, tiles_x, width, height);
  const float px = static_cast<float>(pix.x);
  const float py = static_cast<float>(pix.y);
  const int seg_start = starts[t];

  // The pixel's cotangent rows and suffix total; pixels outside the image
  // stop at the segment start and touch nothing.
  int my_stop = seg_start;
  float g0 = 0.0f;
  float gv[NV > 0 ? NV : 1];
#pragma unroll
  for (int v = 0; v < NV; ++v) gv[v] = 0.0f;
  float a_total = 0.0f;
  if (pix.in_image) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pix.y) * width + pix.x;
    my_stop = stop[p];
    g0 = grad[p];
    a_total = g0 * img[p];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      gv[v] = grad[(v + 1) * plane + p];
      a_total += gv[v] * img[(v + 1) * plane + p];
    }
  }
  if (threadIdx.x == 0) s_walk_end = seg_start;
  __syncthreads();
  if (my_stop > seg_start) atomicMax(&s_walk_end, my_stop);
  __syncthreads();
  const int walk_end = s_walk_end;

  float log_t = 0.0f;
  float prefix = 0.0f;
  for (int b0 = seg_start; b0 < walk_end; b0 += BATCH) {
    const int nb = min(BATCH, walk_end - b0);
    if (static_cast<int>(threadIdx.x) < nb) {
      const float* f =
          feat + (skeys[b0 + threadIdx.x] & rank_mask) * COLS;
      s_xy[threadIdx.x] = make_float2(f[0], f[1]);
      s_conic_o[threadIdx.x] = make_float4(f[2], f[3], f[4], f[5]);
#pragma unroll
      for (int v = 0; v < NV; ++v) s_val[v][threadIdx.x] = f[6 + v];
    }
    __syncthreads();

    for (int i = 0; i < nb; ++i) {
      float c[COLS];
#pragma unroll
      for (int col = 0; col < COLS; ++col) c[col] = 0.0f;
      bool hit = false;
      if (b0 + i < my_stop) {
        const float2 xy = s_xy[i];
        const float4 co = s_conic_o[i];
        const float dx = px - xy.x;
        const float dy = py - xy.y;
        const float power = w3::conic_power(co, dx, dy);
        const float ep = expf(power);
        const float raw = co.w * ep;
        const float alpha = fminf(alpha_max, raw);
        if (w3::alpha_live(power, alpha, alpha_min)) {
          const float t_before = expf(log_t);
          const float w = alpha * t_before;
          float u = g0;
#pragma unroll
          for (int v = 0; v < NV; ++v) u += gv[v] * s_val[v][i];
          prefix += w * u;
          const float dalpha =
              raw < alpha_max
                  ? t_before * u - (a_total - prefix) / (1.0f - alpha)
                  : 0.0f;
          const float dpow = dalpha * alpha;
          c[0] = dpow * (co.x * dx + co.y * dy);
          c[1] = dpow * (co.y * dx + co.z * dy);
          c[2] = -0.5f * dpow * dx * dx;
          c[3] = -dpow * dx * dy;
          c[4] = -0.5f * dpow * dy * dy;
          c[5] = dalpha * ep;
#pragma unroll
          for (int v = 0; v < NV; ++v) c[6 + v] = w * gv[v];
          log_t += log1pf(-alpha);
          hit = true;
        }
      }
      if (__any_sync(FULL_MASK, hit)) {
#pragma unroll
        for (int col = 0; col < COLS; ++col) {
          float x = c[col];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            x += __shfl_down_sync(FULL_MASK, x, off);
          }
          c[col] = x;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int col = 0; col < COLS; ++col) s_part[warp][i][col] = c[col];
      }
    }
    __syncthreads();

    // Fixed-order sum of the warp partials, one (entry, column) a thread.
    for (int q = threadIdx.x; q < nb * COLS; q += THREADS) {
      const int i = q / COLS;
      const int col = q - i * COLS;
      float s = 0.0f;
#pragma unroll 8
      for (int w = 0; w < WARPS; ++w) s += s_part[w][i][col];
      out[perm[b0 + i] * COLS + col] = s;
    }
    // The next batch overwrites the staged entries and the partials.
    __syncthreads();
  }
}

template <int NV>
void launch(const void* skeys, const void* perm, const void* starts,
            const void* ends, const void* feat, long long rank_mask,
            int tiles_x, int tiles_y, int width, int height, float alpha_min,
            float alpha_max, const void* img, const void* stop,
            const void* grad, void* out, cudaStream_t s) {
  composite_bwd_kernel<NV><<<tiles_x * tiles_y, THREADS, 0, s>>>(
      static_cast<const long long*>(skeys),
      static_cast<const long long*>(perm), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float*>(feat),
      rank_mask, tiles_x, width, height, alpha_min, alpha_max,
      static_cast<const float*>(img), static_cast<const int*>(stop),
      static_cast<const float*>(grad), static_cast<float*>(out));
}

}  // namespace

extern "C" int composite_bwd_launch(
    const void* skeys, const void* perm, const void* starts,
    const void* ends, const void* feat, int nv, int rank_bits, int tiles_x,
    int tiles_y, int width, int height, float alpha_min, float alpha_max,
    const void* img, const void* stop, const void* grad, void* out,
    void* stream) {
  if (nv < 0 || nv > w3::MAX_NV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles_x * tiles_y == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mask = (1LL << rank_bits) - 1;
#define W3_CASE(N)                                                          \
  case N:                                                                   \
    launch<N>(skeys, perm, starts, ends, feat, mask, tiles_x, tiles_y,      \
              width, height, alpha_min, alpha_max, img, stop, grad, out,    \
              s);                                                           \
    break;
  switch (nv) {
    W3_CASE(0) W3_CASE(1) W3_CASE(2) W3_CASE(3) W3_CASE(4)
    W3_CASE(5) W3_CASE(6) W3_CASE(7) W3_CASE(8) W3_CASE(9)
  }
#undef W3_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
