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
// shared memory. The parts of the time, in the order the design meets
// them (PERF.md §6 has the measurements):
// - summing each entry's 6 + NV columns over the tile's pixels. A warp
//   with a live lane for an entry folds its columns with transposed warp
//   reductions (warp_transpose_sum: about one shuffle per column, against
//   five for a tree per column), first the 6 geometry columns, then the NV
//   value columns, and as many lanes store the warp's partials at once.
//   Its selects are bitwise and its loops unrolled by template recursion:
//   written as nested loops, the compiler kept a loop and picked registers
//   by predicated moves;
// - walking pairs that cannot be live. Each staged entry carries the power
//   below which its alpha is under alpha_min; a warp none of whose lanes
//   is above it skips the entry after the conic (a footprint covers a few
//   of the tile's rows: on the bench view half the walked (warp, entry)
//   steps have no live lane), and a warp stops a batch at the largest stop
//   among its pixels. A warp with no live lane stores nothing;
// - the exp and log1p of the transmittance: it is carried as a running
//   product, T *= 1 - alpha, where the forward keeps its logarithm for the
//   stop rule (the stop is the forward's, so the replay needs only the
//   values). The alpha takes the forward's accurate expf, so both agree on
//   which pairs are live;
// - waiting at block barriers: a batch lasts as long as the tile's busiest
//   row. Two blocks (tiles) share each SM, so one walks while the other
//   waits: at most 32 registers a thread, so the pixels' cotangent rows
//   and suffix totals live in shared memory and the columns are summed in
//   the two parts above; BATCH is 64 entries (32 where two blocks' shared
//   memory would not fit), three barriers per batch. The partials live in
//   dynamic shared memory as [warp][entry][column], so the cross-warp sum,
//   one (entry, column) a thread, reads 32 consecutive words per warp
//   instruction whichever warp each thread is at: no bank conflicts. Each
//   entry's warp mask tells it which warps to add, in warp order: a fixed
//   order (a skipped warp's term is an exact zero). No atomics on the
//   output, and two launches give bit-identical rows.
// Float32 throughout; the direct form, not the TPU's moment matmuls.
//
// The BF16 build (composite_bwd_bf16_launch; cuda_raster's bf16_ops, on
// request only) rounds what the TPU kernel rounds (:964-990): its three
// products take bfloat16 operands and sum in float32. Each pixel's value
// row cotangents and each staged entry's value rows are rounded as they
// are staged (u = sum_v g_v value_v), each value-row prefix term w u_v is
// rounded before it is added, and the weight of d value_v = Σ w g_v is
// rounded with its g_v. The weight-sum row's part (g_0 in u, w g_0 in the
// prefix) stays float32 as JAX's a2 / T_final route does, and so do the
// suffix total A, the transmittance and the geometry sums. The default
// build's code is unchanged: every difference sits behind the template
// flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using w3::THREADS;

constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
// An SM's shared memory, and a bound on what a block holds besides its
// dynamic part (the static arrays, and 1 KB the system reserves).
constexpr int SM_SHARED = 233472;
constexpr int BLOCK_OTHER = 8192;

// A block's dynamic shared memory at a batch size: the warp partials
// [WARPS][batch][6 + nv], then one column per pixel of its nv cotangent
// value rows [nv][THREADS], its g_0 [THREADS] and its suffix total
// [THREADS].
__host__ __device__ constexpr int dyn_bytes(int nv, int batch) {
  return (WARPS * batch * (6 + nv) + (nv + 2) * THREADS) * 4;
}

// Entries per batch: 64 where two blocks fit in an SM's shared memory,
// else 32.
__host__ __device__ constexpr int batch_size(int nv) {
  return 2 * (dyn_bytes(nv, 64) + BLOCK_OTHER) <= SM_SHARED ? 64 : 32;
}
static_assert(2 * (dyn_bytes(w3::MAX_NV, 32) + BLOCK_OTHER) <= SM_SHARED,
              "two blocks must fit in an SM");
// One thread per (entry, column) of a batch in the cross-warp sum.
static_assert(64 * (6 + w3::MAX_NV) <= THREADS, "batch too large");

// The smallest power of two >= c, for c in 1..32.
__host__ __device__ constexpr int pow2_at_least(int c) {
  return c <= 1 ? 1 : 2 * pow2_at_least((c + 1) / 2);
}

// One step of warp_transpose_sum: N partial columns live in v[0, N); lanes
// whose bit M is set keep the odd ones, the others the even ones, and each
// sends the other half to its partner lane ^ M. The selects are bitwise
// (and every index is a compile-time constant), so the step has no branch
// and indexes no register array at run time.
template <int N, int M, int W>
__device__ __forceinline__ void fold_columns(float (&v)[W], int lane) {
  if constexpr (N > 1) {
    const unsigned odd = (lane & M) != 0 ? 0xffffffffu : 0u;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const unsigned a = __float_as_uint(v[2 * j]);
      const unsigned b = __float_as_uint(v[2 * j + 1]);
      const float keep = __uint_as_float((a & ~odd) | (b & odd));
      const float send = __uint_as_float((b & ~odd) | (a & odd));
      v[j] = keep + __shfl_xor_sync(FULL_MASK, send, M);
    }
    fold_columns<N / 2, M * 2, W>(v, lane);
  } else {
    // The lanes that differ only in the remaining bits hold the same
    // column: add them up.
#pragma unroll
    for (int m = M; m < 32; m <<= 1) {
      v[0] += __shfl_xor_sync(FULL_MASK, v[0], m);
    }
  }
}

// Sums v[0..W) over the warp's 32 lanes and returns the sum of column
// (lane & (W - 1)); W is a power of two <= 32 and all 32 lanes call it.
// One 5-step shuffle tree per column would take 5 W shuffles, with the W
// sums in lane 0 to store one after the other. This transposed reduction
// takes W - 1 + (5 - log2 W): 16 at W = 16, 9 at W = 8 (fewer where a pair
// of columns is the zero padding). At each step a lane keeps half of its
// columns, so afterwards W lanes hold W different sums and store at once.
// The pairings form a fixed tree, so the sums do not depend on the
// schedule. v is scratch.
template <int W>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[W]) {
  static_assert(W >= 1 && W <= 32 && (W & (W - 1)) == 0,
                "W must be a power of two <= 32");
  fold_columns<W, 1, W>(v, static_cast<int>(threadIdx.x) & 31);
  return v[0];
}

// x rounded to bfloat16 (to nearest, ties to even) and back: an operand of
// a one-pass bfloat16 MXU product.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two blocks (tiles) per SM, so at most 32 registers a thread (ptxas gets
// --register-usage-level=2 to fit that without spilling, ops/cuda_build.py).
// BF16: the TPU's rounding of the replay's products (see the top).
template <int NV, bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
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
  constexpr int BATCH = batch_size(NV);
  __shared__ float2 s_xy[BATCH];
  __shared__ float4 s_conic_o[BATCH];
  __shared__ float s_power_min[BATCH];
  __shared__ float s_val[NV > 0 ? NV : 1][BATCH];
  __shared__ unsigned s_warps[BATCH];   // per entry: warps with a partial
  __shared__ int s_walk_end;
  extern __shared__ float s_part[];     // [WARPS][BATCH][COLS]

  const int t = blockIdx.x;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const w3::Pixel pix = w3::tile_pixel(t, tiles_x, width, height);
  const float px = static_cast<float>(pix.x);
  const float py = static_cast<float>(pix.y);
  const int seg_start = starts[t];

  // The pixel's cotangent rows and suffix total, one shared-memory column
  // per thread (in registers they would keep the second block off the
  // SM); pixels outside the image stop at the segment start and touch
  // nothing.
  float* const s_gv = s_part + WARPS * BATCH * COLS;
  float* const s_g0 = s_gv + NV * THREADS;
  float* const s_a = s_g0 + THREADS;
  int my_stop = seg_start;
  float g0 = 0.0f;
  float a_total = 0.0f;
#pragma unroll
  for (int v = 0; v < NV; ++v) s_gv[v * THREADS + tid] = 0.0f;
  if (pix.in_image) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(pix.y) * width + pix.x;
    my_stop = stop[p];
    g0 = grad[p];
    a_total = g0 * img[p];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float g = grad[(v + 1) * plane + p];
      s_gv[v * THREADS + tid] = BF16 ? bf16_round(g) : g;
      a_total += g * img[(v + 1) * plane + p];
    }
  }
  s_g0[tid] = g0;
  s_a[tid] = a_total;
  if (tid == 0) s_walk_end = seg_start;
  __syncthreads();
  if (my_stop > seg_start) atomicMax(&s_walk_end, my_stop);
  __syncthreads();
  const int walk_end = s_walk_end;

  float trans = 1.0f;      // transmittance before the next entry
  float prefix = 0.0f;
  for (int b0 = seg_start; b0 < walk_end; b0 += BATCH) {
    const int nb = min(BATCH, walk_end - b0);
    if (tid < nb) {
      const float* f = feat + (skeys[b0 + tid] & rank_mask) * COLS;
      s_xy[tid] = make_float2(f[0], f[1]);
      s_conic_o[tid] = make_float4(f[2], f[3], f[4], f[5]);
      // Below this power the pair's alpha is under alpha_min: o e^power <
      // alpha_min. With a margin (1e-3, far above the rounding of expf and
      // logf), so no pair the forward included is skipped here.
      s_power_min[tid] = logf(alpha_min / f[5]) - 1e-3f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        s_val[v][tid] = BF16 ? bf16_round(f[6 + v]) : f[6 + v];
      }
    }
    if (tid < BATCH) s_warps[tid] = 0u;
    __syncthreads();

    // Entries past every lane's stop are not walked. (The warp's stop is
    // taken anew each batch: one register fewer across the walk.)
    const int walk = min(nb, __reduce_max_sync(FULL_MASK, my_stop) - b0);
    for (int i = 0; i < walk; ++i) {
      float c[8];
#pragma unroll
      for (int col = 0; col < 8; ++col) c[col] = 0.0f;
      float wt = 0.0f;
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
      const float dx = px - xy.x;
      const float dy = py - xy.y;
      const float power = w3::conic_power(co, dx, dy);
      const bool maybe = b0 + i < my_stop && power >= s_power_min[i];
      // Most warps lie wholly outside an entry's footprint: they skip it.
      if (!__any_sync(FULL_MASK, maybe)) continue;
      bool hit = false;
      if (maybe) {
        const float ep = expf(power);
        const float raw = co.w * ep;
        const float alpha = fminf(alpha_max, raw);
        if (w3::alpha_live(power, alpha, alpha_min)) {
          const float t_before = trans;
          const float w = alpha * t_before;
          float u;
          if constexpr (BF16) {
            float u_v = 0.0f;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              u_v += s_gv[v * THREADS + tid] * s_val[v][i];
            }
            const float g0 = s_g0[tid];
            u = g0 + u_v;
            prefix += bf16_round(w * u_v) + w * g0;
          } else {
            u = s_g0[tid];
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              u += s_gv[v * THREADS + tid] * s_val[v][i];
            }
            prefix += w * u;
          }
          const float dalpha =
              raw < alpha_max
                  ? t_before * u - __fdividef(s_a[tid] - prefix, 1.0f - alpha)
                  : 0.0f;
          const float dpow = dalpha * alpha;
          c[0] = dpow * (co.x * dx + co.y * dy);
          c[1] = dpow * (co.y * dx + co.z * dy);
          c[2] = -0.5f * dpow * dx * dx;
          c[3] = -dpow * dx * dy;
          c[4] = -0.5f * dpow * dy * dy;
          c[5] = dalpha * ep;
          wt = w;
          trans = t_before * (1.0f - alpha);
          hit = true;
        }
      }
      // The geometry columns, then the value columns (w g_v, from wt): two
      // reductions, so fewer registers are live at once.
      if (__any_sync(FULL_MASK, hit)) {
        const float sum = warp_transpose_sum<8>(c);
        if (lane < 6) s_part[(warp * BATCH + i) * COLS + lane] = sum;
        if constexpr (NV > 0) {
          constexpr int WV = pow2_at_least(NV);
          const float wv = BF16 ? bf16_round(wt) : wt;
          float cv[WV];
#pragma unroll
          for (int v = 0; v < NV; ++v) cv[v] = wv * s_gv[v * THREADS + tid];
#pragma unroll
          for (int v = NV; v < WV; ++v) cv[v] = 0.0f;
          const float sv = warp_transpose_sum<WV>(cv);
          if (lane < NV) s_part[(warp * BATCH + i) * COLS + 6 + lane] = sv;
        }
        if (lane == 0) atomicOr(&s_warps[i], 1u << warp);
      }
    }
    __syncthreads();

    // Fixed-order sum of the warp partials, one (entry, column) a thread.
    for (int q = tid; q < nb * COLS; q += THREADS) {
      const int i = q / COLS;
      float s = 0.0f;
      for (unsigned m = s_warps[i]; m != 0u; m &= m - 1u) {
        s += s_part[(__ffs(static_cast<int>(m)) - 1) * (BATCH * COLS) + q];
      }
      out[perm[b0 + i] * COLS + (q - i * COLS)] = s;
    }
    // The next batch overwrites the staged entries, masks and partials.
    __syncthreads();
  }
}

template <int NV, bool BF16>
cudaError_t launch(const void* skeys, const void* perm, const void* starts,
                   const void* ends, const void* feat, long long rank_mask,
                   int tiles_x, int tiles_y, int width, int height,
                   float alpha_min, float alpha_max, const void* img,
                   const void* stop, const void* grad, void* out,
                   cudaStream_t s) {
  // Above 48 KB of dynamic shared memory only after opting in.
  const cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel<NV, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      dyn_bytes(NV, batch_size(NV)));
  if (err != cudaSuccess) return err;
  composite_bwd_kernel<NV, BF16><<<tiles_x * tiles_y, THREADS,
                                   dyn_bytes(NV, batch_size(NV)), s>>>(
      static_cast<const long long*>(skeys),
      static_cast<const long long*>(perm), static_cast<const int*>(starts),
      static_cast<const int*>(ends), static_cast<const float*>(feat),
      rank_mask, tiles_x, width, height, alpha_min, alpha_max,
      static_cast<const float*>(img), static_cast<const int*>(stop),
      static_cast<const float*>(grad), static_cast<float*>(out));
  return cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* skeys, const void* perm, const void* starts,
             const void* ends, const void* feat, int nv, int rank_bits,
             int tiles_x, int tiles_y, int width, int height,
             float alpha_min, float alpha_max, const void* img,
             const void* stop, const void* grad, void* out, void* stream) {
  if (nv < 0 || nv > w3::MAX_NV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles_x * tiles_y == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mask = (1LL << rank_bits) - 1;
  cudaError_t err = cudaErrorInvalidValue;
#define W3_CASE(N)                                                          \
  case N:                                                                   \
    err = launch<N, BF16>(skeys, perm, starts, ends, feat, mask, tiles_x,   \
                          tiles_y, width, height, alpha_min, alpha_max,     \
                          img, stop, grad, out, s);                         \
    break;
  switch (nv) {
    W3_CASE(0) W3_CASE(1) W3_CASE(2) W3_CASE(3) W3_CASE(4)
    W3_CASE(5) W3_CASE(6) W3_CASE(7) W3_CASE(8) W3_CASE(9)
  }
#undef W3_CASE
  return static_cast<int>(err);
}

}  // namespace

extern "C" int composite_bwd_launch(
    const void* skeys, const void* perm, const void* starts,
    const void* ends, const void* feat, int nv, int rank_bits, int tiles_x,
    int tiles_y, int width, int height, float alpha_min, float alpha_max,
    const void* img, const void* stop, const void* grad, void* out,
    void* stream) {
  return dispatch<false>(skeys, perm, starts, ends, feat, nv, rank_bits,
                         tiles_x, tiles_y, width, height, alpha_min,
                         alpha_max, img, stop, grad, out, stream);
}

// The BF16 build: the TPU's rounding of the replay's products.
extern "C" int composite_bwd_bf16_launch(
    const void* skeys, const void* perm, const void* starts,
    const void* ends, const void* feat, int nv, int rank_bits, int tiles_x,
    int tiles_y, int width, int height, float alpha_min, float alpha_max,
    const void* img, const void* stop, const void* grad, void* out,
    void* stream) {
  return dispatch<true>(skeys, perm, starts, ends, feat, nv, rank_bits,
                        tiles_x, tiles_y, width, height, alpha_min,
                        alpha_max, img, stop, grad, out, stream);
}

extern "C" const char* composite_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
