// segsum: per-rank contiguous segment sum of the entries' gradient rows.
//
// Replaces: wheat3dgs_tpu/ops/pallas_raster.py::_segsum_kernel (pallas_call
//   at :607, from _segment_sum_sorted in comp_bwd).
//
// What it computes: out[r, c] = sum of vals[k, c] over the slots
// k in [seg_start[r], seg_end[r]) of the (E, COLS) slot-ordered rows that
// composite_bwd writes. Slots are grouped by their owning depth rank (the
// owner is monotone), so every rank's entries are one contiguous run and the
// per-entry rows need no second sort by owner: the TPU path re-sorts the
// gradients by owner and bf16-packs them first (:1464-1483); here the rows
// are float32 and already in place. The segments must be in rank order and
// must not overlap (seg_start[r + 1] >= seg_end[r]); empty ones are common.
//
// Bound on this card: bytes. Each summed row is read once (4 COLS bytes),
// each rank reads its two bounds and writes its row; one add per value.
// Design (the TPU kernel's partition, R_BLK consecutive ranks per grid
// step walking their joint slot span, rethought for this card):
// - a block owns THREADS consecutive ranks, one thread each; their rows are
//   one contiguous byte range of vals, which the block streams through two
//   16 KB shared-memory buffers with 16-byte cp.async copies (the range is
//   aligned down to 16 bytes; the last few floats of a chunk are copied one
//   by one), so the next chunk loads while this one is summed. The time is
//   the latency of each chunk's copy, so the chunks are large and the
//   blocks small (128 ranks): five blocks of an SM keep 80 KB in flight;
// - a segment of at most LONG_SEG slots is summed by its own thread from
//   shared memory, in slot order, in COLS registers: no shuffle, and an
//   empty segment costs a comparison;
// - a longer segment (up to MAX_SPAN = 1024 slots) would stall its warp, so
//   a whole warp strides its floats chunk by chunk, each lane on one
//   column, folds the lanes of each column with a short fixed shuffle tree
//   (2 shuffles at 10 columns, 1 at 15) and adds the chunk's sums to the
//   rank's row in shared memory, chunks in order;
// - the block's rows leave through shared memory as coalesced 16-byte
//   stores.
// Every sum runs in an order fixed by the inputs: no atomics, and two
// launches on the same inputs give bit-identical rows.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 128;     // ranks per block, one thread each
constexpr int WARPS = THREADS / 32;
constexpr int STAGE = 4096;      // floats per staging buffer (16 KB)
constexpr int LONG_SEG = 16;     // longer segments are summed by a warp

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying floats [a, b) of vals to dst[0, b - a); a is a multiple
// of 4 (16 bytes) and vals is 16-byte aligned. One commit group.
__device__ __forceinline__ void stage(float* dst, const float* vals, int a,
                                      int b) {
  const int n4 = (b - a) >> 2;
  for (int q = threadIdx.x; q < n4; q += THREADS) {
    cp_async16(dst + 4 * q, vals + a + 4 * q);
  }
  const int t = a + 4 * n4 + static_cast<int>(threadIdx.x);
  if (t < b) dst[t - a] = __ldg(vals + t);
  cp_async_commit();
}

template <int COLS>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ vals,
              const int* __restrict__ seg_start,
              const int* __restrict__ seg_end, int n,
              float* __restrict__ out) {
  constexpr int PER = 32 / COLS;     // lanes per column on the long path
  constexpr int SPAN = PER * COLS;
  // Slots per chunk: a chunk's floats plus up to 3 of alignment fit.
  constexpr int CH = (STAGE - 3) / COLS;
  __shared__ __align__(16) float s_buf[2][STAGE];
  __shared__ __align__(16) float s_out[THREADS * COLS];
  __shared__ int s_long_t[THREADS];   // long segments: local rank,
  __shared__ int s_long_s[THREADS];   //   start and end, in rank order
  __shared__ int s_long_e[THREADS];
  __shared__ int s_warp_long[WARPS];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = static_cast<int>(blockIdx.x) * THREADS;
  const int nr = min(THREADS, n - r0);
  int s = 0;
  int e = 0;
  if (tid < nr) {
    s = seg_start[r0 + tid];
    e = seg_end[r0 + tid];
  }
  const int lo = seg_start[r0];
  const int hi = seg_end[r0 + nr - 1];

  // The block's long segments, listed in rank order.
  const bool is_long = e - s > LONG_SEG;
  const unsigned ball = __ballot_sync(FULL_MASK, is_long);
  if (lane == 0) s_warp_long[warp] = __popc(ball);
  if (is_long) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) s_out[tid * COLS + c] = 0.0f;
  }
  __syncthreads();
  int first = 0;
  int n_long = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    first += w < warp ? s_warp_long[w] : 0;
    n_long += s_warp_long[w];
  }
  if (is_long) {
    const int i = first + __popc(ball & ((1u << lane) - 1u));
    s_long_t[i] = tid;
    s_long_s[i] = s;
    s_long_e[i] = e;
  }

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  const int n_chunks = hi > lo ? (hi - lo + CH - 1) / CH : 0;
  if (n_chunks > 0) {
    stage(s_buf[0], vals, (lo * COLS) & ~3, min(hi, lo + CH) * COLS);
  }
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = lo + j * CH;
    const int c1 = min(hi, c0 + CH);
    if (j + 1 < n_chunks) {
      stage(s_buf[(j + 1) & 1], vals, (c1 * COLS) & ~3,
            min(hi, c1 + CH) * COLS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // buf[k * COLS - off + c] is vals[k, c] for the chunk's slots k.
    const float* buf = s_buf[j & 1];
    const int off = (c0 * COLS) & ~3;

    if (!is_long) {
      const int ke = min(e, c1);
      for (int k = max(s, c0); k < ke; ++k) {
        const float* row = buf + (k * COLS - off);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] += row[c];
      }
    }
    for (int i = warp; i < n_long; i += WARPS) {
      const int ks = max(s_long_s[i], c0);
      const int ke = min(s_long_e[i], c1);
      if (ks >= ke) continue;                       // the whole warp skips
      // Lanes [0, SPAN) stride the rows' floats SPAN at a time, so lane l
      // always reads column l % COLS: one register a lane, and 32
      // consecutive words per load.
      float v = 0.0f;
      if (lane < SPAN) {
        for (int p = ks * COLS - off + lane; p < ke * COLS - off; p += SPAN) {
          v += buf[p];
        }
      }
      // Fold the PER lanes of each column into lanes [0, COLS): a fixed
      // tree over the lane groups g = lane / COLS.
#pragma unroll
      for (int sh = 1; sh < PER; sh <<= 1) {
        const float o = __shfl_down_sync(FULL_MASK, v, sh * COLS);
        const int g = lane / COLS;
        if ((g & (2 * sh - 1)) == 0 && g + sh < PER) v += o;
      }
      if (lane < COLS) s_out[s_long_t[i] * COLS + lane] += v;
    }
    // The next iteration refills this buffer.
    __syncthreads();
  }
  if (!is_long) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) s_out[tid * COLS + c] = acc[c];
  }
  __syncthreads();

  // Rank r0's row starts a multiple of 4 THREADS COLS bytes into out:
  // 16-byte aligned.
  const int nf = nr * COLS;
  float* dst = out + static_cast<size_t>(r0) * COLS;
  for (int q = tid; q < nf / 4; q += THREADS) {
    reinterpret_cast<float4*>(dst)[q] =
        reinterpret_cast<const float4*>(s_out)[q];
  }
  const int t = (nf & ~3) + tid;
  if (t < nf) dst[t] = s_out[t];
}

}  // namespace

extern "C" int segsum_launch(const void* vals, const void* seg_start,
                             const void* seg_end, int n, int cols, void* out,
                             void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const float* v = static_cast<const float*>(vals);
  const int* a = static_cast<const int*>(seg_start);
  const int* b = static_cast<const int*>(seg_end);
  float* o = static_cast<float*>(out);
#define W3_CASE(C)                                                           \
  case C:                                                                    \
    segsum_kernel<C><<<blocks, THREADS, 0, s>>>(v, a, b, n, o);              \
    break;
  switch (cols) {
    W3_CASE(1) W3_CASE(2) W3_CASE(3) W3_CASE(4) W3_CASE(5)
    W3_CASE(6) W3_CASE(7) W3_CASE(8) W3_CASE(9) W3_CASE(10)
    W3_CASE(11) W3_CASE(12) W3_CASE(13) W3_CASE(14) W3_CASE(15)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef W3_CASE
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
