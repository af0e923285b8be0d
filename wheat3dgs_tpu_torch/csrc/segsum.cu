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
// are float32 and already in place.
//
// Bound on this card: bytes. Each slot row is read once (4 COLS bytes),
// each rank reads its two bounds and writes its row; one add per value.
// Design: one warp per rank; the lanes stride the segment (at most
// MAX_SPAN = 1024 slots) and keep COLS partial sums in registers, then a
// shuffle tree per column, so the result does not depend on the schedule.
// Neighbouring ranks' segments are neighbours in memory, so a block's warps
// read one contiguous stretch of the rows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <int COLS>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ vals,
              const int* __restrict__ seg_start,
              const int* __restrict__ seg_end, int n,
              float* __restrict__ out) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long r = gid >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  if (r >= n) return;  // the whole warp shares r
  const int s = seg_start[r];
  const int e = seg_end[r];
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
  for (int k = s + lane; k < e; k += 32) {
    const float* row = vals + static_cast<size_t>(k) * COLS;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] += row[c];
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] += __shfl_down_sync(FULL_MASK, acc[c], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) out[r * COLS + c] = acc[c];
  }
}

}  // namespace

extern "C" int segsum_launch(const void* vals, const void* seg_start,
                             const void* seg_end, int n, int cols, void* out,
                             void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (static_cast<long long>(n) * 32 + THREADS - 1) /
                           THREADS;
  const float* v = static_cast<const float*>(vals);
  const int* a = static_cast<const int*>(seg_start);
  const int* b = static_cast<const int*>(seg_end);
  float* o = static_cast<float*>(out);
#define W3_CASE(C)                                                           \
  case C:                                                                    \
    segsum_kernel<C><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(      \
        v, a, b, n, o);                                                      \
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
