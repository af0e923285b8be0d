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
//     tri[i][j] = (i <= j), as the TPU runs it on its matrix unit; here on
//     the tensor cores (mma.sync m16n8k8, TF32), below;
//   - CUMSUM: each lane sums its 4 values serially, then a warp
//     __shfl_up_sync scan of the lane totals adds each lane's prefix;
//   - ROLL: the 7 Hillis-Steele log-shift steps,
//     s[i] += (i >= k) ? s[i - k] : 0 for k = 1, 2, ..., 64 (the roll and the
//     `lane >= k` mask of prof_scan.py:34-38), by warp shuffles.
//
// Bound on this card: the function's operations (the block is read once and
// written once, 512 KiB each at rows = 1024; a step is 4 operations a value)
// take ~2 us over 256 steps, but the steps form a chain: each needs the
// whole block's max of the step before. So the time is 256 serial
// block-wide maxima, each a reduction across the SMs that hold the block,
// plus each step's scan latency.
//
// Design: one thread-block cluster of CLUSTER = 16 CTAs (a non-portable
// size; the portable 8, at 128 rows a CTA, measured slower for every kind)
// of 256 threads, launched with cudaLaunchKernelEx; no grid barrier.
// The block is at most MAX_ROWS = 1024 rows; CTA c holds rows
// [64 c, 64 c + 64) in registers for all steps, a warp per 8 rows, 32
// values a thread. Rows past the end are zeros, so a CTA without rows
// contributes 0 to every max and takes part in every exchange. Per step
// each warp scans its rows, reduces its max (redux.sync on the float bits:
// |s| >= 0, so the bits order as the values do) and folds it into its CTA's
// with a shared atomic max; after one __syncthreads, warp 0 stores the
// CTA's max, tagged with the step, as one 64-bit word into a slot of every
// CTA's shared memory (distributed shared memory, st.shared::cluster), and
// every thread polls its own CTA's 16 slots until all carry this step's
// tag. The max is independent of order, so two launches are bit-identical.
// One cluster barrier before the loop lets every CTA start and clear its
// slots; one after it keeps every CTA resident until no other can still
// store into it.
//
// Slots: two, by step parity. A CTA stores step s + 2's max into another
// CTA's slot only after it has read that CTA's step s + 1 max, which the
// other sent only after its __syncthreads of step s + 1, which each of its
// threads reaches only after it has read its step s slots. So no slot is
// overwritten before it is read, and no further barrier is needed.
//
// MATMUL on the tensor cores, D = T^T X^T: the triangle is the A operand
// (computed from the (m, k) indices: all ones, or one of the two diagonal
// 16 x 8 blocks; blocks wholly below the diagonal add exact zeros for
// finite inputs and are skipped) and each warp's 8 rows, staged through
// shared memory (rows padded to 132 floats: no bank conflict), are B. Each
// row's k-tile of 8 values is scaled by a power of two to below 2 and split
// into three TF32 pieces on the grids 2^-10, 2^-21, 2^-32, so every product
// is exact, the tensor cores sum lo + mid exactly and add hi rounding once
// (toward zero), and an fmaf scales the sum back into the row. Scaling
// matters: the tensor cores flush subnormal operands, the probe's later
// steps hold values down to the smallest subnormal in the first columns,
// and the chain of scans amplifies what those columns hold (unscaled
// pieces were 3.4e-5 of the block max off the plain version after 256
// steps). The result differs from the plain version only in the order and
// rounding of float32 sums (the reason for its 1e-5 tolerance).
//
// The C entry point keeps the argument list of the earlier grid-barrier
// design of this kernel, so both designs load under one wrapper; this one
// keeps its partial maxima in the cluster's shared memory and does not read
// `partial`.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 128;                       // values per row (TPU lanes)
constexpr int PER_LANE = C / 32;             // a lane's values of one row
constexpr int CLUSTER = 16;                  // CTAs in the cluster
constexpr int MAX_ROWS = 1024;               // rows one cluster holds
constexpr int CTA_ROWS = MAX_ROWS / CLUSTER;
constexpr int WARPS = CTA_ROWS / 8;          // a warp per 8 rows
constexpr int THREADS = WARPS * 32;
constexpr int NV = CTA_ROWS * C / THREADS;   // values a thread holds
constexpr int STRIDE = C + 4;                // MATMUL: shared-memory row
constexpr size_t SMEM_BYTES = sizeof(float) * CTA_ROWS * STRIDE;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr uint32_t TF32_ONE = 0x3f800000u;
enum Kind { MATMUL = 0, CUMSUM = 1, ROLL = 2 };

static_assert(NV == 32, "MATMUL: 8 m-tiles x 4 values a thread");

// CTA-local (row, col) of value i of this thread. CUMSUM and ROLL: row
// warp * 8 + i / 4, the lane's 4 neighbouring columns.
// MATMUL: the accumulator layout of mma.m16n8k8 for D = T^T X^T, whose
// rows are columns of the block and whose columns are its rows: m-tile
// i / 4 holds columns 16 (i / 4) + g (+ 8), rows 8 warp + 2 t (+ 1).
template <int KIND>
__device__ __forceinline__ void place(int i, int warp, int lane, int& row,
                                      int& col) {
  if (KIND == MATMUL) {
    const int e = i & 3;
    row = warp * 8 + 2 * (lane & 3) + (e & 1);
    col = (i >> 2) * 16 + (lane >> 2) + ((e & 2) ? 8 : 0);
  } else {
    row = warp * 8 + i / PER_LANE;
    col = lane * PER_LANE + i % PER_LANE;
  }
}

// 2^n as a float, n in [-126, 127].
__device__ __forceinline__ float exp2i(int n) {
  return __uint_as_float(static_cast<uint32_t>(n + 127) << 23);
}

// The exponent E (|m| in [2^E, 2^(E + 1))) of the largest |value| over
// the 4 lanes of a fragment row (lanes 4 g .. 4 g + 3), subnormals
// included; 0 for a row of zeros. Branch-free: with an `if` for the
// subnormal case the matmul ran 27% slower.
__device__ __forceinline__ int row_exponent(float m) {
  uint32_t b = __float_as_uint(fabsf(m));
  b = max(b, __shfl_xor_sync(FULL_MASK, b, 1));
  b = max(b, __shfl_xor_sync(FULL_MASK, b, 2));
  const int normal = static_cast<int>(b >> 23) - 127;
  const int subnormal = b != 0u ? -118 - __clz(static_cast<int>(b)) : 0;
  return b >= 0x800000u ? normal : subnormal;
}

// x * 2^-E, exact: |x| < 2^(E + 1), so the result is below 2 and no bit
// is lost (two factors keep each a normal float for any E).
__device__ __forceinline__ float scale_down(float x, int e) {
  const int e1 = e < -64 ? 64 : (e > 64 ? -64 : 0);
  return (x * exp2i(e1)) * exp2i(-e - e1);
}

// 2^E as a float, subnormal for E < -126 (both forms computed and one
// selected: a branch here cost the matmul a quarter of its time).
__device__ __forceinline__ float pow2(int e) {
  const float sub = __uint_as_float(1u << min(max(e + 149, 0), 31));
  return e >= -126 ? exp2i(max(e, -126)) : sub;
}

// y = hi + mid + lo + (below 2^-32), |y| < 2: the pieces are multiples of
// 2^-10, 2^-21 and 2^-32 with at most 11 significant bits each, so each
// is a TF32 value and a normal float (the tensor cores flush subnormal
// operands, which is why the caller scales each row's k-tile to |y| < 2
// first: the probe's later steps hold values down to the smallest
// subnormal, and the chain of scans amplifies what its first columns
// hold).
__device__ __forceinline__ void split3(float y, uint32_t (&p)[3]) {
  constexpr float S_HI = 1.5f * 8192.0f, S_MID = 1.5f * 4.0f;
  constexpr float S_LO = 1.5f / 512.0f;
  const float hi = (y + S_HI) - S_HI;
  const float r1 = y - hi;
  const float mid = (r1 + S_MID) - S_MID;
  const float r2 = r1 - mid;
  p[0] = __float_as_uint(hi);
  p[1] = __float_as_uint(mid);
  p[2] = __float_as_uint((r2 + S_LO) - S_LO);
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One step of the warp's 8 rows: D = T^T X^T with T^T[m][k] = (k <= m)
// as the A operand (computed, three fragments: all ones, and the two
// diagonal blocks) and the rows as B, each value split into three TF32
// pieces once a k-tile and used by every m-tile at or right of it.
__device__ __forceinline__ void matmul_scan(float (&v)[32],
                                            float* __restrict__ tile,
                                            int warp, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int row, col;
    place<MATMUL>(i, warp, lane, row, col);
    tile[row * STRIDE + col] = v[i];
  }
  __syncwarp();  // a warp reads back only its own rows
  const int g = lane >> 2, t = lane & 3;
  const uint32_t one = TF32_ONE;
  const uint32_t lo_diag = t <= g ? one : 0u, hi_diag = t + 4 <= g ? one : 0u;
  const uint32_t ones[4] = {one, one, one, one};
  const uint32_t diag0[4] = {lo_diag, one, hi_diag, one};  // kt = 2 mt
  const uint32_t diag1[4] = {0u, lo_diag, 0u, hi_diag};    // kt = 2 mt + 1
  const float* b_row = tile + (warp * 8 + g) * STRIDE + t;
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < 16; ++kt) {
    const float x0 = b_row[kt * 8], x1 = b_row[kt * 8 + 4];
    const int e = row_exponent(fmaxf(fabsf(x0), fabsf(x1)));
    // This lane's D values are rows 2 t and 2 t + 1 of the warp's 8 (B's
    // columns), held as rows g = 2 t, 2 t + 1 of B by lanes 8 t, 8 t + 4.
    const float up[2] = {pow2(__shfl_sync(FULL_MASK, e, 8 * t)),
                         pow2(__shfl_sync(FULL_MASK, e, 8 * t + 4))};
    uint32_t b0[3], b1[3];
    split3(scale_down(x0, e), b0);
    split3(scale_down(x1, e), b1);
#pragma unroll
    for (int mt = kt / 2; mt < 8; ++mt) {
      const uint32_t(&a)[4] = kt < 2 * mt ? ones
                              : kt == 2 * mt ? diag0 : diag1;
      // lo + mid is exact (a 24-bit span); + hi rounds toward zero once.
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 2; p >= 0; --p) mma_tf32(d, a, b0[p], b1[p]);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        v[4 * mt + e4] = fmaf(d[e4], up[e4 & 1], v[4 * mt + e4]);
      }
    }
  }
}

template <int KIND>
__device__ __forceinline__ void row_scan(float* __restrict__ v, int lane) {
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
  } else {  // ROLL
    // s[i] += (i >= k) ? s[i - k] : 0, highest j first so each add reads
    // the value before this shift. k = 1, 2: the lane's own values and
    // its left neighbour's last ones; k = 4 m: lane - m's values.
    float l3 = __shfl_up_sync(FULL_MASK, v[3], 1);
    if (lane == 0) l3 = 0.0f;
    v[3] += v[2];
    v[2] += v[1];
    v[1] += v[0];
    v[0] += l3;
    float l2 = __shfl_up_sync(FULL_MASK, v[2], 1);
    l3 = __shfl_up_sync(FULL_MASK, v[3], 1);
    if (lane == 0) l2 = l3 = 0.0f;
    v[3] += v[1];
    v[2] += v[0];
    v[1] += l3;
    v[0] += l2;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      float u[PER_LANE];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        u[j] = __shfl_up_sync(FULL_MASK, v[j], m);
      }
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) v[j] += lane >= m ? u[j] : 0.0f;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stores the word tag << 32 | val into `slot` of CTA `rank`, in one
// 64-bit store (single-copy atomic: no reader sees half of it).
__device__ __forceinline__ void send_tagged(const uint64_t* slot,
                                            unsigned rank, unsigned val,
                                            unsigned tag) {
  const uint64_t word = static_cast<uint64_t>(tag) << 32 | val;
  asm volatile(
      "{\n\t.reg .b32 rs;\n\t"
      "mapa.shared::cluster.u32 rs, %0, %1;\n\t"
      "st.shared::cluster.u64 [rs], %2;\n\t}"
      :: "r"(smem_addr(slot)), "r"(rank), "l"(word) : "memory");
}

// The value of this CTA's `slot` once its tag reads `tag`.
__device__ __forceinline__ unsigned poll_tagged(const uint64_t* slot,
                                                unsigned tag) {
  uint64_t word;
  do {
    asm volatile("ld.volatile.shared.u64 %0, [%1];"
                 : "=l"(word) : "r"(smem_addr(slot)) : "memory");
  } while (static_cast<unsigned>(word >> 32) != tag);
  return static_cast<unsigned>(word);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
scan_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int rows, int steps) {
  extern __shared__ float tile[];  // MATMUL: the CTA's rows
  __shared__ unsigned cta_max[2];            // by step parity
  __shared__ uint64_t tagged[2][CLUSTER];    // by step parity, sender
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned rank = cluster.block_rank();
  const int row0 = static_cast<int>(rank) * CTA_ROWS;
  if (threadIdx.x < 2) cta_max[threadIdx.x] = 0u;
  if (threadIdx.x < 2 * CLUSTER) {
    tagged[threadIdx.x / CLUSTER][threadIdx.x % CLUSTER] =
        0xffffffff00000000ull;  // a tag no step has
  }
  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int row, col;
    place<KIND>(i, warp, lane, row, col);
    v[i] = row0 + row < rows ? x[static_cast<size_t>(row0 + row) * C + col]
                             : 0.0f;
  }
  cluster.sync();

  for (int step = 0; step < steps; ++step) {
    const int p = step & 1;
    if constexpr (KIND == MATMUL) {
      matmul_scan(v, tile, warp, lane);
    } else {
#pragma unroll
      for (int r = 0; r < NV / PER_LANE; ++r) {
        row_scan<KIND>(v + r * PER_LANE, lane);
      }
    }
    // The max of |v| over the warp on the bits (|v| >= 0, so the bits order
    // as the values do), folded into the CTA's, sent by warp 0 to every
    // CTA of the cluster, and read back from this CTA's 16 copies.
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) m = fmaxf(m, fabsf(v[i]));
    const unsigned wm = __reduce_max_sync(FULL_MASK, __float_as_uint(m));
    if (lane == 0) atomicMax(&cta_max[p], wm);
    __syncthreads();
    if (warp == 0) {
      const unsigned cm = cta_max[p];
      __syncwarp();
      if (lane == 0) cta_max[p] = 0u;
      if (lane < CLUSTER) send_tagged(&tagged[p][rank], lane, cm, step);
    }
    const unsigned g = __reduce_max_sync(
        FULL_MASK, poll_tagged(&tagged[p][lane % CLUSTER], step));
    const float scale = 1.0f / fmaxf(1.0f, __uint_as_float(g));
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] *= scale;
  }
  cluster.sync();

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int row, col;
    place<KIND>(i, warp, lane, row, col);
    if (row0 + row < rows) {
      out[static_cast<size_t>(row0 + row) * C + col] = v[i];
    }
  }
}

template <int KIND>
int launch_kind(const float* x, float* out, int rows, int steps,
                cudaStream_t stream) {
  const size_t smem = KIND == MATMUL ? SMEM_BYTES : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per kind: opt in to the cluster size and the shared memory, and
  // refuse (rather than hang or pick another size) if the cluster cannot
  // be resident on this card.
  static bool checked = false;
  if (!checked) {
    cudaError_t err = cudaSuccess;
    if (CLUSTER > 8) {
      err = cudaFuncSetAttribute(scan_probe_kernel<KIND>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaFuncSetAttribute(scan_probe_kernel<KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, scan_probe_kernel<KIND>,
                                         &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    checked = true;
  }
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, scan_probe_kernel<KIND>, x, out, rows, steps));
}

}  // namespace

extern "C" int scan_probe_launch(const void* x, int rows, int kind,
                                 int steps, void* partial, void* out,
                                 void* stream) {
  (void)partial;  // see the note at the top
  if (rows <= 0 || rows > MAX_ROWS || steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case MATMUL: return launch_kind<MATMUL>(xp, op, rows, steps, s);
    case CUMSUM: return launch_kind<CUMSUM>(xp, op, rows, steps, s);
    case ROLL: return launch_kind<ROLL>(xp, op, rows, steps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int scan_probe_cluster() { return CLUSTER; }

extern "C" const char* scan_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
