// Device code shared by the compositors (composite_fwd.cu and
// composite_bwd.cu): the tile geometry and renderCUDA's per-pair alpha.
//
// A tile is 32x32 pixels. composite_bwd.cu runs it as one block of 1024
// threads, one pixel a thread (tile_pixel); composite_fwd.cu as four blocks
// of a 16x16 sub-tile each.
// The entries of a tile are the sorted positions [starts[t], ends[t]) of the
// int64 key stream; key & rank_mask is an entry's depth rank, the row of the
// rank-ordered feature table feat = [x, y, conic a, b, c, opacity,
// value_0 .. value_{NV-1}].

#pragma once

#include <cuda_runtime.h>

namespace w3 {

constexpr int TILE = 32;
constexpr int THREADS = TILE * TILE;
constexpr int MAX_NV = 9;

// The conic quadratic of an entry at one pixel offset (dx, dy) =
// pixel - centre: power = -0.5 (a dx^2 + c dy^2) - b dx dy.
__device__ __forceinline__ float conic_power(float4 co, float dx, float dy) {
  return -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
}

// Whether an entry contributes at a pixel (renderCUDA's rules): alpha ==
// min(alpha_max, o e^power), skipped where power > 0 or alpha < alpha_min.
__device__ __forceinline__ bool alpha_live(float power, float alpha,
                                           float alpha_min) {
  return !(power > 0.0f || alpha < alpha_min);
}

// The tile's pixel of this thread and whether it lies inside the image.
struct Pixel {
  int x, y;
  bool in_image;
};

__device__ __forceinline__ Pixel tile_pixel(int t, int tiles_x, int width,
                                            int height) {
  Pixel p;
  p.x = (t % tiles_x) * TILE + static_cast<int>(threadIdx.x) % TILE;
  p.y = (t / tiles_x) * TILE + static_cast<int>(threadIdx.x) / TILE;
  p.in_image = p.x < width && p.y < height;
  return p;
}

}  // namespace w3
