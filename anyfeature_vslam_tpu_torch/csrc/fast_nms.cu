// K1: FAST-9/16 corner score fused with 3x3 non-maximum suppression.
//
// Replaces the Pallas TPU kernel anyfeature_vslam_tpu/frontend/pallas_fast.py
// (fast_nms_pallas, body _fast_kernel). Same semantics as the plain twin
// anyfeature_vslam_tpu_torch/frontend/fast.py (fast_score_map + nms3x3):
//   score = max(bright, dark), where bright = max over the 16 contiguous
//   9-arcs of the radius-3 Bresenham ring of min(ring - centre), dark the
//   same on (centre - ring); a side counts only if strictly > threshold.
//   The 3-px image border is zeroed BEFORE the NMS; NMS keeps ties (>=)
//   and needs score > 0.
// Only float subtracts, compares and min/max: the result is bit-exact
// against the plain version.
//
// What bounds it on Hopper: memory. Each pixel is read once and written
// once (8 B/pixel; 1.2 MB for the 480x640 level) against ~300 ALU ops per
// pixel, so the design keeps every intermediate on chip: one block owns a
// 32x32 output tile, stages the tile plus a 4-px halo (ring reach 3 + NMS
// 1) in shared memory, computes the score for the tile plus a 1-px NMS
// halo into shared memory, and writes the suppressed tile once. No (16, H,
// W) ring stack ever reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;             // output tile edge
constexpr int kHalo = 4;               // ring reach (3) + NMS halo (1)
constexpr int kIn = kTile + 2 * kHalo;  // staged input edge: 40
constexpr int kSc = kTile + 2;          // score edge incl. NMS halo: 34

// Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock: the
// same order as frontend/fast.py CIRCLE_OFFSETS.
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ out,
                                int h, int w, float threshold) {
  __shared__ float s_img[kIn][kIn + 1];
  __shared__ float s_sc[kSc][kSc + 1];
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // stage the tile + halo; pixels outside the image only ever feed
  // border-zeroed scores, so their value does not matter
  for (int i = tid; i < kIn * kIn; i += nthr) {
    const int r = i / kIn, c = i % kIn;
    const int y = y0 - kHalo + r, x = x0 - kHalo + c;
    s_img[r][c] = (y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.0f;
  }
  __syncthreads();

  // score over the tile + 1-px NMS halo, border zeroed before the NMS
  for (int i = tid; i < kSc * kSc; i += nthr) {
    const int r = i / kSc, c = i % kSc;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float sc = 0.0f;
    if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
      const int sr = r + 3, scol = c + 3;  // staged coords of the centre
      const float cen = s_img[sr][scol];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[sr + kDy[k]][scol + kDx[k]] - cen;
      float best_min = -INFINITY;  // brightest arc: max over arcs of min
      float best_max = INFINITY;   // darkest arc: min over arcs of max
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        float mn = d[s], mx = d[s];
#pragma unroll
        for (int k = 1; k < 9; ++k) {
          mn = fminf(mn, d[(s + k) & 15]);
          mx = fmaxf(mx, d[(s + k) & 15]);
        }
        best_min = fmaxf(best_min, mn);
        best_max = fminf(best_max, mx);
      }
      const float s_b = best_min;
      const float s_d = -best_max;
      sc = fmaxf(s_b > threshold ? s_b : 0.0f, s_d > threshold ? s_d : 0.0f);
    }
    s_sc[r][c] = sc;
  }
  __syncthreads();

  // 3x3 NMS, ties kept
  for (int i = tid; i < kTile * kTile; i += nthr) {
    const int r = i / kTile, c = i % kTile;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float cen = s_sc[r + 1][c + 1];
    float neigh = cen;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, s_sc[r + dy][c + dx]);
    out[y * w + x] = (cen >= neigh && cen > 0.0f) ? cen : 0.0f;
  }
}

}  // namespace

// img, out: (h, w) float32, contiguous, on the current device. Launches on
// `stream`; returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fast_nms_f32(const float* img, float* out, int h, int w,
                            float threshold, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
