// K1: FAST-9/16 corner score fused with 3x3 non-maximum suppression, over
// all pyramid levels of a frame in one launch.
//
// Replaces the Pallas TPU kernel anyfeature_vslam_tpu/frontend/pallas_fast.py:105
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
// What bounds it on Hopper: memory. A 640x480 frame's 8 levels hold
// 950,532 pixels, read once and written once: 7.6 MB, 2.3 us at 3.35 TB/s.
// The arithmetic needed is about as large only where a corner is possible
// (below), so the design keeps every intermediate on chip and spends
// launches and ALU only where they matter:
//   - one launch for all levels: the kernel takes a table of up to 8 levels
//     by value (pointers, sizes, first tile of each) and each block finds
//     its (level, tile) from the prefix of first tiles; at 640x480 that is
//     998 tiles of 32x32, enough blocks to fill the card, where level 7
//     alone would give 30;
//   - a block stages its tile plus a 4-px halo (ring reach 3 + NMS 1) in
//     shared memory, scores the tile plus a 1-px NMS halo into shared
//     memory and writes the suppressed tile once: no (16, H, W) ring stack
//     reaches device memory;
//   - an exact early exit: every 9-arc holds two adjacent cardinal points
//     (ring indices 0, 4, 8, 12), so unless an adjacent pair is both above
//     +threshold (bright) or both below -threshold (dark), that side cannot
//     pass the threshold; a pixel where neither side can scores exactly 0.
//     The block tests the cardinal points of all its pixels first and lists
//     the live ones in shared memory, so the arc test then runs on full
//     warps of live pixels, not on warps where a few lanes are live, and
//     a side that cannot pass is not evaluated;
//   - the arc test is the Pallas kernel's log-depth tree (m2 -> m4 -> m8,
//     plus one element): 64 min/max per side instead of 128. Min and max are
//     exact in any order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;               // output tile edge
constexpr int kHalo = 4;                // ring reach (3) + NMS halo (1)
constexpr int kIn = kTile + 2 * kHalo;  // staged input edge: 40
constexpr int kSc = kTile + 2;          // score edge incl. NMS halo: 34
constexpr int kThreads = 256;
constexpr int kStageIters = (kIn * kIn + kThreads - 1) / kThreads;  // 7
constexpr int kScIters = (kSc * kSc + kThreads - 1) / kThreads;     // 5
constexpr int kMaxLevels = 8;

// Bresenham circle of radius 3 (dy, dx), clockwise from 12 o'clock: the
// same order as frontend/fast.py CIRCLE_OFFSETS.
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

struct Levels {
  const float* in[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first_tile[kMaxLevels];  // level l owns blocks [first_tile[l], first_tile[l + 1])
  int n;
};

// max over the 16 arcs of min(d[s .. s+8]) (indices mod 16): log-depth tree
__device__ __forceinline__ float best_arc_min(const float (&d)[16]) {
  float m2[16], m4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = fminf(d[s], d[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = fminf(m2[s], m2[(s + 2) & 15]);
  float best = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float m8 = fminf(m4[s], m4[(s + 4) & 15]);
    best = fmaxf(best, fminf(m8, d[(s + 8) & 15]));
  }
  return best;
}

// min over the 16 arcs of max(d[s .. s+8])
__device__ __forceinline__ float best_arc_max(const float (&d)[16]) {
  float x2[16], x4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) x2[s] = fmaxf(d[s], d[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) x4[s] = fmaxf(x2[s], x2[(s + 2) & 15]);
  float best = INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const float x8 = fmaxf(x4[s], x4[(s + 4) & 15]);
    best = fminf(best, fmaxf(x8, d[(s + 8) & 15]));
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const Levels lv, float threshold) {
  __shared__ float s_img[kIn][kIn + 1];
  __shared__ float s_sc[kSc][kSc + 1];
  __shared__ int s_live[kSc * kSc];  // pixels where a side can pass
  __shared__ int s_nlive;

  // this block's level: the last whose first tile is <= blockIdx.x (the
  // table is read with constant indices only, so it stays in the
  // parameter bank)
  const int b = blockIdx.x;
  const float* img = lv.in[0];
  float* out = lv.out[0];
  int h = lv.h[0], w = lv.w[0], tiles_x = lv.tiles_x[0], first = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l < lv.n && b >= lv.first_tile[l]) {
      img = lv.in[l];
      out = lv.out[l];
      h = lv.h[l];
      w = lv.w[l];
      tiles_x = lv.tiles_x[l];
      first = lv.first_tile[l];
    }
  }
  const int t = b - first;
  const int y0 = (t / tiles_x) * kTile;
  const int x0 = (t % tiles_x) * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) s_nlive = 0;

  // stage the tile + halo, every load in flight before the first store;
  // pixels outside the image only ever feed border-zeroed scores, so their
  // value does not matter
  float v[kStageIters];
#pragma unroll
  for (int k = 0; k < kStageIters; ++k) {
    const int i = tid + k * kThreads;
    const int y = y0 - kHalo + i / kIn, x = x0 - kHalo + i % kIn;
    v[k] = (i < kIn * kIn && y >= 0 && y < h && x >= 0 && x < w) ? img[y * w + x] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kStageIters; ++k) {
    const int i = tid + k * kThreads;
    if (i < kIn * kIn) s_img[i / kIn][i % kIn] = v[k];
  }
  __syncthreads();

  // pass 1, over the tile + 1-px NMS halo: the cardinal test. A pixel
  // where a side can pass goes to the live list with its sides (bit 16
  // bright, bit 17 dark); every other score is exactly 0. The 3-px image
  // border scores 0 before the NMS.
#pragma unroll
  for (int k = 0; k < kScIters; ++k) {
    const int i = tid + k * kThreads;
    const int r = i / kSc, c = i % kSc;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    int sides = 0;
    if (i < kSc * kSc) {
      s_sc[r][c] = 0.0f;
      if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
        const int sr = r + 3, scol = c + 3;  // staged coords of the centre
        const float cen = s_img[sr][scol];
        // cardinal points: ring indices 0, 4, 8, 12
        const float c0 = s_img[sr - 3][scol] - cen;
        const float c4 = s_img[sr][scol + 3] - cen;
        const float c8 = s_img[sr + 3][scol] - cen;
        const float c12 = s_img[sr][scol - 3] - cen;
        const bool b0 = c0 > threshold, b4 = c4 > threshold, b8 = c8 > threshold,
                   b12 = c12 > threshold;
        const bool k0 = c0 < -threshold, k4 = c4 < -threshold, k8 = c8 < -threshold,
                   k12 = c12 < -threshold;
        const bool bright = (b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0);
        const bool dark = (k0 && k4) || (k4 && k8) || (k8 && k12) || (k12 && k0);
        sides = (bright ? 1 : 0) | (dark ? 2 : 0);
      }
    }
    // one shared-memory atomic per warp reserves the warp's list slots
    const unsigned live = __ballot_sync(0xffffffffu, sides != 0);
    int base = 0;
    if (lane == 0 && live) base = atomicAdd(&s_nlive, __popc(live));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (sides) s_live[base + __popc(live & ((1u << lane) - 1u))] = i | (sides << 16);
  }
  __syncthreads();

  // pass 2, over the live list only, with every lane busy: the arc tests
  const int nlive = s_nlive;
  for (int k = tid; k < nlive; k += kThreads) {
    const int e = s_live[k];
    const int i = e & 0xffff;
    const int r = i / kSc, c = i % kSc;
    const int sr = r + 3, scol = c + 3;
    const float cen = s_img[sr][scol];
    float d[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) d[m] = s_img[sr + kDy[m]][scol + kDx[m]] - cen;
    float sb = 0.0f, sd = 0.0f;  // a side that cannot pass counts 0
    if (e & (1 << 16)) {
      const float s_b = best_arc_min(d);
      if (s_b > threshold) sb = s_b;
    }
    if (e & (1 << 17)) {
      const float s_d = -best_arc_max(d);
      if (s_d > threshold) sd = s_d;
    }
    s_sc[r][c] = fmaxf(sb, sd);
  }
  __syncthreads();

  // 3x3 NMS, ties kept
  for (int i = tid; i < kTile * kTile; i += kThreads) {
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

// in[l], out[l]: (h[l], w[l]) float32, contiguous, on the current device,
// for n = 1..8 levels. One launch over all levels' 32x32 tiles on
// `stream`; returns cudaGetLastError() after the launch (0 = launched, or
// nothing to do when every level is empty).
extern "C" int fast_nms_levels_f32(const float* const* in, float* const* out, const int* h,
                                   const int* w, int n, float threshold, void* stream) {
  if (n < 1 || n > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  int tiles = 0;
  for (int l = 0; l < n; ++l) {
    if (h[l] < 0 || w[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.in[l] = in[l];
    lv.out[l] = out[l];
    lv.h[l] = h[l];
    lv.w[l] = w[l];
    lv.tiles_x[l] = (w[l] + kTile - 1) / kTile;
    lv.first_tile[l] = tiles;
    tiles += lv.tiles_x[l] * ((h[l] + kTile - 1) / kTile);
  }
  lv.n = n;
  if (tiles == 0) return 0;
  fast_nms_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lv, threshold);
  return static_cast<int>(cudaGetLastError());
}
