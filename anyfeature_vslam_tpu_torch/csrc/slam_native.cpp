// Host runtime library of the port: the PNG row unfilter and the map-graph
// kernels (the port's counterpart of native/slam_native.cpp, whose map
// functions are copied here with their semantics).
//
// Plain C interface, loaded with ctypes by anyfeature_vslam_tpu_torch/
// native.py; built by cuda_build.build_host with the host C++ compiler:
//   c++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off
// -ffp-contract=off keeps a * b + c as two roundings, as the numpy twins
// in native.py compute it, and the loops keep the twins' order, so the
// float outputs equal theirs bit for bit.
//
// Every function only reads its inputs and writes its outputs: ctypes
// releases the GIL around each call, so the frame loader's reader thread
// unfilters while the tracking thread runs Python.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- imaging

// PNG row filters (PNG spec section 9): the (height, stride) scanlines of a
// decompressed IDAT stream, each row prefixed by its filter type, with the
// filter undone into out (height * stride bytes). bpp: bytes per complete
// pixel, rounded up to 1 (1..8).
// Returns 0; -1 when raw holds fewer than height * (stride + 1) bytes; -2
// when a row's filter type is not 0-4 (its index in *bad_row); -3 for a bpp
// outside 1..8.
int unfilter(const uint8_t* raw, int64_t raw_len, int64_t height,
             int64_t stride, int64_t bpp, uint8_t* out, int64_t* bad_row) {
  if (bpp < 1 || bpp > 8) return -3;
  if (raw_len < height * (stride + 1)) return -1;
  const uint8_t* prior = nullptr;  // the row above, already unfiltered
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    const uint8_t kind = line[0];
    ++line;
    uint8_t* cur = out + y * stride;
    switch (kind) {
      case 0:  // None
        std::memcpy(cur, line, (size_t)stride);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (i >= bpp && prior) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        *bad_row = y;
        return -2;
    }
    prior = cur;
  }
  return 0;
}

// ---------------------------------------------------------- map kernels

// weights[k] = |points(target) ∩ points(k)| for every valid keyframe k
// (reference KeyFrame::UpdateConnections). kf_matches: (K, N) int32 point
// ids (-1 = none). scratch: max_pt bytes.
void covisibility_weights(const int32_t* kf_matches, const uint8_t* kf_valid,
                          int64_t K, int64_t N, int64_t target, int64_t max_pt,
                          uint8_t* scratch, int64_t* out_w) {
  std::memset(scratch, 0, (size_t)max_pt);
  const int32_t* mine = kf_matches + target * N;
  for (int64_t i = 0; i < N; ++i) {
    const int32_t p = mine[i];
    if (p >= 0 && p < max_pt) scratch[p] = 1;
  }
  for (int64_t k = 0; k < K; ++k) {
    out_w[k] = 0;
    if (!kf_valid[k] || k == target) continue;
    const int32_t* row = kf_matches + k * N;
    int64_t c = 0;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t p = row[i];
      if (p >= 0 && p < max_pt && scratch[p]) ++c;
    }
    out_w[k] = c;
  }
}

// counts[p] = number of observations of point p over the valid keyframes.
void point_obs_counts(const int32_t* kf_matches, const uint8_t* kf_valid,
                      int64_t K, int64_t N, int64_t max_pt,
                      int64_t* out_counts) {
  std::memset(out_counts, 0, (size_t)max_pt * sizeof(int64_t));
  for (int64_t k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_matches + k * N;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t p = row[i];
      if (p >= 0 && p < max_pt) ++out_counts[p];
    }
  }
}

// (K, K) int32 shared-observation counts: for each point, every pair of its
// observations adds one to both keyframes' entries (a keyframe that holds a
// point twice counts it on its own diagonal). One pass over the
// observations through per-point observer lists.
void covisibility_matrix(const int32_t* kf_matches, const uint8_t* kf_valid,
                         int64_t K, int64_t N, int64_t max_pt,
                         int32_t* out_w) {
  std::memset(out_w, 0, (size_t)K * K * sizeof(int32_t));
  std::vector<int32_t> head(max_pt, -1);
  std::vector<int32_t> next;
  std::vector<int32_t> owner;
  for (int64_t k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_matches + k * N;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t p = row[i];
      if (p < 0 || p >= max_pt) continue;
      owner.push_back((int32_t)k);
      next.push_back(head[p]);
      head[p] = (int32_t)owner.size() - 1;
    }
  }
  for (int64_t p = 0; p < max_pt; ++p) {
    for (int32_t a = head[p]; a >= 0; a = next[a]) {
      for (int32_t b = next[a]; b >= 0; b = next[b]) {
        const int32_t ka = owner[a], kb = owner[b];
        out_w[(int64_t)ka * K + kb] += 1;
        out_w[(int64_t)kb * K + ka] += 1;
      }
    }
  }
}

// Per-point statistics of the P points pt_ids, written at their rows of
// the full-size pt_* arrays:
//   - the distinctive descriptor: the observation whose sorted distance
//     row has the smallest element (O - 1) / 2, the first such on ties
//     (reference MapPoint::ComputeDistinctiveDescriptors,
//     src/MapPoint.cc:279-349); Hamming over {0,1} bytes when is_binary,
//     else squared L2 over float32, summed in order;
//   - the mean viewing direction, unit vectors summed in (keyframe, slot)
//     order then times 1 / O (UpdateNormalAndDepth, :372-430);
//   - the scale band from the reference keyframe's observation, else the
//     first: max 1.2 * dist * size, min 0.8 * dist * size / 1.2^7.
// kf_desc: (K, N, D) uint8 bits when is_binary, else float32.
void update_point_stats(
    const int32_t* kf_matches, const uint8_t* kf_valid, const void* kf_desc,
    int is_binary, const float* kf_size, const float* kf_centers,
    int64_t K, int64_t N, int64_t D, int64_t max_pt,
    const int64_t* pt_ids, int64_t P, const float* pt_pos,
    const int32_t* pt_ref_kf, void* pt_desc, float* pt_normal,
    float* pt_ref_size, float* pt_ref_dist, float* pt_min_dist,
    float* pt_max_dist) {
  std::vector<int32_t> mark(max_pt, -1);
  for (int64_t i = 0; i < P; ++i) {
    const int64_t p = pt_ids[i];
    if (p >= 0 && p < max_pt) mark[p] = (int32_t)i;
  }
  // per selected point: its (keyframe, slot) observations
  std::vector<std::vector<std::pair<int32_t, int32_t>>> obs(P);
  for (int64_t k = 0; k < K; ++k) {
    if (!kf_valid[k]) continue;
    const int32_t* row = kf_matches + k * N;
    for (int64_t i = 0; i < N; ++i) {
      const int32_t p = row[i];
      if (p >= 0 && p < max_pt && mark[p] >= 0)
        obs[mark[p]].emplace_back((int32_t)k, (int32_t)i);
    }
  }
  const uint8_t* descb = (const uint8_t*)kf_desc;
  const float* descf = (const float*)kf_desc;
  std::vector<float> dmat, dist_row;
  for (int64_t i = 0; i < P; ++i) {
    const auto& o = obs[i];
    const int64_t O = (int64_t)o.size();
    if (O == 0) continue;
    const int64_t p = pt_ids[i];
    int64_t best = 0;
    if (O > 1) {
      dmat.assign((size_t)O * O, 0.f);
      for (int64_t a = 0; a < O; ++a) {
        const size_t ra = ((size_t)o[a].first * N + o[a].second) * D;
        for (int64_t b = a + 1; b < O; ++b) {
          const size_t rb = ((size_t)o[b].first * N + o[b].second) * D;
          float d = 0.f;
          if (is_binary) {
            int64_t c = 0;
            for (int64_t j = 0; j < D; ++j) c += (descb[ra + j] != descb[rb + j]);
            d = (float)c;
          } else {
            for (int64_t j = 0; j < D; ++j) {
              const float t = descf[ra + j] - descf[rb + j];
              d += t * t;
            }
          }
          dmat[a * O + b] = d;
          dmat[b * O + a] = d;
        }
      }
      float best_med = 0.f;
      const int64_t mid = (O - 1) / 2;
      for (int64_t a = 0; a < O; ++a) {
        dist_row.assign(dmat.begin() + a * O, dmat.begin() + (a + 1) * O);
        std::nth_element(dist_row.begin(), dist_row.begin() + mid,
                         dist_row.end());
        const float m = dist_row[mid];
        if (a == 0 || m < best_med) {
          best_med = m;
          best = a;
        }
      }
    }
    const size_t src = ((size_t)o[best].first * N + o[best].second) * D;
    if (is_binary)
      std::memcpy((uint8_t*)pt_desc + (size_t)p * D, descb + src, (size_t)D);
    else
      std::memcpy((float*)pt_desc + (size_t)p * D, descf + src,
                  (size_t)D * sizeof(float));
    const float* pos = pt_pos + (size_t)p * 3;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    for (int64_t a = 0; a < O; ++a) {
      const float* c = kf_centers + (size_t)o[a].first * 3;
      const float vx = pos[0] - c[0], vy = pos[1] - c[1], vz = pos[2] - c[2];
      const float nrm = std::max(std::sqrt(vx * vx + vy * vy + vz * vz), 1e-9f);
      nx += vx / nrm;
      ny += vy / nrm;
      nz += vz / nrm;
    }
    const float inv = 1.0f / (float)O;
    pt_normal[(size_t)p * 3 + 0] = nx * inv;
    pt_normal[(size_t)p * 3 + 1] = ny * inv;
    pt_normal[(size_t)p * 3 + 2] = nz * inv;
    int32_t rk = o[0].first, rs = o[0].second;
    const int32_t want = pt_ref_kf[p];
    for (int64_t a = 0; a < O; ++a)
      if (o[a].first == want) {
        rk = o[a].first;
        rs = o[a].second;
        break;
      }
    const float* c = kf_centers + (size_t)rk * 3;
    const float dx = pos[0] - c[0], dy = pos[1] - c[1], dz = pos[2] - c[2];
    const float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
    const float size = kf_size[(size_t)rk * N + rs];
    pt_ref_size[p] = size;
    pt_ref_dist[p] = dist;
    const float max_size = 3.58318f;  // maxKeyPtSize = 1.2^7
    pt_max_dist[p] = 1.2f * dist * size;
    pt_min_dist[p] = 0.8f * dist * size / max_size;
  }
}

}  // extern "C"
