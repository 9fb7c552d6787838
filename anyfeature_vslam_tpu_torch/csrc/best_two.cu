// K2: masked best / argmin / second-best descriptor search.
//
// Replaces the Pallas TPU kernel anyfeature_vslam_tpu/ops/pallas_match.py
// (fused_best_two, body _match_kernel). Same semantics as the plain twin
// anyfeature_vslam_tpu_torch/ops/cuda_match.py reference_best_two: for each
// query, over every candidate that passes the gates
//   |du| <= q_rad and |dv| <= q_rad   (a negative radius disables the row)
//   q_slo <= c_size <= q_shi          and c_valid,
// the smallest distance, its index (lowest index on ties) and the smallest
// distance among the other candidates. A query with no candidate gets
// best = second = 3e8 and index -1.
//
// Distances: binary descriptors ({0,1} uint8 bit planes, D = 256/384/488/
// 512) are packed into 32-bit words and compared with __popc(a ^ b), which
// is exactly the plain version's |a| + |b| - 2 a.b. Float descriptors
// (D <= 128) use max(|q|^2 + |c|^2 - 2 q.c, 0) in fp32 like the plain
// version, with another summation order.
//
// What bounds it on Hopper: integer ALU issue. At the local-map search
// (4096 queries x 1000 candidates x 8 words) the kernel does ~33M
// xor+popc pairs over ~0.2 MB of packed input, so it is compute-light and
// latency-bound at this size. One warp owns one query (its words live in
// registers); a block of 8 warps streams candidate tiles of 256 rows
// through shared memory (rows padded by one word: no bank conflicts) so
// each candidate row is read from device memory once per block. Each lane
// folds its candidates in increasing index order (strict < keeps the
// lowest index, a tie goes to second), then the warp merges lane results
// with an order-independent lexicographic (best, idx) min.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e8f;
constexpr int kWarps = 8;       // queries per block
constexpr int kTileC = 256;     // candidate rows per shared-memory tile (binary)
constexpr int kTileCF = 64;     // candidate rows per shared-memory tile (float)
constexpr int kMaxDimF = 128;   // widest float descriptor

struct Best2 {
  float best;
  int idx;
  float second;
};

// fold candidate j (visited in increasing j) into a running triple
__device__ __forceinline__ void fold(Best2& a, float v, int j) {
  if (v < a.best) {
    a.second = a.best;
    a.best = v;
    a.idx = j;
  } else {
    a.second = fminf(a.second, v);
  }
}

// merge two triples over disjoint candidate sets: the winner is the
// lexicographically smaller (best, idx); the loser's best competes for
// second. Commutative and associative, so the shuffle order is free.
__device__ __forceinline__ Best2 merge(const Best2& a, const Best2& b) {
  const bool a_wins = (a.best < b.best) || (a.best == b.best && a.idx < b.idx);
  Best2 win = a_wins ? a : b;
  const float lose_best = a_wins ? b.best : a.best;
  win.second = fminf(win.second, lose_best);
  return win;
}

__device__ __forceinline__ Best2 warp_merge(Best2 a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best2 o;
    o.best = __shfl_xor_sync(0xffffffffu, a.best, off);
    o.idx = __shfl_xor_sync(0xffffffffu, a.idx, off);
    o.second = __shfl_xor_sync(0xffffffffu, a.second, off);
    a = merge(a, o);
  }
  return a;
}

struct Side {
  const float* q_uv;    // (nq, 2)
  const float* q_rad;   // (nq,)
  const float* q_slo;   // (nq,)
  const float* q_shi;   // (nq,)
  const float* c_uv;    // (nc, 2)
  const float* c_size;  // (nc,)
  const uint8_t* c_valid;  // (nc,) bool
  float* best;          // (nq,)
  int* idx;             // (nq,)
  float* second;        // (nq,)
};

// per-candidate gate data staged beside each tile
struct CandMeta {
  float u, v, size;
  int valid;
};

__device__ __forceinline__ bool gate(const CandMeta& c, float qu, float qv,
                                     float rad, float slo, float shi) {
  return c.valid && fabsf(qu - c.u) <= rad && fabsf(qv - c.v) <= rad &&
         c.size >= slo && c.size <= shi;
}

__device__ __forceinline__ void stage_meta(CandMeta* s_meta, const Side& s,
                                           int t0, int n, int tid, int nthr) {
  for (int i = tid; i < n; i += nthr) {
    const int j = t0 + i;
    s_meta[i] = CandMeta{s.c_uv[2 * j], s.c_uv[2 * j + 1], s.c_size[j],
                         static_cast<int>(s.c_valid[j])};
  }
}

// (n, d) {0,1} bytes -> (n, W) little-endian bit words, zero-padded
__global__ void pack_bits_kernel(const uint8_t* __restrict__ bits,
                                 uint32_t* __restrict__ words, int n, int d,
                                 int nwords) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * nwords) return;
  const int row = i / nwords, wd = i % nwords;
  const uint8_t* src = bits + static_cast<size_t>(row) * d;
  uint32_t acc = 0;
  for (int b = 0; b < 32; ++b) {
    const int k = wd * 32 + b;
    if (k < d && src[k]) acc |= 1u << b;
  }
  words[i] = acc;
}

template <int W>
__global__ void best_two_bits_kernel(const uint32_t* __restrict__ qw,
                                     const uint32_t* __restrict__ cw,
                                     int nq, int nc, Side s) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_c = smem;                                      // kTileC x (W+1)
  CandMeta* s_meta = reinterpret_cast<CandMeta*>(smem + kTileC * (W + 1));
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x * kWarps + warp;
  const bool active = q < nq;

  uint32_t qr[W];
  float qu = 0.f, qv = 0.f, rad = -1.f, slo = 0.f, shi = 0.f;
  if (active) {
#pragma unroll
    for (int k = 0; k < W; ++k) qr[k] = qw[static_cast<size_t>(q) * W + k];
    qu = s.q_uv[2 * q];
    qv = s.q_uv[2 * q + 1];
    rad = s.q_rad[q];
    slo = s.q_slo[q];
    shi = s.q_shi[q];
  }
  Best2 acc{kInf, -1, kInf};

  for (int t0 = 0; t0 < nc; t0 += kTileC) {
    const int n = min(kTileC, nc - t0);
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < n * W; i += nthr) {
      const int r = i / W, k = i % W;
      s_c[r * (W + 1) + k] = cw[static_cast<size_t>(t0) * W + i];
    }
    stage_meta(s_meta, s, t0, n, tid, nthr);
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      float v = kInf;
      if (gate(s_meta[j], qu, qv, rad, slo, shi)) {
        int pop = 0;
#pragma unroll
        for (int k = 0; k < W; ++k) pop += __popc(qr[k] ^ s_c[j * (W + 1) + k]);
        v = static_cast<float>(pop);
      }
      fold(acc, v, t0 + j);
    }
  }
  if (!active) return;
  acc = warp_merge(acc);
  if (lane == 0) {
    s.best[q] = acc.best;
    s.idx[q] = acc.idx;
    s.second[q] = acc.second;
  }
}

__global__ void best_two_f32_kernel(const float* __restrict__ qf,
                                    const float* __restrict__ cf,
                                    int nq, int nc, int d, Side s) {
  extern __shared__ float fsm[];
  float* s_q = fsm;                                  // kWarps x d
  float* s_c = s_q + kWarps * d;                     // kTileCF x (d+1)
  float* s_cn = s_c + kTileCF * (d + 1);             // kTileCF
  CandMeta* s_meta = reinterpret_cast<CandMeta*>(s_cn + kTileCF);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x * kWarps + warp;
  const bool active = q < nq;

  float qn = 0.f, qu = 0.f, qv = 0.f, rad = -1.f, slo = 0.f, shi = 0.f;
  float* my_q = s_q + warp * d;
  if (active) {
    for (int k = lane; k < d; k += 32) {
      const float x = qf[static_cast<size_t>(q) * d + k];
      my_q[k] = x;
      qn += x * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(0xffffffffu, qn, off);
    qu = s.q_uv[2 * q];
    qv = s.q_uv[2 * q + 1];
    rad = s.q_rad[q];
    slo = s.q_slo[q];
    shi = s.q_shi[q];
  }
  Best2 acc{kInf, -1, kInf};

  for (int t0 = 0; t0 < nc; t0 += kTileCF) {
    const int n = min(kTileCF, nc - t0);
    __syncthreads();
    for (int i = tid; i < n * d; i += nthr) {
      const int r = i / d, k = i % d;
      s_c[r * (d + 1) + k] = cf[static_cast<size_t>(t0) * d + i];
    }
    stage_meta(s_meta, s, t0, n, tid, nthr);
    __syncthreads();
    for (int r = tid; r < n; r += nthr) {
      float cn = 0.f;
      for (int k = 0; k < d; ++k) cn += s_c[r * (d + 1) + k] * s_c[r * (d + 1) + k];
      s_cn[r] = cn;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      float v = kInf;
      if (gate(s_meta[j], qu, qv, rad, slo, shi)) {
        float dot = 0.f;
        for (int k = 0; k < d; ++k) dot += my_q[k] * s_c[j * (d + 1) + k];
        v = fmaxf(qn + s_cn[j] - 2.0f * dot, 0.0f);
      }
      fold(acc, v, t0 + j);
    }
  }
  if (!active) return;
  acc = warp_merge(acc);
  if (lane == 0) {
    s.best[q] = acc.best;
    s.idx[q] = acc.idx;
    s.second[q] = acc.second;
  }
}

Side make_side(const float* q_uv, const float* q_rad, const float* q_slo,
               const float* q_shi, const float* c_uv, const float* c_size,
               const uint8_t* c_valid, float* best, int* idx, float* second) {
  return Side{q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid, best, idx, second};
}

template <int W>
void launch_bits(const uint32_t* qw, const uint32_t* cw, int nq, int nc,
                 const Side& s, cudaStream_t stream) {
  const size_t shmem = kTileC * (W + 1) * sizeof(uint32_t) + kTileC * sizeof(CandMeta);
  const int grid = (nq + kWarps - 1) / kWarps;
  best_two_bits_kernel<W><<<grid, kWarps * 32, shmem, stream>>>(qw, cw, nq, nc, s);
}

}  // namespace

// Binary path. q_bits (nq, d), c_bits (nc, d): {0,1} uint8, d <= 512.
// q_words (nq, nwords) and c_words (nc, nwords) uint32 are scratch the
// caller allocates, nwords = 8, 12 or 16 (d rounded up to 32 bits, 488 ->
// 16). Side arrays float32 / bool, outputs (nq,) float32 / int32 /
// float32, all contiguous on the current device. Returns
// cudaGetLastError() after the launches (0 = launched); nq, nc >= 1.
extern "C" int best_two_bits(const uint8_t* q_bits, const uint8_t* c_bits,
                             int nq, int nc, int d, int nwords,
                             uint32_t* q_words, uint32_t* c_words,
                             const float* q_uv, const float* q_rad,
                             const float* q_slo, const float* q_shi,
                             const float* c_uv, const float* c_size,
                             const uint8_t* c_valid, float* best, int* idx,
                             float* second, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int threads = 256;
  pack_bits_kernel<<<(nq * nwords + threads - 1) / threads, threads, 0, stream>>>(
      q_bits, q_words, nq, d, nwords);
  pack_bits_kernel<<<(nc * nwords + threads - 1) / threads, threads, 0, stream>>>(
      c_bits, c_words, nc, d, nwords);
  const Side s = make_side(q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                           best, idx, second);
  switch (nwords) {
    case 8: launch_bits<8>(q_words, c_words, nq, nc, s, stream); break;
    case 12: launch_bits<12>(q_words, c_words, nq, nc, s, stream); break;
    case 16: launch_bits<16>(q_words, c_words, nq, nc, s, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Float path. q (nq, d), c (nc, d) float32, d <= 128; side arrays and
// outputs as in best_two_bits.
extern "C" int best_two_f32(const float* q, const float* c, int nq, int nc,
                            int d, const float* q_uv, const float* q_rad,
                            const float* q_slo, const float* q_shi,
                            const float* c_uv, const float* c_size,
                            const uint8_t* c_valid, float* best, int* idx,
                            float* second, void* stream_ptr) {
  if (d < 1 || d > kMaxDimF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Side s = make_side(q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                           best, idx, second);
  const size_t shmem = (kWarps * d + kTileCF * (d + 1) + kTileCF) * sizeof(float) +
                       kTileCF * sizeof(CandMeta);
  const int grid = (nq + kWarps - 1) / kWarps;
  best_two_f32_kernel<<<grid, kWarps * 32, shmem, stream>>>(q, c, nq, nc, d, s);
  return static_cast<int>(cudaGetLastError());
}
