// K2: masked best / argmin / second-best descriptor search.
//
// Replaces the Pallas TPU kernel anyfeature_vslam_tpu/ops/pallas_match.py:179
// (fused_best_two, body _match_kernel). Same semantics as the plain twin
// anyfeature_vslam_tpu_torch/ops/cuda_match.py reference_best_two: for each
// query, over every candidate that passes the gates
//   |du| <= q_rad and |dv| <= q_rad   (a negative radius disables the row)
//   q_slo <= c_size <= q_shi          and c_valid,
// the smallest distance, its index (lowest index on ties) and the smallest
// distance among the other candidates. A query with no candidate gets
// best = second = 3e8 and index -1.
//
// Binary path (D = 256/384/488/512 bits, W = 8/12/16 words). Candidates
// come as packed little-endian 32-bit words, made by pack_bits_kernel once
// per candidate set (the tracked frame packs its keypoints once and three
// searches share them); queries come as {0,1} bytes and each warp packs its
// own rows with __ballot_sync, so a search is one launch. Distances are
// __popc(q ^ c), exactly the plain version's |a| + |b| - 2 a.b.
//
// What bounds it on Hopper: neither bytes nor operations at the main path's
// sizes, but latency. The local-map search (4096 x 1000, D = 256) reads
// 1.2 MB (0.4 us at 3.35 TB/s) and needs ~33M gate operations (0.5 us at
// 67 TFLOP/s); the gates pass 0.4-20% of the pairs, so the popcounts are
// fewer still. The design therefore cuts launches and staging, and spends
// ALU only where the gate passes:
//   - one block stages the whole candidate set in shared memory once (the
//     words with cp.async, the gate data as float4 {u, v, size, -}, the
//     size NaN where a candidate is invalid so the size test rejects it),
//     one barrier and no tile loop up to 2048 candidates; above that, a
//     double-buffered loop over tiles of 1024;
//   - a block of 32 warps serves 32 / S queries, one warp per query and
//     its candidates split over S = 1, 2, 4 or 8 warps, S chosen from Nq
//     so that the grid is one wave of one block per SM (S = 1 at 4096
//     queries, 4 at 1000): 32 warps per SM hide the latency of the gate
//     loop, where one warp per query with 8 per block left 8;
//   - each lane tests one candidate's gate and the warp ballots it; the
//     passing indices go, in increasing order, into a per-warp ring in
//     shared memory, and when 32 are queued each lane pops one and
//     popcounts it. A lane thus folds its candidates in increasing index
//     order (strict < keeps the lowest index, a tie goes to second), and
//     the warp's lanes, then the query's S warps, merge with an
//     order-independent lexicographic (best, idx) min: the result is
//     exact.
// Tensor cores are not used. A b1 mma.sync (m16n8k256 .and.popc) would be
// exact through |a| + |b| - 2 popc(a & b), but it computes every pair, and
// on the main path the gates discard 80-99.6% of them; the only ungated
// search, the reference-keyframe fallback (1000 x 1000 x 8 words, ~8M
// popcounts, ~2 us on the CUDA cores), runs only when motion tracking
// fails.
//
// Float path (D = 48, 64, 128; one instance per width): max(|q|^2 + |c|^2 -
// 2 q.c, 0) like the plain version. The candidates come prepared once per
// set (cuda_match.FloatSet: the contiguous rows and their norms, taken by
// the plain version's own expression, so they equal its norms bit for
// bit); a query's norm is a warp reduction in the kernel, so a search is
// one launch. What bounds it is again latency, not bytes or operations:
// the gates pass 0.14% of the pairs at anyfeat_nonbin's fusion search and
// 0.54% at its init search (0.13-1.9% at orb32's motion and local-map
// searches); only the unwindowed reference-keyframe search, one launch in
// about 1650 of a 48-frame System run, passes most (67.8%: at 1000 x 1000
// x 48 that is 32M FMAs, ~1 us at 67 TFLOP/s; chip_smoke.py phases 3 and
// 13, PERF.md). So best_two_f32_kernel is the binary path's block (32
// warps, S from Nq, gate data as float4 {u, v, size or NaN, norm}, gate
// first, per-warp queues, the ordered fold and lexicographic merge), each
// lane computing one queued candidate's distance in fp32 FFMA from the
// warp's query row in shared memory (read as a broadcast) and the
// candidate's row read from L2 by 16-byte loads: only passing rows are
// read, where staging every row in every block costs more than the gated
// work. A tile's sizes and validity flags go through registers and are
// stored after the thread's next stretch of work, so that no thread waits
// on a load while it could compute. Tensor cores are not used: a 3xTF32
// mma.sync search over staged rows was measured (PERF.md, section 7) and
// is faster only at unwindowed searches, which the System runs too rarely
// to matter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;               // warps per block (pack)
constexpr int kThreads = kWarps * 32;
constexpr int kMatchWarps = 32;         // warps per block (binary search)
constexpr int kMatchThreads = kMatchWarps * 32;
constexpr int kSms = 132;               // streaming multiprocessors of an H100 SXM
constexpr int kQueue = 64;              // ring of queued candidate rows per warp
constexpr int kWholeMax = 2048;         // candidate sets staged whole up to this size
constexpr int kTile = 1024;             // rows per tile (two buffers) above it

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
    o.best = __shfl_xor_sync(kFull, a.best, off);
    o.idx = __shfl_xor_sync(kFull, a.idx, off);
    o.second = __shfl_xor_sync(kFull, a.second, off);
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

// ------------------------------------------------------------ binary path

// (n, d) {0,1} bytes -> (n, nwords) little-endian bit words, zero tail.
// One warp per row: lane l reads byte 32 w + l (coalesced), and the warp's
// ballot is word w.
__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const uint8_t* __restrict__ bits, uint32_t* __restrict__ words,
                 int n, int d, int nwords) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // row is the same for the whole warp
  const uint8_t* src = bits + static_cast<size_t>(row) * d;
  uint32_t mine = 0;
  for (int w = 0; w < nwords; ++w) {
    const int k = 32 * w + lane;
    const uint32_t word = __ballot_sync(kFull, k < d && src[k] != 0);
    if (lane == w) mine = word;
  }
  if (lane < nwords) words[static_cast<size_t>(row) * nwords + lane] = mine;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// candidate rows [t0, t0 + n): words by cp.async (16 B chunks), gate data
// by plain loads as float4 {u, v, size or NaN where invalid, 0}
template <int W>
__device__ __forceinline__ void stage_tile(uint32_t* s_words, float4* s_gate,
                                           const uint32_t* __restrict__ c_words,
                                           const Side& s, int t0, int n) {
  const uint32_t* src = c_words + static_cast<size_t>(t0) * W;
  for (int i = threadIdx.x; i < n * (W / 4); i += kMatchThreads) {
    cp_async16(s_words + 4 * i, src + 4 * i);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < n; i += kMatchThreads) {
    const int j = t0 + i;
    const float size = s.c_valid[j] ? s.c_size[j] : __int_as_float(0x7fc00000);
    s_gate[i] = make_float4(s.c_uv[2 * j], s.c_uv[2 * j + 1], size, 0.0f);
  }
}

template <int W>
__device__ __forceinline__ float hamming(const uint32_t (&q)[W], const uint32_t* c) {
  const uint4* c4 = reinterpret_cast<const uint4*>(c);
  int pop = 0;
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const uint4 v = c4[k];
    pop += __popc(q[4 * k] ^ v.x) + __popc(q[4 * k + 1] ^ v.y) +
           __popc(q[4 * k + 2] ^ v.z) + __popc(q[4 * k + 3] ^ v.w);
  }
  return static_cast<float>(pop);
}

// dynamic shared memory of one block: the queues, the per-warp partial
// results, then the gate data and the words of one or two tiles
constexpr size_t kQueueBytes = static_cast<size_t>(kMatchWarps) * kQueue * sizeof(int);
constexpr size_t kPartBytes = static_cast<size_t>(kMatchWarps) * 16;

template <int W>
size_t smem_bytes(int tile, int nbuf) {
  return kQueueBytes + kPartBytes +
         static_cast<size_t>(nbuf) * tile * (sizeof(float4) + W * sizeof(uint32_t));
}

template <int W>
size_t smem_max() {
  const size_t whole = smem_bytes<W>(kWholeMax, 1);
  const size_t tiled = smem_bytes<W>(kTile, 2);
  return whole > tiled ? whole : tiled;
}

// q_bits (nq, d) bytes, c_words (nc, W) words. A block serves G = 32 / S
// queries; query g of the block is served by warps g*S .. g*S+S-1, each
// scanning every S-th 32-candidate chunk, and their results are merged at
// the end. `tile` is nc (staged whole) or kTile (two buffers).
template <int W, int S>
__global__ void __launch_bounds__(kMatchThreads)
best_two_bits_kernel(const uint8_t* __restrict__ q_bits, const uint32_t* __restrict__ c_words,
                     int nq, int nc, int d, int tile, Side s) {
  constexpr int G = kMatchWarps / S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbuf = tile < nc ? 2 : 1;
  int* s_queue = reinterpret_cast<int*>(smem_raw);
  Best2* s_part = reinterpret_cast<Best2*>(smem_raw + kQueueBytes);
  float4* s_gate = reinterpret_cast<float4*>(smem_raw + kQueueBytes + kPartBytes);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_gate + nbuf * tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = warp % S;
  const unsigned below = (1u << lane) - 1u;
  const int ntiles = (nc + tile - 1) / tile;

  // the first tile is in flight while each warp packs its query
  stage_tile<W>(s_words, s_gate, c_words, s, 0, min(tile, nc));

  const int q = blockIdx.x * G + warp / S;
  const bool active = q < nq;  // an inactive query keeps rad = -1: no gate passes
  const uint8_t* src = q_bits + static_cast<size_t>(q) * d;
  uint32_t qr[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int k = 32 * w + lane;
    qr[w] = __ballot_sync(kFull, active && k < d && src[k] != 0);
  }
  const float qu = active ? s.q_uv[2 * q] : 0.0f;
  const float qv = active ? s.q_uv[2 * q + 1] : 0.0f;
  const float rad = active ? s.q_rad[q] : -1.0f;
  const float slo = active ? s.q_slo[q] : 0.0f;
  const float shi = active ? s.q_shi[q] : 0.0f;
  Best2 acc{kInf, -1, kInf};
  int* queue = s_queue + warp * kQueue;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * tile;
    const int n = min(tile, nc - t0);
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // the next tile goes into the other buffer
      const int t1 = t0 + tile;
      stage_tile<W>(s_words + (buf ^ 1) * tile * W, s_gate + (buf ^ 1) * tile, c_words, s,
                    t1, min(tile, nc - t1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tile_gate = s_gate + buf * tile;
    const uint32_t* tile_words = s_words + buf * tile * W;

    int head = 0, tail = 0;
    for (int base = 32 * split; base < n; base += 32 * S) {
      const int j = base + lane;
      const float4 g = j < n ? tile_gate[j] : make_float4(0.0f, 0.0f, __int_as_float(0x7fc00000), 0.0f);
      const bool pass = fabsf(qu - g.x) <= rad && fabsf(qv - g.y) <= rad && g.z >= slo &&
                        g.z <= shi;
      const unsigned ballot = __ballot_sync(kFull, pass);
      if (pass) queue[(tail + __popc(ballot & below)) & (kQueue - 1)] = j;
      tail += __popc(ballot);
      if (tail - head >= 32) {  // 32 queued: one each
        __syncwarp();
        const int jj = queue[(head + lane) & (kQueue - 1)];
        __syncwarp();
        head += 32;
        fold(acc, hamming<W>(qr, tile_words + jj * W), t0 + jj);
      }
    }
    __syncwarp();  // the rest of the queue, fewer than 32
    if (lane < tail - head) {
      const int jj = queue[(head + lane) & (kQueue - 1)];
      fold(acc, hamming<W>(qr, tile_words + jj * W), t0 + jj);
    }
    __syncthreads();  // this buffer and the queues are reused by the next tile
  }

  acc = warp_merge(acc);
  if (S > 1) {  // merge the query's S warps (order-independent)
    if (lane == 0) s_part[warp] = acc;
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int k = 1; k < S; ++k) acc = merge(acc, s_part[warp + k]);
  }
  if (lane == 0 && active) {
    s.best[q] = acc.best;
    s.idx[q] = acc.idx;
    s.second[q] = acc.second;
  }
}

template <int W, int S>
int set_smem_limit() {
  return static_cast<int>(cudaFuncSetAttribute(best_two_bits_kernel<W, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_max<W>())));
}

template <int W, int S>
void launch_bits(const uint8_t* q_bits, const uint32_t* c_words, int nq, int nc, int d,
                 const Side& s, cudaStream_t stream) {
  constexpr int G = kMatchWarps / S;
  const int tile = nc <= kWholeMax ? nc : kTile;
  const int nbuf = tile < nc ? 2 : 1;
  const int grid = (nq + G - 1) / G;
  best_two_bits_kernel<W, S><<<grid, kMatchThreads, smem_bytes<W>(tile, nbuf), stream>>>(
      q_bits, c_words, nq, nc, d, tile, s);
}

template <int W>
void launch_bits_split(const uint8_t* q_bits, const uint32_t* c_words, int nq, int nc, int d,
                       const Side& s, cudaStream_t stream) {
  // split a query's candidates over more warps while the grid still fits
  // one wave of one block per SM
  if (nq * 8 <= kMatchWarps * kSms) {
    launch_bits<W, 8>(q_bits, c_words, nq, nc, d, s, stream);
  } else if (nq * 4 <= kMatchWarps * kSms) {
    launch_bits<W, 4>(q_bits, c_words, nq, nc, d, s, stream);
  } else if (nq * 2 <= kMatchWarps * kSms) {
    launch_bits<W, 2>(q_bits, c_words, nq, nc, d, s, stream);
  } else {
    launch_bits<W, 1>(q_bits, c_words, nq, nc, d, s, stream);
  }
}

// ------------------------------------------------------------- float path

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// A float tile's gate data, float4 {u, v, size or NaN where invalid, norm}
// per candidate, staged in two steps so that no thread waits on a load
// while it could compute: stage() issues u, v and the norm by cp.async and
// loads this thread's sizes and validity flags into registers; finish()
// stores the size (or NaN) after the thread's next stretch of work.
template <int kPer>
struct GateStage {
  float size[kPer];
  uint8_t valid[kPer];

  __device__ __forceinline__ void stage(float4* s_gate, const float* __restrict__ c_norm,
                                        const Side& s, int t0, int n) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kMatchThreads;
      if (i < n) {
        float* g = reinterpret_cast<float*>(s_gate + i);
        cp_async8(g, s.c_uv + 2 * (t0 + i));
        cp_async4(g + 3, c_norm + t0 + i);
        size[p] = s.c_size[t0 + i];
        valid[p] = s.c_valid[t0 + i];
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void finish(float4* s_gate, int n) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kMatchThreads;
      if (i < n) {
        reinterpret_cast<float*>(s_gate + i)[2] =
            valid[p] ? size[p] : __int_as_float(0x7fc00000);
      }
    }
  }
};

// Shared memory of a block: the queues, the per-warp partial results, each
// warp's query row, then one or two tiles of gate data.
template <int D>
size_t f32_smem_bytes(int tile, int nbuf) {
  return kQueueBytes + kPartBytes + static_cast<size_t>(kMatchWarps) * D * sizeof(float) +
         static_cast<size_t>(nbuf) * tile * sizeof(float4);
}

template <int D>
size_t f32_smem_max() {
  const size_t whole = f32_smem_bytes<D>(kWholeMax, 1);
  const size_t tiled = f32_smem_bytes<D>(kTile, 2);
  return whole > tiled ? whole : tiled;
}

// max(|q|^2 + |c|^2 - 2 q.c, 0) in fp32 FFMA: q from shared memory (a
// broadcast to the warp), c from L2 by 16-byte loads
template <int D>
__device__ __forceinline__ float l2sq(const float* q, float qn, const float* __restrict__ c,
                                      float cn) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  float ax = 0.0f, ay = 0.0f, az = 0.0f, aw = 0.0f;
#pragma unroll 4
  for (int k = 0; k < D / 4; ++k) {
    const float4 a = q4[k];
    const float4 b = __ldg(c4 + k);
    ax = fmaf(a.x, b.x, ax);
    ay = fmaf(a.y, b.y, ay);
    az = fmaf(a.z, b.z, az);
    aw = fmaf(a.w, b.w, aw);
  }
  return fmaxf(qn + cn - 2.0f * ((ax + ay) + (az + aw)), 0.0f);
}

// q (nq, D) rows, c_rows (nc, D) rows and c_norm (nc,) their squared norms
// (the prepared set). The binary kernel's block: G = 32 / S queries, each
// served by S warps that scan every S-th 32-candidate chunk, gate first,
// and queue the passing candidates; each lane then reads one queued row
// from L2. A query's norm is a warp reduction. `tile` is nc (one buffer)
// or kTile (two buffers).
template <int D, int S>
__global__ void __launch_bounds__(kMatchThreads)
best_two_f32_kernel(const float* __restrict__ qf, const float* __restrict__ c_rows,
                    const float* __restrict__ c_norm, int nq, int nc, int tile, Side s) {
  constexpr int G = kMatchWarps / S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_queue = reinterpret_cast<int*>(smem_raw);
  Best2* s_part = reinterpret_cast<Best2*>(smem_raw + kQueueBytes);
  float* s_q = reinterpret_cast<float*>(smem_raw + kQueueBytes + kPartBytes);
  float4* s_gate = reinterpret_cast<float4*>(s_q + kMatchWarps * D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = warp % S;
  const unsigned below = (1u << lane) - 1u;
  const int ntiles = (nc + tile - 1) / tile;
  GateStage<(kWholeMax + kMatchThreads - 1) / kMatchThreads> cur, next;

  // the first tile is in flight while each warp loads its query
  cur.stage(s_gate, c_norm, s, 0, min(tile, nc));
  const int q = blockIdx.x * G + warp / S;
  const bool active = q < nq;  // an inactive query keeps rad = -1: no gate passes
  float* my_q = s_q + warp * D;
  float qn = 0.0f;
  if (active) {
    const float4* src = reinterpret_cast<const float4*>(qf + static_cast<size_t>(q) * D);
    for (int k = lane; k < D / 4; k += 32) {
      const float4 x = src[k];
      reinterpret_cast<float4*>(my_q)[k] = x;
      qn += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) qn += __shfl_xor_sync(kFull, qn, off);
  const float qu = active ? s.q_uv[2 * q] : 0.0f;
  const float qv = active ? s.q_uv[2 * q + 1] : 0.0f;
  const float rad = active ? s.q_rad[q] : -1.0f;
  const float slo = active ? s.q_slo[q] : 0.0f;
  const float shi = active ? s.q_shi[q] : 0.0f;
  cur.finish(s_gate, min(tile, nc));
  Best2 acc{kInf, -1, kInf};
  int* queue = s_queue + warp * kQueue;

  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * tile;
    const int n = min(tile, nc - t0);
    const int buf = t & 1;
    const int n1 = t + 1 < ntiles ? min(tile, nc - t0 - tile) : 0;
    if (n1 > 0) {  // the next tile goes into the other buffer
      next.stage(s_gate + (buf ^ 1) * tile, c_norm, s, t0 + tile, n1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's gate data, the query rows
    const float4* tile_gate = s_gate + buf * tile;
    const float* tile_rows = c_rows + static_cast<size_t>(t0) * D;

    if (rad >= 0.0f) {  // warp-uniform: a disabled query scans nothing
      int head = 0, tail = 0;
      for (int base = 32 * split; base < n; base += 32 * S) {
        const int j = base + lane;
        const float4 g = j < n ? tile_gate[j]
                               : make_float4(0.0f, 0.0f, __int_as_float(0x7fc00000), 0.0f);
        const bool pass = fabsf(qu - g.x) <= rad && fabsf(qv - g.y) <= rad && g.z >= slo &&
                          g.z <= shi;
        const unsigned ballot = __ballot_sync(kFull, pass);
        if (pass) queue[(tail + __popc(ballot & below)) & (kQueue - 1)] = j;
        tail += __popc(ballot);
        if (tail - head >= 32) {  // 32 queued: one each
          __syncwarp();
          const int jj = queue[(head + lane) & (kQueue - 1)];
          __syncwarp();
          head += 32;
          fold(acc, l2sq<D>(my_q, qn, tile_rows + jj * D, tile_gate[jj].w), t0 + jj);
        }
      }
      __syncwarp();  // the rest of the queue, fewer than 32
      if (lane < tail - head) {
        const int jj = queue[(head + lane) & (kQueue - 1)];
        fold(acc, l2sq<D>(my_q, qn, tile_rows + jj * D, tile_gate[jj].w), t0 + jj);
      }
    }
    if (n1 > 0) next.finish(s_gate + (buf ^ 1) * tile, n1);
    __syncthreads();  // this buffer and the queues are reused by the next tile
  }

  acc = warp_merge(acc);
  if (S > 1) {  // merge the query's S warps (order-independent)
    if (lane == 0) s_part[warp] = acc;
    __syncthreads();
    if (split != 0) return;
#pragma unroll
    for (int k = 1; k < S; ++k) acc = merge(acc, s_part[warp + k]);
  }
  if (lane == 0 && active) {
    s.best[q] = acc.best;
    s.idx[q] = acc.idx;
    s.second[q] = acc.second;
  }
}

template <int D, int S>
int set_smem_limit_f32() {
  return static_cast<int>(cudaFuncSetAttribute(best_two_f32_kernel<D, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(f32_smem_max<D>())));
}

template <int D, int S>
cudaError_t launch_f32(const float* q, const float* c_rows, const float* c_norm, int nq, int nc,
                       const Side& s, cudaStream_t stream) {
  constexpr int G = kMatchWarps / S;
  const int tile = nc <= kWholeMax ? nc : kTile;
  const int nbuf = tile < nc ? 2 : 1;
  const int grid = (nq + G - 1) / G;
  best_two_f32_kernel<D, S><<<grid, kMatchThreads, f32_smem_bytes<D>(tile, nbuf), stream>>>(
      q, c_rows, c_norm, nq, nc, tile, s);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_split(const float* q, const float* c_rows, const float* c_norm, int nq,
                             int nc, const Side& s, cudaStream_t stream) {
  // as launch_bits_split: S warps per query while the grid fits one wave
  if (nq * 8 <= kMatchWarps * kSms) return launch_f32<D, 8>(q, c_rows, c_norm, nq, nc, s, stream);
  if (nq * 4 <= kMatchWarps * kSms) return launch_f32<D, 4>(q, c_rows, c_norm, nq, nc, s, stream);
  if (nq * 2 <= kMatchWarps * kSms) return launch_f32<D, 2>(q, c_rows, c_norm, nq, nc, s, stream);
  return launch_f32<D, 1>(q, c_rows, c_norm, nq, nc, s, stream);
}

Side make_side(const float* q_uv, const float* q_rad, const float* q_slo,
               const float* q_shi, const float* c_uv, const float* c_size,
               const uint8_t* c_valid, float* best, int* idx, float* second) {
  return Side{q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid, best, idx, second};
}

}  // namespace

// Raises the dynamic shared memory limit of every search kernel instance to
// what its largest launch asks (binary up to 172 KB, float up to 57 KB).
// Call once per device before the first launch; returns the first CUDA
// error, 0 on success.
extern "C" int best_two_init() {
  int (*const setters[])() = {
      set_smem_limit<8, 1>,  set_smem_limit<8, 2>,  set_smem_limit<8, 4>,  set_smem_limit<8, 8>,
      set_smem_limit<12, 1>, set_smem_limit<12, 2>, set_smem_limit<12, 4>, set_smem_limit<12, 8>,
      set_smem_limit<16, 1>, set_smem_limit<16, 2>, set_smem_limit<16, 4>, set_smem_limit<16, 8>,
#define F32_SETTERS(D)                                                          \
  set_smem_limit_f32<D, 1>, set_smem_limit_f32<D, 2>, set_smem_limit_f32<D, 4>, \
      set_smem_limit_f32<D, 8>
      F32_SETTERS(48), F32_SETTERS(64), F32_SETTERS(128),
#undef F32_SETTERS
  };
  for (auto set : setters) {
    const int err = set();
    if (err != 0) return err;
  }
  return 0;
}

// bits (n, d) {0,1} uint8 -> words (n, nwords) uint32, nwords = ceil(d / 32),
// both contiguous on the current device, n >= 1. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int pack_bits(const uint8_t* bits, uint32_t* words, int n, int d, int nwords,
                         void* stream_ptr) {
  if (d < 1 || nwords != (d + 31) / 32 || nwords > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n + kWarps - 1) / kWarps;
  pack_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      bits, words, n, d, nwords);
  return static_cast<int>(cudaGetLastError());
}

// Binary path, one launch. q_bits (nq, d) {0,1} uint8, c_words (nc, nwords)
// uint32 from pack_bits with the same d, 16-byte aligned; nwords = 8, 12 or
// 16. Side arrays float32 / bool, outputs (nq,) float32 / int32 / float32,
// all contiguous on the current device; nq, nc >= 1; best_two_init() done.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int best_two_bits(const uint8_t* q_bits, const uint32_t* c_words,
                             int nq, int nc, int d, int nwords,
                             const float* q_uv, const float* q_rad,
                             const float* q_slo, const float* q_shi,
                             const float* c_uv, const float* c_size,
                             const uint8_t* c_valid, float* best, int* idx,
                             float* second, void* stream_ptr) {
  if (nwords != (d + 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Side s = make_side(q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                           best, idx, second);
  switch (nwords) {
    case 8: launch_bits_split<8>(q_bits, c_words, nq, nc, d, s, stream); break;
    case 12: launch_bits_split<12>(q_bits, c_words, nq, nc, d, s, stream); break;
    case 16: launch_bits_split<16>(q_bits, c_words, nq, nc, d, s, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Float path, one launch. q (nq, d) float32 rows, c_rows (nc, d) float32
// rows and c_norm (nc,) their squared norms, all 16-byte aligned, d = 48,
// 64 or 128; c_uv 8-byte aligned. Side arrays and outputs as in
// best_two_bits.
extern "C" int best_two_f32(const float* q, const float* c_rows, const float* c_norm,
                            int nq, int nc, int d, const float* q_uv,
                            const float* q_rad, const float* q_slo, const float* q_shi,
                            const float* c_uv, const float* c_size, const uint8_t* c_valid,
                            float* best, int* idx, float* second, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Side s = make_side(q_uv, q_rad, q_slo, q_shi, c_uv, c_size, c_valid,
                           best, idx, second);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
    case 48: err = launch_f32_split<48>(q, c_rows, c_norm, nq, nc, s, stream); break;
    case 64: err = launch_f32_split<64>(q, c_rows, c_norm, nq, nc, s, stream); break;
    case 128: err = launch_f32_split<128>(q, c_rows, c_norm, nq, nc, s, stream); break;
    default: break;
  }
  return static_cast<int>(err);
}
