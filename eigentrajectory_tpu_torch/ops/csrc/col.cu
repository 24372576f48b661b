// COL, the collision rate % per pedestrian of the min-of-S evaluation, for
// sm_90a: one block a scene row, over the row's valid pairs only.
//
// Replaces no Pallas kernel. It computes `metrics.col` (the port's
// eigentrajectory_tpu_torch/metrics.py::_col, the JAX package's
// eigentrajectory_tpu/metrics.py::col under vmap) on the trajectories that
// `fused_recon_metrics` leaves, in their (S, P, T, 2) layout. For each
// sample a pedestrian's dense window is its first 14 positions at 4 steps a
// segment: position 0, then a running f32 sum of rel = (p[t+1] - p[t]) / 4,
// added four times a segment (the cumsum of `_dense_window`). A pedestrian
// collides in a sample where, for another valid pedestrian of its row, the
// minimum over the window of the distance sqrt(dx*dx + dy*dy) is below 0.2
// (a NaN at any step makes that minimum NaN, as under amin: no collision).
// Its COL is the share of samples in which it collides, x 100; padded
// slots read 0.
//
// Bound: neither bytes nor operations but latency. The plain version builds
// the (R, S, 14, m, m) distances of every slot pair, padding included: at
// the evaluation block (320 x 57, S = 20) 1.16 GB, 94% of whose slots are
// padding, in a dozen launches. The work that matters is the valid pairs: a
// few thousand x S x 14 distances from 40 bytes a (sample, pedestrian).
// Each block makes one round trip to device memory for its row's mask and
// one for its positions, then computes in shared memory; the launch, those
// two round trips and a few barriers a block are its time.
//
// The design: a block a row. The block compacts the row's valid slots (a
// ballot a warp, the warps' counts in shared memory), so that no thread
// ever touches a padded slot. Then, for as many samples at a time as fit
// its shared memory (every sample, unless the row is dense and long), each
// thread builds the windows of (sample, pedestrian) items from the first 5
// positions, in shared memory; the threads stride over the (sample, pair)
// items, each unordered pair once, and flag both pedestrians of a pair that
// collides; each pedestrian's thread adds its flags to its count. A row's
// slots are r*m .. r*m + m - 1 of the pedestrian axis, or the row's entries
// of a `gather` map (the packed regime's scene blocks), read in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInterp = 4;                        // dense steps a segment
constexpr int kTd = 3 * kInterp + 2;              // the window: 14 positions
constexpr int kSeg = (kTd - 1 + kInterp - 1) / kInterp;   // 4 segments reach it
constexpr int kStride = kTd + 1;                  // a window's float2s, padded
constexpr int kItemWords = 2 * kStride + 1;       // a window and its flag
constexpr int kDefaultWords = 48 * 1024 / 4;      // shared memory without opt-in
constexpr int kMaxWords = 227 * 1024 / 4;         // what one block may hold
constexpr float kThres = 0.2f;

// Shared memory in 32-bit words: the warps' ballot counts, the row's valid
// slots in order and each one's count, then the items of a batch of samples.
__host__ __device__ inline int words_for(int slots) {
  return kWarps + 2 * slots + kItemWords * slots;   // at least one sample
}

// The q-th unordered pair of n: (i, i + d mod n) for d = 1 .. (n - 1) / 2,
// then, for an even n, (i, i + n / 2) for i < n / 2.
__device__ __forceinline__ void pair_of(int q, int n, int& i, int& j) {
  const int h = (n - 1) / 2;
  if (q < n * h) {
    i = q % n;
    j = i + 1 + q / n;
    if (j >= n) j -= n;
  } else {
    i = q - n * h;
    j = i + n / 2;
  }
}

__global__ void __launch_bounds__(kThreads)
col_kernel(const float* __restrict__ recon, const unsigned char* __restrict__ valid,
           const long long* __restrict__ gather, float* __restrict__ out, int slots,
           int peds, int n_samples, int t_len, int words) {
  extern __shared__ int smem[];
  int* const warp_count = smem;
  int* const slot_of = smem + kWarps;
  int* const count = slot_of + slots;
  int* const items = count + slots;
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned char* const v_row = valid + static_cast<size_t>(row) * slots;

  // --- the row's valid slots, in order ---
  int nv = 0;
  for (int k0 = 0; k0 < slots; k0 += kThreads) {
    const int k = k0 + tid;
    const bool v = k < slots && v_row[k];
    const unsigned ballot = __ballot_sync(~0u, v);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = nv;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_count[w] : 0;
      nv += warp_count[w];
    }
    if (v) slot_of[before + __popc(ballot & ((1u << lane) - 1u))] = k;
    __syncthreads();                    // the counts are read before the next chunk
  }
  for (int i = tid; i < nv; i += kThreads) count[i] = 0;

  if (nv >= 2) {
    const int pairs = nv * (nv - 1) / 2;
    const int batch = min(n_samples, (words - kWarps - 2 * slots) / (kItemWords * nv));
    float2* const win = reinterpret_cast<float2*>(items);           // [batch][nv][kStride]
    int* const flag = items + 2 * kStride * batch * nv;             // [batch][nv]
    const float2* const pos = reinterpret_cast<const float2*>(recon);
    for (int s0 = 0; s0 < n_samples; s0 += batch) {
      const int ns = min(batch, n_samples - s0);
      // --- the windows of (sample, pedestrian) ---
      for (int u = tid; u < ns * nv; u += kThreads) {
        const int sl = u / nv, k = slot_of[u - sl * nv];
        const size_t at = static_cast<size_t>(row) * slots + k;
        const long long p = gather != nullptr ? gather[at] : static_cast<long long>(at);
        const float2* const src = pos + (static_cast<size_t>(s0 + sl) * peds + p) * t_len;
        float2 pt[kSeg + 1];
#pragma unroll
        for (int t = 0; t <= kSeg; ++t) pt[t] = src[t];
        float2* const w = win + static_cast<size_t>(u) * kStride;
        float2 acc = pt[0];
        w[0] = acc;
#pragma unroll
        for (int seg = 0; seg < kSeg; ++seg) {
          const float rx = __fsub_rn(pt[seg + 1].x, pt[seg].x) / kInterp;
          const float ry = __fsub_rn(pt[seg + 1].y, pt[seg].y) / kInterp;
#pragma unroll
          for (int r = 0; r < kInterp; ++r) {
            const int d = 1 + seg * kInterp + r;
            if (d < kTd) {
              acc.x = __fadd_rn(acc.x, rx);
              acc.y = __fadd_rn(acc.y, ry);
              w[d] = acc;
            }
          }
        }
        flag[u] = 0;
      }
      __syncthreads();
      // --- the (sample, pair) items ---
      for (int u = tid; u < ns * pairs; u += kThreads) {
        const int sl = u / pairs;
        int i, j;
        pair_of(u - sl * pairs, nv, i, j);
        const float2* const a = win + static_cast<size_t>(sl * nv + i) * kStride;
        const float2* const b = win + static_cast<size_t>(sl * nv + j) * kStride;
        bool hit = false, nan = false;
#pragma unroll
        for (int d = 0; d < kTd; ++d) {
          const float2 x = a[d], y = b[d];
          const float dx = __fsub_rn(x.x, y.x), dy = __fsub_rn(x.y, y.y);
          const float dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
          hit |= dist < kThres;
          nan |= dist != dist;
        }
        if (hit && !nan) {             // both store 1: the order does not matter
          flag[sl * nv + i] = 1;
          flag[sl * nv + j] = 1;
        }
      }
      __syncthreads();
      for (int i = tid; i < nv; i += kThreads) {
        int c = count[i];
        for (int sl = 0; sl < ns; ++sl) c += flag[sl * nv + i];
        count[i] = c;
      }
      __syncthreads();                  // the items are read before the next batch
    }
  }

  // --- out: the mean over the samples as torch's mean takes it (the sum
  // times 1 / S), x 100; 0 on a padded slot ---
  const float per_sample = 1.0f / static_cast<float>(n_samples);
  float* const o = out + static_cast<size_t>(row) * slots;
  for (int i = tid; i < nv; i += kThreads)
    o[slot_of[i]] = __fmul_rn(__fmul_rn(static_cast<float>(count[i]), per_sample), 100.0f);
  for (int k = tid; k < slots; k += kThreads)
    if (!v_row[k]) o[k] = 0.f;
}

}  // namespace

// recon (s, peds, t, 2) f32, 8-byte aligned; valid (rows, slots) one byte
// each; gather (rows, slots) int64, or null for the identity map (slot k of
// row r is pedestrian r * slots + k, so peds == rows * slots); out (rows,
// slots) f32; all contiguous on the device. A valid slot's gather entry
// must lie in [0, peds). Launches on `stream` and returns cudaGetLastError()
// (0 on success); no rows or slots launch nothing.
extern "C" int et_col(const float* recon, const unsigned char* valid, const long long* gather,
                      float* out, int rows, int slots, int peds, int s, int t, void* stream) {
  if (t != 12 || s < 1 || rows < 0 || slots < 0 || peds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || slots == 0) return static_cast<int>(cudaSuccess);
  if (words_for(slots) > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(recon) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int words = words_for(slots) > kDefaultWords ? words_for(slots) : kDefaultWords;
  const size_t bytes = static_cast<size_t>(words) * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  col_kernel<<<rows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      recon, valid, gather, out, slots, peds, s, t, words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
