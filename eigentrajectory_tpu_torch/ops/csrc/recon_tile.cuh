// The pedestrian tile that reconstruct.cu and recon_metrics.cu share: how a
// block brings its inputs into shared memory, how one (pedestrian, sample)
// is reconstructed, and how a sample's trajectories leave through shared
// memory. Both kernels call the same functions, with every fused
// multiply-add written out, so they give the same trajectories bit for bit.
//
// A block takes kTile = 32 consecutive pedestrians and all S samples. In the
// public layouts the tile is contiguous on both sides: for each k the
// coefficients (k, N, S) are one run of 32*S floats, and for each sample the
// trajectories (S, N, T, 2) are one run of 32*2T floats. So
//
//  - everything the tile reads comes in by cp.async, 16 bytes a lane on
//    neighbouring addresses (4 bytes where S is not a multiple of 4 or a
//    pointer is not 16-byte aligned), each pedestrian's row of coefficients
//    from the branch its mask selects. The copies need no registers, so a
//    thread has all of its share in flight at once and waits once; the
//    mask, which the addresses depend on, is one load and one ballot a warp;
//  - a warp reconstructs one sample of the 32 pedestrians (lane = pedestrian),
//    reading the basis of its branch from shared memory two rows (one time
//    step) at a time as three 16-byte broadcast loads;
//  - each lane puts its 2T floats into the warp's own 3 KB stage, and the warp
//    stores the stage as the contiguous run it is: 16 bytes a lane, 512
//    contiguous bytes an instruction. Only the warp synchronises for that.

#pragma once

#include <cuda_runtime.h>

namespace et {

constexpr int kTile = 32;              // pedestrians of a block = lanes of a warp

// One pedestrian's denormalisation, held in registers by its lane.
struct Ped {
  float scale, r00, r01, r10, r11, ox, oy;
  bool moving;
};

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Asynchronous copies from device memory to shared memory (cp.async).
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
// Wait for every copy this thread has started.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of a tile, carved from the block's dynamic shared memory, for
// a block of W warps. Every part starts on a 16-byte boundary.
template <int T, int K, int W>
struct Tile {
  static constexpr int T2 = 2 * T;
  static constexpr int kThreads = 32 * W;
  static_assert((2 * K) % 4 == 0, "a time step's two basis rows are read as float4");
  static_assert(T2 % 4 == 0, "the trajectories are staged and stored as float4");

  float* u;        // [2][T2 * K]     both bases, row-major (2T, K)
  float* rot;      // [kTile][4]
  float* ori;      // [kTile][2]
  float* sca;      // [kTile]
  float* coef;     // [K][kTile][S]   the selected branch of each pedestrian
  float* stage;    // [W][kTile][T2]  one sample's trajectories a warp

  static __host__ __device__ int round4(int floats) { return (floats + 3) & ~3; }
  static __host__ __device__ int floats(int n_samples) {
    return 2 * T2 * K + 7 * kTile + round4(K * kTile * n_samples) + W * kTile * T2;
  }
  __device__ Tile(float* smem, int n_samples) {
    u = smem;
    rot = u + 2 * T2 * K;
    ori = rot + 4 * kTile;
    sca = ori + 2 * kTile;
    coef = sca + kTile;
    stage = coef + round4(K * kTile * n_samples);
  }
  __device__ float* end() const { return stage + W * kTile * T2; }

  // Start the copy of a contiguous run of n floats; every thread of the
  // block calls it.
  static __device__ __forceinline__ void copy_run(float* dst, const float* src, int n) {
    if (aligned16(src) && (n & 3) == 0) {
      for (int i = threadIdx.x; i < (n >> 2); i += kThreads)
        copy_async16(dst + 4 * i, src + 4 * i);
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) copy_async4(dst + i, src + i);
    }
  }

  // Start the copies of the tile of pedestrians [n0, n0 + np); `moving` has
  // bit p set where pedestrian n0 + p is moving. Every thread of the block
  // calls it, then copy_async_wait(), then the block synchronises.
  __device__ __forceinline__ void load(
      const float* __restrict__ c_m, const float* __restrict__ c_s,
      const float* __restrict__ u_m, const float* __restrict__ u_s,
      const float* __restrict__ ori_g, const float* __restrict__ rot_g,
      const float* __restrict__ sca_g, unsigned moving, size_t n0, int np, size_t n_peds,
      int n_samples) const {
    const size_t c_row = n_peds * n_samples;           // stride of k
    const size_t c_tile = n0 * n_samples;              // the tile's offset in a row
    const int run = np * n_samples;                    // the tile's floats in a row
    // Coefficients first: they are most of what is read.
    if ((n_samples & 3) == 0 && aligned16(c_m) && aligned16(c_s)) {
      const int run4 = run >> 2;
      for (int j = threadIdx.x; j < K * run4; j += kThreads) {
        const int kk = j / run4;
        const int e = (j - kk * run4) << 2;
        const float* src = ((moving >> (e / n_samples)) & 1u) ? c_m : c_s;
        copy_async16(coef + kk * kTile * n_samples + e, src + kk * c_row + c_tile + e);
      }
    } else {
      for (int j = threadIdx.x; j < K * run; j += kThreads) {
        const int kk = j / run;
        const int e = j - kk * run;
        const float* src = ((moving >> (e / n_samples)) & 1u) ? c_m : c_s;
        copy_async4(coef + kk * kTile * n_samples + e, src + kk * c_row + c_tile + e);
      }
    }
    copy_run(u, u_m, T2 * K);
    copy_run(u + T2 * K, u_s, T2 * K);
    copy_run(rot, rot_g + 4 * n0, 4 * np);
    copy_run(ori, ori_g + 2 * n0, 2 * np);
    copy_run(sca, sca_g + n0, np);
  }

  // Pedestrian p's denormalisation, from the tile in shared memory.
  __device__ __forceinline__ Ped ped(int p, unsigned moving) const {
    Ped out;
    out.moving = (moving >> p) & 1u;
    const float sc = sca[p];
    // The moving branch is divided by sca (0 where sca == 0); the static
    // branch is not scaled.
    out.scale = out.moving ? (sc != 0.f ? 1.f / sc : 0.f) : 1.f;
    const float4 r = reinterpret_cast<const float4*>(rot)[p];
    out.r00 = r.x;
    out.r01 = r.y;
    out.r10 = r.z;
    out.r11 = r.w;
    const float2 o = reinterpret_cast<const float2*>(ori)[p];
    out.ox = o.x;
    out.oy = o.y;
    return out;
  }

  // The basis of the pedestrian's branch.
  __device__ __forceinline__ const float* basis(const Ped& p) const {
    return u + (p.moving ? 0 : T2 * K);
  }

  // Sample s of pedestrian p: its K coefficients.
  __device__ __forceinline__ void coefficients(int p, int s, int n_samples,
                                               float (&cc)[K]) const {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) cc[kk] = coef[(kk * kTile + p) * n_samples + s];
  }
};

// Bit p set where pedestrian n0 + p of the tile is moving: one load a lane
// and a ballot. The whole warp calls it.
__device__ __forceinline__ unsigned moving_bits(const unsigned char* __restrict__ mask,
                                                size_t n0, int np) {
  const int lane = threadIdx.x & 31;
  return __ballot_sync(0xffffffffu, lane < np && mask[n0 + lane] != 0);
}

// One time step t of one (pedestrian, sample): (x, y) = rows 2t and 2t+1 of
// the basis times the coefficients, summed over k in order; scaled; rotated
// by rot and moved to ori. Every rounding is fixed here: the multiply-adds
// are written out, so no compiler choice can differ between two callers.
template <int K>
__device__ __forceinline__ void recon_step(const float* __restrict__ u, int t,
                                           const float (&cc)[K], const Ped& ped,
                                           float& wx, float& wy) {
  float rows[2 * K];
  const float4* src = reinterpret_cast<const float4*>(u + 2 * K * t);
#pragma unroll
  for (int i = 0; i < (2 * K) / 4; ++i) {
    const float4 v = src[i];
    rows[4 * i] = v.x;
    rows[4 * i + 1] = v.y;
    rows[4 * i + 2] = v.z;
    rows[4 * i + 3] = v.w;
  }
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    x = __fmaf_rn(rows[kk], cc[kk], x);
    y = __fmaf_rn(rows[K + kk], cc[kk], y);
  }
  x = __fmul_rn(x, ped.scale);
  y = __fmul_rn(y, ped.scale);
  wx = __fmaf_rn(x, ped.r00, __fmaf_rn(y, ped.r01, ped.ox));
  wy = __fmaf_rn(x, ped.r10, __fmaf_rn(y, ped.r11, ped.oy));
}

// The warp's stage holds one sample of the tile's pedestrians, [p][2T]; store
// its first np pedestrians as the contiguous run they are in (S, N, T, 2).
// The whole warp calls it; `out` is 16-byte aligned.
template <int T>
__device__ __forceinline__ void store_sample(const float* stage, float* __restrict__ out,
                                             int s, size_t n_peds, size_t n0, int np,
                                             int lane) {
  constexpr int kVecs = 2 * T / 4;                     // float4 a pedestrian
  __syncwarp();                                        // the stage is written
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<size_t>(s) * n_peds + n0) * 2 * T);
  const float4* src = reinterpret_cast<const float4*>(stage);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int q = i * 32 + lane;
    if (q < np * kVecs) dst[q] = src[q];
  }
  __syncwarp();                                        // the stage is free again
}

}  // namespace et
