// Fused ET reconstruction + denormalization + moving/static select, for sm_90a.
//
// Replaces the TPU kernel `fused_reconstruct` of
// eigentrajectory_tpu/ops/pallas_recon.py (kernel body `_kernel`, lines
// 32-70; pallas_call at line 106). It is the serving tail: no ground truth,
// no metrics.
//
// For pedestrian n and sample s it reconstructs the 2T positions U @ C of
// the branch the moving mask selects, divides by `sca` on the moving branch
// only (0 where sca == 0, as the Pallas kernel does), rotates by rot^T, adds
// `ori`, and writes the sample to out (S, N, T, 2).
//
// Bound: memory. Per pedestrian it reads the selected branch's coefficients
// (k*S*4 = 480 B at k=6, S=20) and about 29 B of params, and writes
// S*T*2*4 = 1,920 B: the output is four times the input. The f32 operations
// (2*2*k FMAs and ~8 more per step and sample) are negligible, so what
// counts is that every memory instruction moves whole, neighbouring 16-byte
// pieces.
//
// Design (the tile is set out in recon_tile.cuh): a block takes 32
// consecutive pedestrians and all S samples. It brings the tile's
// coefficients into shared memory by cp.async, 16 bytes a lane on
// neighbouring addresses; then each warp takes samples w, w + kWarps, ...:
// lane p reconstructs pedestrian p's 2T positions into the warp's stage in
// shared memory, and the warp stores the stage as the 32 * 96 contiguous
// bytes it is in (S, N, T, 2). The block synchronises once, after the load. The TPU
// kernel's 128-lane padding of N and its per-sample MXU products are not
// carried over; the ragged last tile is masked lane by lane.

#include <cuda_runtime.h>

#include "recon_tile.cuh"

namespace {

using et::kTile;
constexpr int kWarps = 5;              // each takes samples w, w + kWarps, ...
constexpr int kThreads = 32 * kWarps;

template <int T, int K>
__global__ void __launch_bounds__(kThreads, 6)
reconstruct_kernel(const float* __restrict__ c_m, const float* __restrict__ c_s,
                   const float* __restrict__ u_m, const float* __restrict__ u_s,
                   const float* __restrict__ ori, const float* __restrict__ rot,
                   const float* __restrict__ sca,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ out, int n_peds, int n_samples) {
  constexpr int T2 = 2 * T;
  extern __shared__ float4 smem[];
  const et::Tile<T, K, kWarps> tile(reinterpret_cast<float*>(smem), n_samples);

  const size_t n0 = static_cast<size_t>(blockIdx.x) * kTile;
  const size_t left = n_peds - n0;
  const int np = left < kTile ? static_cast<int>(left) : kTile;
  const unsigned moving = et::moving_bits(mask, n0, np);
  tile.load(c_m, c_s, u_m, u_s, ori, rot, sca, moving, n0, np, n_peds, n_samples);
  et::copy_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = lane < np;
  const et::Ped ped = tile.ped(active ? lane : 0, moving);
  const float* u = tile.basis(ped);
  float* stage = tile.stage + warp * kTile * T2;

  for (int s = warp; s < n_samples; s += kWarps) {
    if (active) {
      float cc[K];
      tile.coefficients(lane, s, n_samples, cc);
#pragma unroll
      for (int t = 0; t < T; t += 2) {
        float4 w;
        et::recon_step<K>(u, t, cc, ped, w.x, w.y);
        et::recon_step<K>(u, t + 1, cc, ped, w.z, w.w);
        *reinterpret_cast<float4*>(stage + lane * T2 + 2 * t) = w;
      }
    }
    et::store_sample<T>(stage, out, s, n_peds, n0, np, lane);
  }
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers to
// contiguous tensors: c_m, c_s (k, n, s); u_m, u_s (2t, k); ori (n, 2);
// rot (n, 2, 2); sca (n,); mask (n,) one byte each; out (s, n, t, 2)
// 16-byte aligned. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int et_reconstruct(const float* c_m, const float* c_s,
                              const float* u_m, const float* u_s,
                              const float* ori, const float* rot,
                              const float* sca, const unsigned char* mask,
                              float* out, int k, int n, int s, int t,
                              void* stream) {
  if (k != 6 || t != 12 || n < 0 || s < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!et::aligned16(out)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0 || s == 0) return static_cast<int>(cudaSuccess);
  auto kernel = reconstruct_kernel<12, 6>;
  const size_t bytes = et::Tile<12, 6, kWarps>::floats(s) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(n) + kTile - 1) / kTile));
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      c_m, c_s, u_m, u_s, ori, rot, sca, mask, out, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
