// Fused ET reconstruction + min-of-S ADE/FDE + best-sample TCC, for sm_90a.
//
// Replaces the TPU kernel `fused_recon_metrics` of
// eigentrajectory_tpu/ops/pallas_recon.py (kernel body
// `_recon_metrics_kernel`, lines 126-216; pallas_call at line 268).
//
// Per pedestrian n and each of S samples it reconstructs the 2T positions
// U @ C of the branch the moving mask selects, divides by `sca` on the
// moving branch only (0 where sca == 0), rotates by rot^T, adds `ori`, and
// writes the sample to recon (S, N, T, 2). Over the samples it takes the
// minimum ADE (time mean) and FDE (last step), and scores the FIRST sample
// of minimal FDE (strict <) against GT by TCC: per coordinate the Pearson
// correlation over time, 0 where the denominator is 0, clipped to [-1, 1],
// averaged over x/y.
//
// Bound: memory. Per ped it reads the selected branch's coefficients
// (k*S*4 = 480 B at k=6, S=20), GT (96 B) and about 29 B of params, and
// writes 1,920 B of trajectories and 12 B of metrics: about 2.5 KB. The
// ~0.2 GFLOP at the eval shape are negligible.
//
// Design (the tile is set out in recon_tile.cuh, shared with
// reconstruct.cu): a block takes 32 consecutive pedestrians and all S
// samples, so the work is spread over N*S (pedestrian, sample) pairs. The
// tile's coefficients and GT come in coalesced, by cp.async; each warp takes
// samples w, w + kWarps, ...: lane p reconstructs pedestrian p's sample into the
// warp's stage, sums its distances to GT (held in registers) in time order,
// and the warp stores the stage as one contiguous run. Each sample's ADE and
// last-step distance go to shared memory; after one block-wide barrier the
// first warp walks the S values of its pedestrian in sample order (min of
// ADE; strict < on FDE, so the lowest sample index wins a tie), keeps only
// the best sample's index, and recomputes that sample's positions from the
// coefficients still in shared memory, with the same arithmetic, for TCC.

#include <cuda_runtime.h>

#include "recon_tile.cuh"

namespace {

using et::kTile;
constexpr int kWarps = 4;              // each takes samples w, w + kWarps, ...
constexpr int kThreads = 32 * kWarps;

// Shared memory after the tile's: GT [kTile][2T], then each sample's ADE and
// last-step distance, [S][kTile] each.
template <int T, int K>
__host__ __device__ int metrics_floats(int n_samples) {
  return et::Tile<T, K, kWarps>::floats(n_samples) + kTile * 2 * T + 2 * n_samples * kTile;
}

// The 7 blocks a multiprocessor of the launch bounds hold the kernel to 72
// registers without spills; shared memory admits 5 blocks at S = 20.
template <int T, int K>
__global__ void __launch_bounds__(kThreads, 7)
recon_metrics_kernel(const float* __restrict__ c_m, const float* __restrict__ c_s,
                     const float* __restrict__ u_m, const float* __restrict__ u_s,
                     const float* __restrict__ ori, const float* __restrict__ rot,
                     const float* __restrict__ sca,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ gt, float* __restrict__ recon,
                     float* __restrict__ ade_out, float* __restrict__ fde_out,
                     float* __restrict__ tcc_out, int n_peds, int n_samples) {
  constexpr int T2 = 2 * T;
  extern __shared__ float4 smem[];
  const et::Tile<T, K, kWarps> tile(reinterpret_cast<float*>(smem), n_samples);
  float* s_gt = tile.end();
  float* s_ade = s_gt + kTile * T2;
  float* s_fde = s_ade + n_samples * kTile;

  const size_t n0 = static_cast<size_t>(blockIdx.x) * kTile;
  const size_t left = n_peds - n0;
  const int np = left < kTile ? static_cast<int>(left) : kTile;
  const unsigned moving = et::moving_bits(mask, n0, np);
  tile.load(c_m, c_s, u_m, u_s, ori, rot, sca, moving, n0, np, n_peds, n_samples);
  tile.copy_run(s_gt, gt + n0 * T2, np * T2);     // the tile's GT is one contiguous run
  et::copy_async_wait();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = lane < np;
  const et::Ped ped = tile.ped(active ? lane : 0, moving);
  const float* u = tile.basis(ped);
  float* stage = tile.stage + warp * kTile * T2;

  float g[T2];
#pragma unroll
  for (int i = 0; i < T2 / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(s_gt + (active ? lane : 0) * T2)[i];
    g[4 * i] = v.x;
    g[4 * i + 1] = v.y;
    g[4 * i + 2] = v.z;
    g[4 * i + 3] = v.w;
  }

  for (int s = warp; s < n_samples; s += kWarps) {
    if (active) {
      float cc[K];
      tile.coefficients(lane, s, n_samples, cc);
      float dsum = 0.f, dlast = 0.f;
#pragma unroll
      for (int t = 0; t < T; t += 2) {
        float4 w;
        et::recon_step<K>(u, t, cc, ped, w.x, w.y);
        et::recon_step<K>(u, t + 1, cc, ped, w.z, w.w);
        *reinterpret_cast<float4*>(stage + lane * T2 + 2 * t) = w;
        float dx = w.x - g[2 * t], dy = w.y - g[2 * t + 1];
        dsum += sqrtf(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
        dx = w.z - g[2 * t + 2];
        dy = w.w - g[2 * t + 3];
        dlast = sqrtf(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));   // of step t + 1
        dsum += dlast;
      }
      s_ade[s * kTile + lane] = dsum / T;
      s_fde[s * kTile + lane] = dlast;
    }
    et::store_sample<T>(stage, recon, s, n_peds, n0, np, lane);
  }
  __syncthreads();
  if (warp != 0 || !active) return;

  // Lane p reduces pedestrian p over the samples, in sample order.
  float min_ade = 1e30f, min_fde = 1e30f;
  int best_s = -1;
  for (int s = 0; s < n_samples; ++s) {
    min_ade = fminf(min_ade, s_ade[s * kTile + lane]);
    const float d = s_fde[s * kTile + lane];
    const bool better = d < min_fde;       // strict: keeps the first minimum
    min_fde = better ? d : min_fde;
    best_s = better ? s : best_s;
  }

  // The best sample's positions again, from the coefficients in shared
  // memory; all zero where no sample was below the initial 1e30.
  float best[T2];
  if (best_s >= 0) {
    float cc[K];
    tile.coefficients(lane, best_s, n_samples, cc);
#pragma unroll
    for (int t = 0; t < T; ++t) et::recon_step<K>(u, t, cc, ped, best[2 * t], best[2 * t + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < T2; ++i) best[i] = 0.f;
  }

  float corr_sum = 0.f;
#pragma unroll
  for (int xy_i = 0; xy_i < 2; ++xy_i) {
    float ma = 0.f, mb = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ma += best[2 * t + xy_i];
      mb += g[2 * t + xy_i];
    }
    ma /= T;
    mb /= T;
    float cov = 0.f, va = 0.f, vb = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float a = best[2 * t + xy_i] - ma, b = g[2 * t + xy_i] - mb;
      cov = __fmaf_rn(a, b, cov);
      va = __fmaf_rn(a, a, va);
      vb = __fmaf_rn(b, b, vb);
    }
    const float den = sqrtf(__fmul_rn(va, vb));
    const float r = den > 0.f ? cov / den : 0.f;
    corr_sum += fminf(fmaxf(r, -1.f), 1.f);
  }

  ade_out[n0 + lane] = min_ade;
  fde_out[n0 + lane] = min_fde;
  tcc_out[n0 + lane] = 0.5f * corr_sum;
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers to
// contiguous tensors: c_m, c_s (k, n, s); u_m, u_s (2t, k); ori (n, 2);
// rot (n, 2, 2); sca (n,); mask (n,) one byte each; gt (n, t, 2);
// recon (s, n, t, 2) 16-byte aligned; ade, fde, tcc (n,). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int et_recon_metrics(const float* c_m, const float* c_s,
                                const float* u_m, const float* u_s,
                                const float* ori, const float* rot,
                                const float* sca, const unsigned char* mask,
                                const float* gt, float* recon, float* ade,
                                float* fde, float* tcc, int k, int n, int s,
                                int t, void* stream) {
  if (k != 6 || t != 12 || n < 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!et::aligned16(recon)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return static_cast<int>(cudaSuccess);
  auto kernel = recon_metrics_kernel<12, 6>;
  const size_t bytes = metrics_floats<12, 6>(s) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(n) + kTile - 1) / kTile));
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt, recon, ade, fde, tcc, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
