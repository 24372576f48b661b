// Fused ET reconstruction + min-of-S ADE/FDE + best-sample TCC, for sm_90a.
//
// Replaces the TPU kernel `fused_recon_metrics` of
// eigentrajectory_tpu/ops/pallas_recon.py (kernel body
// `_recon_metrics_kernel`, lines 126-216; pallas_call at line 268).
//
// Per pedestrian n and each of S samples it reconstructs the 2T positions
// U @ C of the branch the moving mask selects, divides by `sca` on the
// moving branch only (0 where sca == 0), rotates by rot^T, adds `ori`, and
// writes the sample to recon (S, N, T, 2). It keeps the running min-over-S
// ADE (time mean) and FDE (last step), and the positions of the FIRST sample
// of minimal FDE (strict <), whose TCC against GT it computes at the end:
// per coordinate the Pearson correlation over time, 0 where the
// denominator is 0, clipped to [-1, 1], averaged over x/y.
//
// Bound: memory. Per ped it reads c_m + c_s (2*k*S*4 = 960 B at k=6, S=20;
// only the selected branch is needed, 480 B), GT (96 B) and about 29 B of
// params, and writes 1,920 B of trajectories and 12 B of metrics: about
// 3.0 KB in all (2.5 KB reading one branch). At the main path's
// N = 320*57 = 18,240 that is about 55 MB (46 MB), so the bound is that over
// the card's memory rate; the ~0.2 GFLOP are negligible.
//
// Design: one thread per pedestrian; both bases (2*T*K floats each) staged
// in shared memory; the loop over S runs inside the thread with the running
// minima and the best sample's 2T positions in registers; each sample's 2T
// floats go straight to the output as float4 stores; TCC in the epilogue.
// The coefficients are read in the public (k, N, S) layout, so nothing is
// transposed around the call. The TPU kernel's selection matrices and its
// 128-lane padding of N are not carried over: threads with n >= N return.
// Making it fast (coalesced (S, N, T, 2) stores through shared memory,
// vectorised coefficient loads) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int T, int K>
__global__ void __launch_bounds__(kThreads)
recon_metrics_kernel(const float* __restrict__ c_m, const float* __restrict__ c_s,
                     const float* __restrict__ u_m, const float* __restrict__ u_s,
                     const float* __restrict__ ori, const float* __restrict__ rot,
                     const float* __restrict__ sca,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ gt, float* __restrict__ recon,
                     float* __restrict__ ade_out, float* __restrict__ fde_out,
                     float* __restrict__ tcc_out, int n_peds, int n_samples) {
  constexpr int T2 = 2 * T;
  static_assert(T2 % 4 == 0, "float4 stores need 2T to be a multiple of 4");

  __shared__ float su[2][T2 * K];
  for (int i = threadIdx.x; i < T2 * K; i += blockDim.x) {
    su[0][i] = u_m[i];
    su[1][i] = u_s[i];
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_peds) return;

  const bool moving = mask[n] != 0;
  const float* u = su[moving ? 0 : 1];
  const float* c = (moving ? c_m : c_s) + static_cast<size_t>(n) * n_samples;
  const size_t c_row = static_cast<size_t>(n_peds) * n_samples;  // stride of k
  const float r00 = rot[4 * n], r01 = rot[4 * n + 1];
  const float r10 = rot[4 * n + 2], r11 = rot[4 * n + 3];
  const float ox = ori[2 * n], oy = ori[2 * n + 1];
  const float sc = sca[n];
  const float scale = moving ? (sc != 0.f ? 1.f / sc : 0.f) : 1.f;

  float g[T2];
#pragma unroll
  for (int i = 0; i < T2; ++i) g[i] = gt[static_cast<size_t>(n) * T2 + i];

  float best[T2];
#pragma unroll
  for (int i = 0; i < T2; ++i) best[i] = 0.f;
  float min_ade = 1e30f, min_fde = 1e30f;

  for (int si = 0; si < n_samples; ++si) {
    float cc[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) cc[kk] = c[kk * c_row + si];

    float xy[T2];
    float dsum = 0.f, dlast = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        x = fmaf(u[(2 * t) * K + kk], cc[kk], x);
        y = fmaf(u[(2 * t + 1) * K + kk], cc[kk], y);
      }
      x *= scale;
      y *= scale;
      const float wx = x * r00 + y * r01 + ox;
      const float wy = x * r10 + y * r11 + oy;
      xy[2 * t] = wx;
      xy[2 * t + 1] = wy;
      const float dx = wx - g[2 * t], dy = wy - g[2 * t + 1];
      const float d = sqrtf(dx * dx + dy * dy);
      dsum += d;
      if (t == T - 1) dlast = d;
    }

    float4* dst = reinterpret_cast<float4*>(
        recon + (static_cast<size_t>(si) * n_peds + n) * T2);
#pragma unroll
    for (int i = 0; i < T2 / 4; ++i)
      dst[i] = make_float4(xy[4 * i], xy[4 * i + 1], xy[4 * i + 2], xy[4 * i + 3]);

    min_ade = fminf(min_ade, dsum / T);
    const bool better = dlast < min_fde;   // strict: keeps the first minimum
    min_fde = better ? dlast : min_fde;
#pragma unroll
    for (int i = 0; i < T2; ++i) best[i] = better ? xy[i] : best[i];
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
      cov = fmaf(a, b, cov);
      va = fmaf(a, a, va);
      vb = fmaf(b, b, vb);
    }
    const float den = sqrtf(va * vb);
    const float r = den > 0.f ? cov / den : 0.f;
    corr_sum += fminf(fmaxf(r, -1.f), 1.f);
  }

  ade_out[n] = min_ade;
  fde_out[n] = min_fde;
  tcc_out[n] = 0.5f * corr_sum;
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
  if (k != 6 || t != 12) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  recon_metrics_kernel<12, 6><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      c_m, c_s, u_m, u_s, ori, rot, sca, mask, gt, recon, ade, fde, tcc, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
