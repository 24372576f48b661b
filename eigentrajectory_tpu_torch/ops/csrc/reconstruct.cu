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
// S*T*2*4 = 1,920 B: the output is four times the input. At the serving
// request of 301 scenes in 128-slot blocks (N = 38,528) that is about 94 MB,
// more than the 50 MB L2, so the bound is that over the card's memory rate;
// the f32 operations (2*2*k FMAs and ~8 more per step and sample) are
// negligible.
//
// Design: one thread per (pedestrian, sample) pair, with n fastest in the
// thread index, so there is no loop over S and a warp writes one contiguous
// run of 32 * 96 B of the output; both bases (2*T*K floats each) are staged
// in shared memory; each thread reads only the K coefficients of its branch
// and writes its 2T floats as float4 stores. Threads past N*S return. The
// TPU kernel's 128-lane padding of N and its per-sample MXU products are not
// carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int T, int K>
__global__ void __launch_bounds__(kThreads)
reconstruct_kernel(const float* __restrict__ c_m, const float* __restrict__ c_s,
                   const float* __restrict__ u_m, const float* __restrict__ u_s,
                   const float* __restrict__ ori, const float* __restrict__ rot,
                   const float* __restrict__ sca,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ out, int n_peds, int n_samples) {
  constexpr int T2 = 2 * T;
  static_assert(T2 % 4 == 0, "float4 stores need 2T to be a multiple of 4");

  __shared__ float su[2][T2 * K];
  for (int i = threadIdx.x; i < T2 * K; i += blockDim.x) {
    su[0][i] = u_m[i];
    su[1][i] = u_s[i];
  }
  __syncthreads();

  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_peds) * n_samples) return;
  const int n = static_cast<int>(idx % n_peds);
  const int si = static_cast<int>(idx / n_peds);

  const bool moving = mask[n] != 0;
  const float* u = su[moving ? 0 : 1];
  const float* c = (moving ? c_m : c_s) + static_cast<size_t>(n) * n_samples + si;
  const size_t c_row = static_cast<size_t>(n_peds) * n_samples;  // stride of k
  float cc[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) cc[kk] = c[kk * c_row];

  const float r00 = rot[4 * n], r01 = rot[4 * n + 1];
  const float r10 = rot[4 * n + 2], r11 = rot[4 * n + 3];
  const float ox = ori[2 * n], oy = ori[2 * n + 1];
  const float sc = sca[n];
  const float scale = moving ? (sc != 0.f ? 1.f / sc : 0.f) : 1.f;

  float xy[T2];
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
    xy[2 * t] = x * r00 + y * r01 + ox;
    xy[2 * t + 1] = x * r10 + y * r11 + oy;
  }

  float4* dst = reinterpret_cast<float4*>(out + static_cast<size_t>(idx) * T2);
#pragma unroll
  for (int i = 0; i < T2 / 4; ++i)
    dst[i] = make_float4(xy[4 * i], xy[4 * i + 1], xy[4 * i + 2], xy[4 * i + 3]);
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
  if (k != 6 || t != 12) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * s;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  reconstruct_kernel<12, 6><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      c_m, c_s, u_m, u_s, ori, rot, sca, mask, out, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
