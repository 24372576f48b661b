// GP-Graph's group relabel, for sm_90a: one block a scene.
//
// Replaces no Pallas kernel. It is the device loop of `find_group_indices`
// (eigentrajectory_tpu/models/gpgraph_common.py:30-58), which the JAX
// package runs as a lax.fori_loop over the N*N row-major pairs of one
// scene, under vmap over the scenes of a block.
//
// For each scene it walks the pairs (r, c) with c < r in row-major order;
// where merge[r, c] is set, every label equal to labels[r] becomes c (the
// reference's relabel: the raw column index, not a union-find root). Labels
// start at i for a valid slot and at i + N for a padded one, so padded
// slots stay singletons after every valid group. Then the labels present
// among 0 .. 2N-1 are ranked in ascending order: ranks[i] is the rank of
// slot i's label, n_groups the number of labels present (the padded
// singletons included).
//
// Bound: neither bytes nor operations. It reads the strictly lower triangle
// of merge once (N(N-1)/2 bytes a scene; the rest is zero by contract) and
// writes 4N + 4 bytes, but each merge depends on every merge
// before it: a scene is a serial chain of N(N-1)/2 steps (1,596 at N = 57,
// 8,128 at N = 128), and a merge that fires rewrites up to N labels. The
// design keeps that chain out of device memory and off the host: one block
// a scene, the labels in shared memory, the row of merge bits the chain is
// on staged in shared memory by all threads at once, so that every step of
// the chain is a read of shared memory that all threads make alike (the
// branch is uniform). A merge that fires costs two barriers and N / threads
// compares a thread. Threads stride over the slots, so any N fits whose
// 13N bytes of shared memory the block can hold.

#include <cuda_runtime.h>

namespace {

__global__ void group_relabel_kernel(const unsigned char* __restrict__ merge,
                                     const unsigned char* __restrict__ valid,
                                     int* __restrict__ ranks, int* __restrict__ n_groups,
                                     int n) {
  extern __shared__ int smem[];
  int* labels = smem;                                              // n
  int* rank_of = smem + n;                                         // 2n
  unsigned char* row = reinterpret_cast<unsigned char*>(smem + 3 * n);  // n
  const size_t b = blockIdx.x;
  const unsigned char* m = merge + b * n * n;
  const unsigned char* v = valid + b * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) labels[i] = v[i] ? i : i + n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) rank_of[i] = 0;
  for (int r = 1; r < n; ++r) {
    __syncthreads();                 // every thread is done with the last row
    for (int c = threadIdx.x; c < r; c += blockDim.x) row[c] = m[static_cast<size_t>(r) * n + c];
    __syncthreads();
    for (int c = 0; c < r; ++c) {
      if (!row[c]) continue;         // one value for all threads: a uniform branch
      const int lab_r = labels[r];
      __syncthreads();               // every thread has read labels[r]
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        if (labels[i] == lab_r) labels[i] = c;
      __syncthreads();
    }
  }
  __syncthreads();
  // Presence of each label, then its inclusive prefix sum in place.
  for (int i = threadIdx.x; i < n; i += blockDim.x) rank_of[labels[i]] = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int j = 0; j < 2 * n; ++j) {
      sum += rank_of[j];
      rank_of[j] = sum;
    }
    n_groups[b] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) ranks[b * n + i] = rank_of[labels[i]] - 1;
}

}  // namespace

// merge (B, N, N) and valid (B, N) bool (one byte each), ranks (B, N) and
// n_groups (B,) int32, all contiguous on the device. Launches on `stream`
// and returns cudaGetLastError() (0 on success); B = 0 launches nothing.
extern "C" int et_group_relabel(const unsigned char* merge, const unsigned char* valid,
                                int* ranks, int* n_groups, int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const size_t bytes = 3 * sizeof(int) * static_cast<size_t>(n) + n;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_relabel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (n + 31) / 32 * 32;
  threads = threads > 256 ? 256 : threads;
  group_relabel_kernel<<<b, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      merge, valid, ranks, n_groups, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
