// GP-Graph's group relabel, for sm_90a: one warp a scene, several scenes a
// block.
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
// Bound: neither bytes nor operations, but a chain of dependent steps a
// scene. The kernel reads the merge bytes once (N(N-1)/2 of them matter a
// scene) and writes 4N + 4 bytes, but the pairs' loop is serial: each merge
// depends on every merge before it, N(N-1)/2 steps (1,596 at N = 57). Two
// facts shorten that chain to one step a row that holds a merge:
//   - slot r's label at the start of row r is still its first (r, or
//     r + N padded): an earlier row r' only ever writes columns c < r' < r,
//     and no other slot starts at r's value;
//   - so the merges of row r, (r, c1) ... (r, ck) in ascending order, chain
//     through labels[r]: the first relabels r's label to c1, the next every
//     label c1 to c2, and so on. Together they turn every label in
//     {r's first label, c1, ..., ck} into ck, the row's last column.
// A row is then one data-parallel step: each lane tests the labels it holds
// (slots lane, lane + 32, ...) against the row's bits and replaces those in
// it by ck. Pairs that do not merge cost nothing (a few hundred of the
// 320 x 1,596 pairs merge at (320, 57)), nor do rows without a merge. What
// bounds the kernel now: on the main path's shapes the launch and the
// staging's loads (a scene holds a merge in a few rows); on a dense scene
// the chain, one step a row at about ten instructions a label a lane, each
// step waiting on shared loads whose addresses are the last step's labels,
// issued by the scene's one warp.
//
// The design: a warp a scene, several scenes a block. Off the chain, the
// whole block first stages its scenes' merge rows as bitmasks in shared
// memory: 16-byte loads of the scenes' bytes, coalesced; the set bytes of
// a load that fall in one row go in with an atomicOr into the row's words,
// one for the row's bit and an atomicMax of the row's last column. Staging
// a byte a lane with a __ballot_sync a 32 columns moves 32 bytes a load
// where this moves 512 a warp, and took 1.8-4.6x this kernel's time on the
// main path's shapes (PERF.md, the relabel's A/B). The chain then visits
// only the rows holding a merge (__ffs over the row bits). The labels sit
// in registers, L a lane (a template parameter: N <= 64, 128, 256),
// updated by compile-time unrolled selects; above 256
// slots in the warp's shared memory, each lane still touching only its own
// slots. The ranks come from a 2N-bit presence map: a warp scan of the
// popcounts of its words, then a label's rank is the count below its word
// plus __popc of its word under it. The only __syncthreads are around the
// staging of a batch of rows, never on the chain; above ~1,300 slots the
// rows are staged in batches that fit the block's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSmemBytes = 227 * 1024;    // what one block may hold
constexpr int kMaxWarps = 8;

// One scene's shared memory, in 32-bit words: the staged rows, a bit a row
// holding a merge, each row's last column merged (+ 1, 0 for none), the
// presence map and its prefix counts, and the labels where they do not fit
// in registers.
struct Layout {
  int w;         // words of a row of bits, ceil(N / 32)
  int p;         // words of the presence map, ceil(2N / 32)
  int row_any, row_last, present, below, labels;   // offsets
  int words;     // total
};

__host__ __device__ inline Layout layout(int n, int rows, bool shared_labels) {
  Layout l;
  l.w = (n + 31) / 32;
  l.p = (2 * n + 31) / 32;
  l.row_any = rows * l.w;
  l.row_last = l.row_any + (rows + 31) / 32;
  l.present = l.row_last + rows;
  l.below = l.present + l.p;
  l.labels = l.below + l.p;
  l.words = l.labels + (shared_labels ? n : 0);
  return l;
}

// The set bytes among the 16 at offset q0 from the block's first scene
// (bit t of `set` for byte q0 + t) into the staged rows of the batch that
// starts at row r0. A run of bytes in one row is one segment: an atomicOr
// into each row word it touches (at most two), one for the row's bit and
// an atomicMax of its last column, whatever the count of its set bytes.
__device__ __forceinline__ void note_merges(unsigned* smem, const Layout& lay, unsigned q0,
                                            unsigned set, unsigned nn, int n, int r0) {
  while (set) {
    const int t = __ffs(set) - 1;
    const unsigned q = q0 + t;
    const unsigned s = q / nn, rem = q - s * nn;
    const int r = static_cast<int>(rem / n), c = static_cast<int>(rem) - r * n;
    const int len = min(16 - t, n - c);           // bytes t .. t + len - 1: row r
    const unsigned seg = (set >> t) & ((1u << len) - 1u);
    set &= ~(((1u << len) - 1u) << t);
    const int keep = min(len, r - c);             // the strictly lower triangle only
    if (keep <= 0) continue;
    const unsigned bits = seg & ((1u << keep) - 1u);
    if (!bits) continue;
    unsigned* const mine = smem + s * lay.words;
    const int rl = r - r0, sh = c & 31;
    unsigned* const row = mine + rl * lay.w + (c >> 5);
    atomicOr(row, bits << sh);
    if (sh + keep > 32) atomicOr(row + 1, bits >> (32 - sh));
    atomicOr(mine + lay.row_any + (rl >> 5), 1u << (rl & 31));
    atomicMax(mine + lay.row_last + rl, static_cast<unsigned>(c + 32 - __clz(bits)));
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxWarps * 32)
group_relabel_kernel(const unsigned char* __restrict__ merge,
                     const unsigned char* __restrict__ valid, int* __restrict__ ranks,
                     int* __restrict__ n_groups, int b, int n, int scenes, int rows) {
  extern __shared__ unsigned smem[];
  const Layout lay = layout(n, rows, L == 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * scenes;
  const int here = min(scenes, b - b0);
  const bool chain = warp < here;        // this warp walks scene b0 + warp
  const int sb = b0 + warp;
  unsigned* const mine = smem + warp * lay.words;
  unsigned* const present = mine + lay.present;
  unsigned* const below = mine + lay.below;
  int* const shared_labels = reinterpret_cast<int*>(mine + lay.labels);
  // Slot lane + 32 j's label; N - 1 past N, a column no row sets, so that
  // these never merge (and they are never ranked).
  int lab[L > 0 ? L : 1];

  if (chain) {
    const unsigned char* v = valid + static_cast<size_t>(sb) * n;
    if constexpr (L > 0) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = j * 32 + lane;
        lab[j] = i < n ? (v[i] ? i : i + n) : n - 1;
      }
    } else {
      for (int i = lane; i < n; i += 32) shared_labels[i] = v[i] ? i : i + n;
    }
    for (int k = lane; k < lay.p; k += 32) present[k] = 0;
  }

  const unsigned nn = static_cast<unsigned>(n) * static_cast<unsigned>(n);
  const unsigned char* const first_scene = merge + static_cast<size_t>(b0) * nn;
  for (int r0 = 0; r0 < n; r0 += rows) {
    const int r1 = min(n, r0 + rows);
    // --- stage rows r0 .. r1-1 of the block's scenes as bits (off the chain) ---
    if (r0 > 0) __syncthreads();         // the chains are done with the last batch
    for (int s = 0; s < here; ++s)       // the rows, their bits and last columns
      for (int k = threadIdx.x; k < lay.present; k += blockDim.x) smem[s * lay.words + k] = 0;
    __syncthreads();
    // Several scenes a block only when a batch is the whole scene: the
    // block's bytes are one range either way.
    const uintptr_t lo = reinterpret_cast<uintptr_t>(first_scene) + static_cast<size_t>(r0) * n;
    const uintptr_t hi = reinterpret_cast<uintptr_t>(first_scene) +
                         static_cast<size_t>(here - 1) * nn + static_cast<size_t>(r1) * n;
    const uintptr_t start = lo & ~static_cast<uintptr_t>(15);
    const unsigned chunks = static_cast<unsigned>((hi - start + 15) / 16);
    const uintptr_t base = reinterpret_cast<uintptr_t>(first_scene);
    constexpr int kUnroll = 4;           // loads in flight a thread
    for (unsigned k0 = threadIdx.x; k0 < chunks; k0 += kUnroll * blockDim.x) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uintptr_t a = start + 16 * static_cast<uintptr_t>(k0 + u * blockDim.x);
        q[u] = k0 + u * blockDim.x < chunks && a >= lo && a + 16 <= hi
                   ? __ldg(reinterpret_cast<const uint4*>(a)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned k = k0 + u * blockDim.x;
        if (k >= chunks) break;
        const uintptr_t a = start + 16 * static_cast<uintptr_t>(k);
        if (a >= lo && a + 16 <= hi) {
          if ((q[u].x | q[u].y | q[u].z | q[u].w) == 0) continue;
          const unsigned word[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
          unsigned set = 0;
#pragma unroll
          for (int t = 0; t < 16; ++t)
            set |= ((word[t >> 2] >> (8 * (t & 3))) & 0xffu) ? 1u << t : 0u;
          note_merges(smem, lay, static_cast<unsigned>(a - base), set, nn, n, r0);
        } else {                         // the range's ragged ends, a byte at a time
          const uintptr_t from = a > lo ? a : lo, e = a + 16 < hi ? a + 16 : hi;
          unsigned set = 0;
          for (uintptr_t p = from; p < e; ++p)
            if (*reinterpret_cast<const unsigned char*>(p)) set |= 1u << (p - from);
          note_merges(smem, lay, static_cast<unsigned>(from - base), set, nn, n, r0);
        }
      }
    }
    __syncthreads();
    if (!chain) continue;

    // --- the chain: one step a row holding a merge ---
    for (int wa = 0; wa < (r1 - r0 + 31) / 32; ++wa) {
      unsigned any = mine[lay.row_any + wa];
      while (any) {
        const int rl = wa * 32 + __ffs(any) - 1;
        any &= any - 1;
        const int r = r0 + rl;
        const unsigned* const row = mine + rl * lay.w;
        const int last = static_cast<int>(mine[lay.row_last + rl]) - 1;
        // Merged: slot r (the only holder of r's first label) and every
        // label among the row's columns. A row sets no column >= r, so a
        // label clamped to N - 1 (a padded slot's i + N) tests 0: no other
        // compare, and no branch between a lane's L loads of row words.
        auto merged = [&](int i, int x) {
          const int xc = min(x, n - 1);
          return (i == r) | static_cast<bool>((row[xc >> 5] >> (xc & 31)) & 1u);
        };
        if constexpr (L > 0) {
#pragma unroll
          for (int j = 0; j < L; ++j) lab[j] = merged(j * 32 + lane, lab[j]) ? last : lab[j];
        } else {
          for (int i = lane; i < n; i += 32)
            if (merged(i, shared_labels[i])) shared_labels[i] = last;
        }
      }
    }
  }
  if (!chain) return;

  // --- ranks: presence bits, a warp scan of their popcounts ---
  if constexpr (L > 0) {
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (j * 32 + lane < n) atomicOr(present + (lab[j] >> 5), 1u << (lab[j] & 31));
  } else {
    for (int i = lane; i < n; i += 32) {
      const int x = shared_labels[i];
      atomicOr(present + (x >> 5), 1u << (x & 31));
    }
  }
  __syncwarp();
  int carry = 0;
  for (int k0 = 0; k0 < lay.p; k0 += 32) {
    const int k = k0 + lane;
    const int count = k < lay.p ? __popc(present[k]) : 0;
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(~0u, incl, d);
      if (lane >= d) incl += t;
    }
    if (k < lay.p) below[k] = carry + incl - count;
    carry += __shfl_sync(~0u, incl, 31);
  }
  __syncwarp();
  int* out = ranks + static_cast<size_t>(sb) * n;
  auto rank_of = [&](int x) {
    return static_cast<int>(below[x >> 5]) + __popc(present[x >> 5] & ((1u << (x & 31)) - 1u));
  };
  if constexpr (L > 0) {
#pragma unroll
    for (int j = 0; j < L; ++j)
      if (j * 32 + lane < n) out[j * 32 + lane] = rank_of(lab[j]);
  } else {
    for (int i = lane; i < n; i += 32) out[i] = rank_of(shared_labels[i]);
  }
  if (lane == 0) n_groups[sb] = carry;
}

template <int L>
int launch(const unsigned char* merge, const unsigned char* valid, int* ranks, int* n_groups,
           int b, int n, int scenes, int rows, cudaStream_t stream) {
  const size_t bytes = sizeof(unsigned) * static_cast<size_t>(scenes) *
                       layout(n, rows, L == 0).words;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_relabel_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Enough warps to stage the block's bytes (8 KB a warp), at least one a scene.
  const long long staged = static_cast<long long>(scenes) * rows * n;
  const int warps = std::max(scenes, static_cast<int>(std::min<long long>(
                                         kMaxWarps, (staged + 8191) / 8192)));
  group_relabel_kernel<L><<<(b + scenes - 1) / scenes, 32 * warps, bytes, stream>>>(
      merge, valid, ranks, n_groups, b, n, scenes, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// merge (B, N, N) and valid (B, N) bool (one byte each), ranks (B, N) and
// n_groups (B,) int32, all contiguous on the device. Launches on `stream`
// and returns cudaGetLastError() (0 on success); B = 0 launches nothing.
extern "C" int et_group_relabel(const unsigned char* merge, const unsigned char* valid,
                                int* ranks, int* n_groups, int b, int n, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Labels in registers up to 256 slots; two scenes a block where the card
  // still gets a block an SM (132 SMs), up to four.
  const int scenes = std::max(1, std::min(4, b / 132));
  if (n <= 64) return launch<2>(merge, valid, ranks, n_groups, b, n, scenes, n, s);
  if (n <= 128) return launch<4>(merge, valid, ranks, n_groups, b, n, scenes, n, s);
  if (n <= 256) return launch<8>(merge, valid, ranks, n_groups, b, n, scenes, n, s);
  // Labels in shared memory, a scene a block, as many rows a batch as fit
  // (a row: its words and its last column; its bit bounded by all rows').
  const Layout none = layout(n, 0, true);
  const int words = kSmemBytes / 4 - none.words - (n + 31) / 32;
  const int rows = std::min(n, words / (none.w + 1));
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<0>(merge, valid, ranks, n_groups, b, n, 1, rows, s);
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
