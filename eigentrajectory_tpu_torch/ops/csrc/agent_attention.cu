// ET-AgentFormer's agent-aware attention, for sm_90a: one block a (row,
// head, 64-query tile), a register-tiled FFMA flash attention over 64-key
// tiles.
//
// Replaces no Pallas kernel: the JAX package computes this function in XLA
// (eigentrajectory_tpu/models/agentformer.py, AgentAwareAttention). It
// computes what the port's `ops/attention.py::agent_attention_plain` does
// between the projections and `out_proj`. Query token i is slot i % n at
// step i // n, key token j slot j % P at step j // P. The logit is the
// same-agent product q_self . k_self where the slots match and the
// inter-agent product q . k elsewhere, plus the bias
// agent_mask[b, i % n, j % P] + key_bias[b, j % P], or -inf at the keys of
// later steps under `causal`; then the softmax over the keys and the
// product with v. The plain version builds the (B, L, S) bias and two full
// (B, H, L, S) logit tensors, blends them, runs the softmax and the product
// in half a dozen passes over device memory: at the serve cell's encoder a
// row's scores are 2 MB, a request's several hundred MB a pass.
//
// Bound: f32 operations. The model runs in float32 with TF32 off, so the
// tensor cores are out and every product is an FFMA. The work that matters
// is the q . k and weights . v products (4 * L * S * 32 operations a row
// and head) and the same-agent products, which are needed only at the
// S / P keys of a query's own slot (1/P of a full product). The design
// keeps the scores on chip: each block holds its 64 x 32 query tile in
// shared memory and streams 64-key tiles of k and v through a two-stage
// cp.async pipeline; each of its 128 threads holds a 4 x 8 tile of scores
// and a 4 x 4 tile of the output in registers, the rows' running maximum
// and sum as partials over the 8 lanes that share the rows (warp shuffles).
// A prologue computes the query tile's same-agent logits (one a key step)
// into shared memory, and the bias is read from the (B, n, P) and (B, P)
// inputs, never from a (B, L, S) tensor. The weights of a tile go through
// shared memory to the product with v, each warp's through its own rows, so
// that a tile takes one block barrier. Shared-memory strides of 36 and 72
// words keep every access free of bank conflicts (rows are read 16 bytes
// at a time). Under `causal` the key tiles that every query of the tile
// is cut off from are skipped; no padded slot is skipped, as the plain
// version computes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;                 // query rows a block
constexpr int kBK = 64;                 // keys a tile
constexpr int kHD = 32;                 // head size
constexpr int kQStride = kHD + 4;       // words a row of q, k, v in shared memory
constexpr int kPStride = kBK + 8;       // words a row of weights
constexpr int kTileWords = kBQ * kQStride;
constexpr int kFixedWords = kTileWords            // q
                            + 2 * kTileWords      // k, two stages
                            + 2 * kTileWords      // v, two stages
                            + kBQ * kPStride      // weights (the q_self tile first)
                            + 2 * 3 * kBK;        // each key's slot, step, bias; two stages
constexpr int kMaxWords = 227 * 1024 / 4;

__host__ __device__ inline int words_for(int key_steps) {
  return kFixedWords + kBQ * key_steps;            // and the same-agent logits
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = full ? 16 : 0;                 // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + 63 (those below `rows`; zeros past them) of head
// columns `col` of a (B, rows, E) view into a [64][kQStride] tile.
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long sr,
                                          int row0, int rows, int tid) {
#pragma unroll
  for (int t = 0; t < kBQ * (kHD / 4) / kThreads; ++t) {
    const int u = tid + t * kThreads;
    const int r = u >> 3, c = (u & 7) * 4;
    const bool in = row0 + r < rows;
    const float* src = in ? base + (row0 + r) * sr + c : base;
    cp_async16(tile + r * kQStride + c, src, in);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
agent_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ qs,
                       const float* __restrict__ ks, const float* __restrict__ agent_mask,
                       const float* __restrict__ key_bias, float* __restrict__ out,
                       long long qb, long long qr, long long kb, long long kr, long long vb,
                       long long vr, long long qsb, long long qsr, long long ksb,
                       long long ksr, int L, int S, int E, int n, int P, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* const q_t = smem;
  float* const k_t = q_t + kTileWords;             // [2][64][kQStride]
  float* const v_t = k_t + 2 * kTileWords;
  float* const w_t = v_t + 2 * kTileWords;         // [64][kPStride]
  int* const kslot_t = reinterpret_cast<int*>(w_t + kBQ * kPStride);   // [2][64]
  int* const kstep_t = kslot_t + 2 * kBK;
  float* const kbias_t = reinterpret_cast<float*>(kstep_t + 2 * kBK);
  float* const own_t = kbias_t + 2 * kBK;          // [64][tk]

  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = lane & 7;                         // keys cg + 8 j; output columns 4 cg ..
  const int rg = (tid >> 5) * 4 + (lane >> 3);     // rows rg + 16 i
  const int i0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tk = S / P;
  const int hc = h * kHD;

  const float* const qh = q + b * qb + hc;
  const float* const kh = k + b * kb + hc;
  const float* const vh = v + b * vb + hc;
  const float* const qsh = qs + b * qsb + hc;
  const float* const ksh = ks + b * ksb + hc;
  const float* const kbias_row = key_bias + static_cast<long long>(b) * P;

  // The keys this tile of queries reaches: under `causal`, those of the
  // steps up to its last query's.
  int keys = S;
  if (causal) {
    const int last_step = (min(i0 + kBQ, L) - 1) / n;
    keys = min(S, (last_step + 1) * P);
  }
  const int n_tiles = (keys + kBK - 1) / kBK;

  auto load_meta = [&](int stage, int j0) {
    if (tid < kBK) {
      const int j = j0 + tid;
      int slot = -1, step = 0;
      float kbv = 0.f;
      if (j < S) {
        step = j / P;
        slot = j - step * P;
        kbv = kbias_row[slot];
      }
      kslot_t[stage * kBK + tid] = slot;
      kstep_t[stage * kBK + tid] = step;
      kbias_t[stage * kBK + tid] = kbv;
    }
  };

  // --- prologue: q, the q_self tile (into the weights' place), the first
  // k and v tiles; then the same-agent logits ---
  load_tile(q_t, qh, qr, i0, L, tid);
  load_tile(w_t, qsh, qsr, i0, L, tid);
  load_tile(k_t, kh, kr, 0, S, tid);
  load_tile(v_t, vh, vr, 0, S, tid);
  cp_async_commit();
  load_meta(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  {
    // Row r's key steps t = tid / 64, + 2, ...: its q_self row in registers,
    // the k_self rows of its slot read straight from device memory.
    const int r = tid & (kBQ - 1);
    const int slot = (i0 + r) % n;
    float4 qrow[kHD / 4];
#pragma unroll
    for (int c = 0; c < kHD / 4; ++c)
      qrow[c] = *reinterpret_cast<const float4*>(w_t + r * kQStride + 4 * c);
#pragma unroll 4
    for (int t = tid / kBQ; t < tk; t += kThreads / kBQ) {
      float dot = 0.f;
      if (slot < P) {
        const float4* const krow =
            reinterpret_cast<const float4*>(ksh + static_cast<long long>(t * P + slot) * ksr);
#pragma unroll
        for (int c = 0; c < kHD / 4; ++c) {
          const float4 x = __ldg(krow + c);
          dot = fmaf(qrow[c].x, x.x, dot);
          dot = fmaf(qrow[c].y, x.y, dot);
          dot = fmaf(qrow[c].z, x.z, dot);
          dot = fmaf(qrow[c].w, x.w, dot);
        }
      }
      own_t[r * tk + t] = dot;
    }
  }

  // --- each thread's rows ---
  int qslot[4], qstep[4];
  const float* am_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + rg + 16 * i;
    qstep[i] = row / n;
    qslot[i] = row - qstep[i] * n;
    am_row[i] = agent_mask + (static_cast<long long>(b) * n + qslot[i]) * P;
  }
  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  // One block barrier a tile: past it, tile jt is in and every thread is done
  // with tile jt - 1, whose stage then takes tile jt + 1. A warp's weights
  // are its own rows' (the 8 lanes of a row share its warp): the weights
  // need only the warp's barriers.
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int stage = jt & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (jt + 1 < n_tiles) {                        // the next tile into the other stage
      const int nxt = stage ^ 1;
      load_tile(k_t + nxt * kTileWords, kh, kr, (jt + 1) * kBK, S, tid);
      load_tile(v_t + nxt * kTileWords, vh, vr, (jt + 1) * kBK, S, tid);
      cp_async_commit();
      load_meta(nxt, (jt + 1) * kBK);
    }
    const float* const kt = k_t + stage * kTileWords;
    const float* const vt = v_t + stage * kTileWords;

    // --- inter-agent logits: q . k over the tile ---
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < kHD; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_t + (rg + 16 * i) * kQStride + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + (cg + 8 * j) * kQStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // --- the logits and the online softmax ---
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cg + 8 * j;
      const int kslot = kslot_t[stage * kBK + c], kstep = kstep_t[stage * kBK + c];
      const float kbv = kbias_t[stage * kBK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = kslot >= 0 && !(causal && kstep > qstep[i]);
        float x = -INFINITY;
        if (live) {
          const float logit =
              kslot == qslot[i] ? own_t[(rg + 16 * i) * tk + kstep] : s[i][j];
          x = logit + (__ldg(am_row[i] + kslot) + kbv);
        }
        s[i][j] = x;
      }
    }
    __syncwarp();                                  // the warp is done with the last weights
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float ref = m_new == -INFINITY ? 0.f : m_new;   // a row cut off so far
      const float alpha = expf(m_run[i] - ref);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - ref);
        sum += p;
        w_t[(rg + 16 * i) * kPStride + cg + 8 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                                  // the rows' weights are in

    // --- weights . v ---
#pragma unroll 4
    for (int c4 = 0; c4 < kBK; c4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(w_t + (rg + 16 * i) * kPStride + c4);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 vv = *reinterpret_cast<const float4*>(vt + (c4 + cc) * kQStride + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
  }

  // --- out: the weighted sum over the rows' sums, (B, L, E) ---
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = i0 + rg + 16 * i;
    if (row < L) {
      const float4 o = make_float4(acc[i][0] / l, acc[i][1] / l, acc[i][2] / l, acc[i][3] / l);
      *reinterpret_cast<float4*>(out + (static_cast<long long>(b) * L + row) * E + hc + 4 * cg) =
          o;
    }
  }
}

}  // namespace

// q, q_self (B, L, E) and k, v, k_self (B, S, E) f32 views with unit column
// stride, their batch and row strides in elements (multiples of 4) and
// 16-byte aligned bases; agent_mask (B, n, P), key_bias (B, P) and out
// (B, L, E) contiguous; E = heads * 32, L a multiple of n, S of P. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int et_agent_attention(const float* q, const float* k, const float* v,
                                  const float* q_self, const float* k_self,
                                  const float* agent_mask, const float* key_bias, float* out,
                                  long long qb, long long qr, long long kb, long long kr,
                                  long long vb, long long vr, long long qsb, long long qsr,
                                  long long ksb, long long ksr, int B, int L, int S, int heads,
                                  int n, int P, int causal, void* stream) {
  if (B < 0 || L < 0 || S < 1 || heads < 1 || n < 1 || P < 1 || L % n || S % P ||
      B > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int words = words_for(S / P);
  if (words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(words) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      agent_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBQ - 1) / kBQ, heads, B);
  agent_attention_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, q_self, k_self, agent_mask, key_bias, out, qb, qr, kb, kr, vb, vr, qsb, qsr,
      ksb, ksr, L, S, heads * kHD, n, P, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* et_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
