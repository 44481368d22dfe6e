// Fused pointer decode step of the Attention Model, for Hopper (sm_90a).
//
// For instance b and query l, with H heads of width hd = D / H:
//   s[h][n]   = q_h . K[n]_h / sqrt(hd) + bias[n]        (bias: 0 or -1e9)
//   p[h][:]   = softmax_n(s[h][:])
//   g[d]      = sum_n p[h(d)][n] * V[n][d]               (heads merged)
//   proj[j]   = sum_d g[d] * W[d][j]
//   logits[n] = proj . LK[n] / sqrt(D)
//
// Two kernels, one launch per decode step each:
//   pointer_step_single   q [B, D],    bias [B, N]    -> out [B, N]
//   pointer_step_grouped  q [B, L, D], bias [B, L, N] -> out [B, L, N]
// K, V, LK are [B, N, D], W is [D, D]; everything is contiguous f32 and all
// arithmetic is f32 on the CUDA cores. Both walk the nodes in tiles with an
// online softmax (a running max and sum per row), so no buffer grows with N
// and any N runs. Scores, weights, glimpse and projection live in shared
// memory and registers only: device memory sees the inputs once per block
// and the logits once.
//
// Plain C interface (no PyTorch headers): raw device pointers, sizes, the
// stream. Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSingleThreads = 128;   // threads per group of the single kernel
constexpr int kSingleGroups = 4;      // groups per block, each walking its own instances
constexpr int kSingleTileN = 32;      // nodes per ring tile of the single kernel
constexpr int kMaxStages = 8;         // most ring slots per group
constexpr int kMinStagesBesideW = 2;  // W goes to shared memory only beside this many per group
constexpr int kBarrierFloats = 4;     // W's mbarrier, 8 bytes, padded to 16
constexpr int kTileL = 16;     // queries per block in the grouped kernel
constexpr int kGroupedThreads = 256;  // threads per block, grouped kernel
constexpr int kSubL = 8;       // queries per thread in its scores, glimpse, projection
constexpr int kScoreNodes = 4;  // nodes per thread in its scores phase
constexpr int kGroupL = 4;     // queries per thread in its logits phase
constexpr int kLogitNodes = 2;  // nodes per thread in its logits phase
constexpr int kGroupedTileN = 64;  // nodes per tile of the grouped kernel

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Pieces shared by both kernels.
// ---------------------------------------------------------------------------
template <int C>
struct Chunk {
  float v[C];
};

template <int C>
__device__ __forceinline__ Chunk<C> load_chunk(const float* p);

template <>
__device__ __forceinline__ Chunk<1> load_chunk<1>(const float* p) {
  Chunk<1> c;
  c.v[0] = *p;
  return c;
}

template <>
__device__ __forceinline__ Chunk<4> load_chunk<4>(const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  Chunk<4> c;
  c.v[0] = t.x;
  c.v[1] = t.y;
  c.v[2] = t.z;
  c.v[3] = t.w;
  return c;
}

template <int C>
__device__ __forceinline__ void store_chunk(float* p, const Chunk<C>& c);

template <>
__device__ __forceinline__ void store_chunk<1>(float* p, const Chunk<1>& c) {
  *p = c.v[0];
}

template <>
__device__ __forceinline__ void store_chunk<4>(float* p, const Chunk<4>& c) {
  *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2], c.v[3]);
}

__host__ __device__ __forceinline__ int padded_nodes(int N) { return (N + 3) & ~3; }

// One step of the online softmax for one row of a node tile, by one warp:
// the tile's scores (n of them, in shared memory) become exp(s - m_new) in
// place, and the row's running max *m and sum *l move to the tile; *a gets
// exp(m_old - m_new), the factor by which the accumulators of the earlier
// tiles shrink. On the first tile there is nothing to rescale and m_old is
// -inf: *a is 0 and no exp(-inf - (-inf)) is taken. m_new is finite (a
// masked score is -1e9, not -inf), so a row whose every node is masked gets
// the near-uniform weights a softmax gives on scores that all round to -1e9.
__device__ __forceinline__ void online_softmax_step(float* row, int n, int lane, bool first,
                                                    float* m, float* l, float* a) {
  float mt = -INFINITY;
  for (int i = lane; i < n; i += 32) mt = fmaxf(mt, row[i]);
  mt = warp_max(mt);
  const float m_old = first ? -INFINITY : *m;
  const float m_new = fmaxf(m_old, mt);
  const float alpha = first ? 0.f : expf(m_old - m_new);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(row[i] - m_new);
    row[i] = e;
    sum += e;
  }
  sum = warp_sum(sum);  // every lane has read *m and *l before lane 0 writes
  if (lane == 0) {
    *m = m_new;
    *l = (first ? 0.f : *l * alpha) + sum;
    *a = alpha;
  }
}

// Asynchronous copies global -> shared of C floats (16 or 4 bytes) per thread.
template <int C>
__device__ __forceinline__ void cp_async(float* dst, const float* src);

template <>
__device__ __forceinline__ void cp_async<4>(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <>
__device__ __forceinline__ void cp_async<1>(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits until at most `pending` (< kMaxStages) of this thread's groups are
// in flight; the instruction takes a constant.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<kMaxStages - 1>(); break;
  }
}

// mbarriers and the 1-D bulk copy (the Tensor Memory Accelerator without a
// tensor map): one thread asks for `bytes` contiguous bytes, the copy engine
// moves them and counts them off the barrier.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A copy
// that never lands traps (an error the launch reports) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Single query per instance: persistent blocks streaming node tiles.
//
// Replaces `_pallas_forward_single` / `_kernel_single` of
// rl4co_tpu/ops/pointer_kernel.py. It does 2 f32 operations per byte moved,
// so it is bound by device memory: the design keeps the memory system busy
// and reads every byte once.
//
// - Persistent blocks: min(B, k * SMs) blocks, k as many as shared memory
//   and registers let one SM hold (1 at D 128). A block is kSingleGroups
//   groups of kSingleThreads threads; each group walks
//   its own instances (group G of NG takes G, G + NG, ...) with its own ring
//   and named barrier, so some groups compute while others wait for their
//   tiles: one group alone is bound by the latency of its serial phases.
// - W_out is staged once per block in shared memory (one bulk copy) and read
//   from there by every instance the block takes, not once per instance
//   through L2. Where D*D floats do not fit beside kMinStagesBesideW ring
//   slots per group (D above 128 with four groups), the same kernel reads W
//   from global memory (kWShared false).
// - K, V and LK pass through each group's ring of `stages` slots of TN-node
//   tiles in the order K0 V0 K1 V1 ... LK0 LK1 ... per instance, instance
//   after instance: the copies of the next tiles, across instance
//   boundaries, are in flight while this one's are computed. A K tile's slot
//   also holds the tile's bias and, for the first tile, the instance's query.
// - The ring is filled by per-thread `cp.async` with one commit group per
//   tile (16 bytes where every head starts on a 16-byte boundary, else 4).
//   An instance's bias row starts on a 4-byte boundary only (N * 4 bytes per
//   instance), which the 1-D bulk copy refuses, and a bulk copy per 16-byte
//   padded row measured slower on the H100 (PERF.md); one mechanism serves
//   rows, bias, query and the narrow path, its wait cannot hang, and rows
//   land D + C floats apart against bank conflicts.
// - The glimpse is an online softmax over the K/V tiles: per head a running
//   max and sum, the partial glimpse rescaled by exp(m_old - m_new). No
//   buffer grows with N, so N is bounded by nothing but the grid.
// Shared memory (floats): barrier; W [D*D] if kWShared; per group: stages x
// slot [TN*(D+C) rows, TNP bias, D query]; query, glimpse, projection [D]
// each; partial sums [max(glimpse parts, projection parts) * D]; weights
// [H*TNP]; running max, running sum, rescale [H] each.
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ __forceinline__ int single_slot_floats(int tn, int D, int C) {
  return round4(tn * (D + C) + padded_nodes(tn) + D);
}

// threads of a group that share one output of the glimpse (over nodes) and
// of the projection (over rows of W)
__host__ __device__ __forceinline__ int single_glimpse_parts(int D) {
  return D < kSingleThreads ? kSingleThreads / D : 1;
}

__host__ __device__ __forceinline__ int single_proj_parts(int D, int C) {
  return D / C < kSingleThreads ? kSingleThreads / (D / C) : 1;
}

__host__ __device__ __forceinline__ int single_scratch_floats(int D, int C) {
  const int g = single_glimpse_parts(D), p = single_proj_parts(D, C);
  return round4((g > p ? g : p) * D);
}

// floats of shared memory of one group: its ring and its buffers
__host__ __device__ __forceinline__ int single_group_floats(int tn, int D, int H, int C,
                                                           int stages) {
  return stages * single_slot_floats(tn, D, C) + 3 * round4(D) + single_scratch_floats(D, C) +
         H * padded_nodes(tn) + 3 * round4(H);
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kSingleThreads) : "memory");
}

template <int C, bool kWShared>
__global__ void __launch_bounds__(kSingleGroups * kSingleThreads)
pointer_step_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ lk,
                           const float* __restrict__ bias, const float* __restrict__ w,
                           float* __restrict__ out, int B, int N, int D, int H, int TN,
                           int stages) {
  extern __shared__ __align__(16) float smem_single[];
  const int DP = D + C;
  const int TNP = padded_nodes(TN);
  const int slot_f = single_slot_floats(TN, D, C);
  const int grp = threadIdx.x / kSingleThreads;
  uint64_t* w_bar = reinterpret_cast<uint64_t*>(smem_single);  // W has landed
  float* w_s = smem_single + kBarrierFloats;                   // [D*D] if kWShared
  float* ring = w_s + (kWShared ? D * D : 0) +
                grp * single_group_floats(TN, D, H, C, stages);  // [stages * slot_f]
  float* q_s = ring + stages * slot_f;              // [D] the instance's query
  float* gl_s = q_s + round4(D);                    // [D] its glimpse
  float* p_s = gl_s + round4(D);                    // [D] its projection
  float* x_s = p_s + round4(D);                     // partial sums
  float* s_s = x_s + single_scratch_floats(D, C);   // [H*TNP] a tile's scores, then weights
  float* m_s = s_s + H * TNP;                       // [H] running max
  float* l_s = m_s + round4(H);                     // [H] running sum
  float* a_s = l_s + round4(H);                     // [H] this tile's rescale factor

  const int tid = threadIdx.x - grp * kSingleThreads;  // thread of the group
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bar = 1 + grp;  // the group's named barrier (0 is __syncthreads)
  constexpr int kWarps = kSingleThreads / 32;
  const int hd = D / H;
  const int ncol = D / C;
  const int T = (N + TN - 1) / TN;  // node tiles per instance
  const int per = 3 * T;            // ring tiles per instance
  // groups are numbered across blocks first, so that a small B still
  // spreads over every block
  const int first_b = grp * gridDim.x + blockIdx.x;
  const int groups = gridDim.x * kSingleGroups;
  const int total = first_b < B ? ((B - 1 - first_b) / groups + 1) * per : 0;

  // copies of tile g of this group's sequence into its slot; nothing past
  // the last tile
  auto issue = [&](int g) {
    if (g >= total) return;
    const int j = g / per;
    const int loc = g - j * per;
    const size_t b = first_b + (size_t)j * groups;
    const int kind = loc < 2 * T ? (loc & 1) : 2;  // K, V, LK
    const int t = loc < 2 * T ? (loc >> 1) : loc - 2 * T;
    const int n0 = t * TN;
    const int nt = min(TN, N - n0);
    const float* src = (kind == 0 ? k : kind == 1 ? v : lk) + (b * N + n0) * D;
    float* slot = ring + (g % stages) * slot_f;
    for (int c = tid; c < nt * ncol; c += kSingleThreads) {
      const int r = c / ncol;
      const int col = (c - r * ncol) * C;
      cp_async<C>(slot + r * DP + col, src + (size_t)r * D + col);
    }
    if (kind == 0) {
      for (int c = tid; c < nt; c += kSingleThreads)
        cp_async<1>(slot + TN * DP + c, bias + b * N + n0 + c);
      if (t == 0)
        for (int c = tid * C; c < D; c += kSingleThreads * C)
          cp_async<C>(slot + TN * DP + TNP + c, q + b * D + c);
    }
  };

  // W, once per block: one bulk copy where its rows are 16-byte aligned,
  // else every thread's share
  constexpr bool kWBulk = kWShared && C == 4;
  if (threadIdx.x == 0) {
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (kWBulk) {
      mbar_expect_tx(w_bar, (unsigned)(D * D * 4));
      bulk_copy(w_s, w, (unsigned)(D * D * 4), w_bar);
    }
  }
  if (kWShared && !kWBulk) {
    for (int i = threadIdx.x; i < D * D; i += blockDim.x) cp_async<1>(w_s + i, w + i);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  bool w_landed = !kWBulk;

  for (int g = 0; g < stages - 1; ++g) {
    issue(g);
    cp_async_commit();
  }

  const float scale = 1.f / sqrtf((float)hd);
  const float oscale = 1.f / sqrtf((float)D);
  const int gparts = single_glimpse_parts(D);
  const int pparts = single_proj_parts(D, C);
  const float* wsrc = kWShared ? w_s : w;

  for (int g = 0; g < total; ++g) {
    issue(g + stages - 1);  // into the slot freed at the end of step g - 1
    cp_async_commit();
    cp_async_wait_pending(stages - 1);  // this thread's copies of tile g have landed
    group_sync(bar);                    // ... and every thread's of the group
    const int j = g / per;
    const int loc = g - j * per;
    const size_t b = first_b + (size_t)j * groups;
    const float* slot = ring + (g % stages) * slot_f;
    if (loc < 2 * T) {
      const int t = loc >> 1;
      const int nt = min(TN, N - t * TN);
      const bool first = t == 0;
      if ((loc & 1) == 0) {
        // K tile: scores of every (head, node), then each head's online
        // softmax step. The query rides in the first tile's slot; later
        // tiles read the copy kept in q_s.
        const float* qsrc = first ? slot + TN * DP + TNP : q_s;
        if (first && T > 1)
          for (int d = tid; d < D; d += kSingleThreads) q_s[d] = qsrc[d];
        const float* bias_t = slot + TN * DP;
        // one warp per head: a lane per node scores it, then the warp takes
        // the head's online softmax step on the scores its own lanes wrote
        for (int h = warp; h < H; h += kWarps) {
          const float* qr = qsrc + h * hd;
          float* row = s_s + h * TNP;
          for (int n = lane; n < nt; n += 32) {
            const float* kr = slot + n * DP + h * hd;
            float acc0 = 0.f, acc1 = 0.f;
            int i = 0;
            for (; i + 2 * C <= hd; i += 2 * C) {
              const Chunk<C> k0 = load_chunk<C>(kr + i), k1 = load_chunk<C>(kr + i + C);
              const Chunk<C> q0 = load_chunk<C>(qr + i), q1 = load_chunk<C>(qr + i + C);
#pragma unroll
              for (int e = 0; e < C; ++e) {
                acc0 += q0.v[e] * k0.v[e];
                acc1 += q1.v[e] * k1.v[e];
              }
            }
            for (; i < hd; i += C) {
              const Chunk<C> k0 = load_chunk<C>(kr + i), q0 = load_chunk<C>(qr + i);
#pragma unroll
              for (int e = 0; e < C; ++e) acc0 += q0.v[e] * k0.v[e];
            }
            row[n] = (acc0 + acc1) * scale + bias_t[n];
          }
          online_softmax_step(row, nt, lane, first, m_s + h, l_s + h, a_s + h);
        }
      } else {
        // V tile: each of `gparts` threads per column d sums every
        // gparts-th node of the tile onto its partial glimpse, rescaled to
        // the new running max
        for (int i = tid; i < gparts * D; i += kSingleThreads) {
          const int part = i / D;
          const int d = i - part * D;
          const int h = d / hd;
          const float* prow = s_s + h * TNP;
          float acc0 = 0.f, acc1 = 0.f;
          int n = part;
#pragma unroll 4
          for (; n + gparts < nt; n += 2 * gparts) {
            acc0 += prow[n] * slot[n * DP + d];
            acc1 += prow[n + gparts] * slot[(n + gparts) * DP + d];
          }
          if (n < nt) acc0 += prow[n] * slot[n * DP + d];
          const float sum = (first ? 0.f : x_s[i] * a_s[h]) + (acc0 + acc1);
          // after the last tile a lone thread of its column has the glimpse
          if (t == T - 1 && gparts == 1)
            gl_s[d] = sum / l_s[h];
          else
            x_s[i] = sum;
        }
        if (t == T - 1) {
          if (gparts > 1) {
            group_sync(bar);
            // the glimpse: partial sums added, over the running sum
            for (int d = tid; d < D; d += kSingleThreads) {
              float s = 0.f;
              for (int part = 0; part < gparts; ++part) s += x_s[part * D + d];
              gl_s[d] = s / l_s[d / hd];
            }
          }
          if (!w_landed) {
            mbar_wait(w_bar, 0);
            w_landed = true;
          }
          group_sync(bar);
          // projection: one thread per (C columns of W, slice of its rows)
          const int dc = (D + pparts - 1) / pparts;
          for (int i = tid; i < ncol * pparts; i += kSingleThreads) {
            const int part = i / ncol;
            const int col = (i - part * ncol) * C;
            const int d1 = min(D, (part + 1) * dc);
            float acc[C];
#pragma unroll
            for (int e = 0; e < C; ++e) acc[e] = 0.f;
#pragma unroll 4
            for (int d = part * dc; d < d1; ++d) {
              const float gd = gl_s[d];
              const Chunk<C> wv = load_chunk<C>(wsrc + (size_t)d * D + col);
#pragma unroll
              for (int e = 0; e < C; ++e) acc[e] += gd * wv.v[e];
            }
#pragma unroll
            for (int e = 0; e < C; ++e) x_s[part * D + col + e] = acc[e];
          }
          group_sync(bar);
          for (int c = tid; c < D; c += kSingleThreads) {
            float s = 0.f;
            for (int part = 0; part < pparts; ++part) s += x_s[part * D + c];
            p_s[c] = s;
          }
        }
      }
    } else {
      // LK tile: logits, eight neighbouring lanes per node, each taking every
      // eighth chunk of the row; the loop bounds are the same for the whole
      // group, so every lane reaches the shuffles
      const int t = loc - 2 * T;
      const int nt = min(TN, N - t * TN);
      float* out_t = out + b * N + t * TN;
      for (int base = 0; base < nt * 8; base += kSingleThreads) {
        const int n = (base + tid) >> 3;
        const int part = tid & 7;
        float acc = 0.f;
        if (n < nt) {
          const float* lr = slot + n * DP;
#pragma unroll 4
          for (int d = part * C; d < D; d += 8 * C) {
            const Chunk<C> lv = load_chunk<C>(lr + d), pv = load_chunk<C>(p_s + d);
#pragma unroll
            for (int e = 0; e < C; ++e) acc += pv.v[e] * lv.v[e];
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (n < nt && part == 0) out_t[n] = acc * oscale;
      }
    }
    group_sync(bar);  // the slot of tile g is free
  }
}

// ---------------------------------------------------------------------------
// Grouped queries. Replaces `_pallas_forward` / `_kernel` of
// rl4co_tpu/ops/pointer_kernel.py; at L = 50 it is bound by operations.
// One block per (instance, tile of kTileL queries), three blocks per SM.
// The nodes are walked in tiles of kGroupedTileN: for each tile, its K rows
// are staged in shared memory and scored, each (query, head) row updates a
// running max and a running sum (online softmax), the glimpse accumulators
// are rescaled by exp(m_old - m_new), and the tile's V rows are staged and
// accumulated. After the last tile the glimpse is divided by the running sum
// and projected; LK is then walked in the same tiles and the logits written
// tile by tile. Nothing in shared memory grows with N past one tile, so any
// N runs; N <= kGroupedTileN (TSP-20/50) is a single tile.
//
// The inner loops are bound by loads from shared memory, not by arithmetic,
// so they walk the reduction axis in chunks of C floats: with C = 4 one
// 16-byte load feeds four multiply-adds. That needs every head to start on a
// 16-byte boundary (D / H a multiple of 4); any other head width runs the
// same code with C = 1. Rows of the staging buffer are D + C floats apart:
// with C = 4 the eight threads of a quarter warp that read the same columns
// of neighbouring rows hit eight different 16-byte bank groups, with C = 1
// threads that walk down a column hit different banks. Every thread keeps
// the accumulators of kSubL queries in registers inside a tile; between
// tiles the glimpse accumulators wait in shared memory, so D is not bounded
// by a register budget.
//
// Measured on an H100 (PERF.md), the arithmetic phases and not the staging
// bind this kernel: with nothing staged it kept 85 % of its time before the
// register tiles below, and keeps 71 % with them. So the
// scores and logits phases hold register tiles of queries x nodes: a thread
// scores kSubL queries against kScoreNodes nodes of one head (each chunk of
// K feeds kSubL queries, each chunk of q kScoreNodes nodes) and takes the
// logits of kGroupL queries at kLogitNodes nodes. A thread's nodes are a
// stride of ceil(nt / nodes) apart, so neighbouring threads read
// neighbouring rows; a node past the tile reads the tile's last row and is
// not stored. No sum changes its order. Sub-tiles of kSubL queries and
// logit groups wholly past the last query are skipped (at L = 50 the last
// block holds 2 queries: one sub-tile of 8 is computed, not two).
// Shared memory, TN = min(kGroupedTileN, N), TNP = TN rounded up to 4:
// stage [TN*(D+C)], q then projection [kTileL*D], glimpse [kTileL*D],
// weights [kTileL*H*TNP], running max, running sum, rescale [kTileL*H] each.
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ int grouped_tile_nodes(int N) {
  return N < kGroupedTileN ? N : kGroupedTileN;
}

template <int C>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int rows, int D, int tid) {
  const int DP = D + C;
  for (int i = tid * C; i < rows * D; i += kGroupedThreads * C) {
    const int n = i / D;
    store_chunk<C>(dst + n * DP + (i - n * D), load_chunk<C>(src + i));
  }
}

template <int C>
__global__ void __launch_bounds__(kGroupedThreads, 3)
pointer_step_grouped_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ lk,
                            const float* __restrict__ bias, const float* __restrict__ w,
                            float* __restrict__ out, int L, int N, int D, int H) {
  extern __shared__ __align__(16) float smem_grouped[];
  float* smem = smem_grouped;
  const int DP = D + C;
  const int TN = grouped_tile_nodes(N);
  const int TNP = padded_nodes(TN);
  float* buf = smem;                 // [TN*DP]   a tile of K, then of V; later of LK
  float* q_s = buf + TN * DP;        // [kTileL*D] queries, later the projection
  float* g_s = q_s + kTileL * D;     // [kTileL*D] glimpse accumulators, then the glimpse
  float* s_s = g_s + kTileL * D;     // [kTileL*H*TNP] the tile's scores, then weights
  float* m_s = s_s + kTileL * H * TNP;  // [kTileL*H] running max
  float* l_s = m_s + kTileL * H;        // [kTileL*H] running sum
  float* a_s = l_s + kTileL * H;        // [kTileL*H] this tile's rescale factor

  const int b = blockIdx.x;
  const int l0 = blockIdx.y * kTileL;
  const int nl = min(kTileL, L - l0);  // queries of this tile that exist
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kGroupedThreads >> 5;
  const int nsub = (nl + kSubL - 1) / kSubL;       // sub-tiles that hold a query
  const int ngroups = (nl + kGroupL - 1) / kGroupL;  // logit groups that hold one
  const int hd = D / H;
  const size_t row0 = (size_t)b * N;
  const size_t qrow0 = (size_t)b * L + l0;
  const float* bias_b = bias + qrow0 * N;
  float* out_b = out + qrow0 * N;

  // queries of the tile; rows past the ragged edge are zero
  for (int i = tid * C; i < kTileL * D; i += kGroupedThreads * C) {
    Chunk<C> c;
    if (i / D < nl) {
      c = load_chunk<C>(q + qrow0 * D + i);
    } else {
#pragma unroll
      for (int e = 0; e < C; ++e) c.v[e] = 0.f;
    }
    store_chunk<C>(q_s + i, c);
  }

  const float scale = 1.f / sqrtf((float)hd);
  for (int n0 = 0; n0 < N; n0 += TN) {
    const int nt = min(TN, N - n0);  // nodes of this tile; none past N is read
    const bool first = n0 == 0;
    const bool last = n0 + TN >= N;
    stage_rows<C>(buf, k + (row0 + n0) * D, nt, D, tid);
    __syncthreads();

    // scores: one thread per (sub-tile of kSubL queries, head, kScoreNodes
    // nodes ns apart), the kSubL x kScoreNodes sums in registers: each chunk
    // of K feeds kSubL queries and each chunk of q kScoreNodes nodes
    const int ns = (nt + kScoreNodes - 1) / kScoreNodes;
    for (int p = tid; p < nsub * H * ns; p += kGroupedThreads) {
      const int sub = p / (H * ns);
      const int hi = p - sub * H * ns;
      const int h = hi / ns;
      const int i = hi - h * ns;
      const int lb = sub * kSubL;
      const float* qr = q_s + lb * D + h * hd;
      const float* kr[kScoreNodes];
#pragma unroll
      for (int r = 0; r < kScoreNodes; ++r)  // a node past the tile reads the last row
        kr[r] = buf + min(i + r * ns, nt - 1) * DP + h * hd;
      float acc[kSubL][kScoreNodes];
#pragma unroll
      for (int l = 0; l < kSubL; ++l)
#pragma unroll
        for (int r = 0; r < kScoreNodes; ++r) acc[l][r] = 0.f;
      for (int j = 0; j < hd; j += C) {
        Chunk<C> kv[kScoreNodes];
#pragma unroll
        for (int r = 0; r < kScoreNodes; ++r) kv[r] = load_chunk<C>(kr[r] + j);
#pragma unroll
        for (int l = 0; l < kSubL; ++l) {
          const Chunk<C> qv = load_chunk<C>(qr + l * D + j);
#pragma unroll
          for (int r = 0; r < kScoreNodes; ++r)
#pragma unroll
            for (int e = 0; e < C; ++e) acc[l][r] += qv.v[e] * kv[r].v[e];
        }
      }
#pragma unroll
      for (int r = 0; r < kScoreNodes; ++r) {
        const int n = i + r * ns;
        if (n >= nt) continue;
#pragma unroll
        for (int l = 0; l < kSubL; ++l) {
          // rows past the edge hold zeros: they take no part in any softmax
          s_s[((lb + l) * H + h) * TNP + n] =
              (lb + l < nl) ? acc[l][r] * scale + bias_b[(size_t)(lb + l) * N + n0 + n] : 0.f;
        }
      }
    }
    __syncthreads();  // the tile's K is no longer needed

    for (int r = warp; r < nl * H; r += nwarps)
      online_softmax_step(s_s + r * TNP, nt, lane, first, m_s + r, l_s + r, a_s + r);
    stage_rows<C>(buf, v + (row0 + n0) * D, nt, D, tid);
    __syncthreads();

    // glimpse: one thread per (sub-tile, d) walks the tile's nodes, starting
    // from the earlier tiles' sum rescaled to the new running max; after the
    // last tile the sum over the running sum is the glimpse
    for (int t = tid; t < nsub * D; t += kGroupedThreads) {
      const int lb = (t / D) * kSubL;
      const int d = t % D;
      const int h = d / hd;
      const float* wrow = s_s + (lb * H + h) * TNP;
      float acc[kSubL];
#pragma unroll
      for (int l = 0; l < kSubL; ++l)
        acc[l] = (first || lb + l >= nl) ? 0.f
                                         : g_s[(lb + l) * D + d] * a_s[(lb + l) * H + h];
      int n = 0;
      for (; n + C <= nt; n += C) {
        float vv[C];
#pragma unroll
        for (int e = 0; e < C; ++e) vv[e] = buf[(n + e) * DP + d];
#pragma unroll
        for (int l = 0; l < kSubL; ++l) {
          const Chunk<C> pv = load_chunk<C>(wrow + l * H * TNP + n);
#pragma unroll
          for (int e = 0; e < C; ++e) acc[l] += pv.v[e] * vv[e];
        }
      }
      for (; n < nt; ++n) {  // the nodes past the last whole chunk
        const float vv = buf[n * DP + d];
#pragma unroll
        for (int l = 0; l < kSubL; ++l) acc[l] += wrow[l * H * TNP + n] * vv;
      }
#pragma unroll
      for (int l = 0; l < kSubL; ++l)
        g_s[(lb + l) * D + d] =
            !last ? acc[l] : (lb + l < nl ? acc[l] / l_s[(lb + l) * H + h] : 0.f);
    }
    __syncthreads();  // the tile's V and weights are no longer needed
  }

  stage_rows<C>(buf, lk + row0 * D, TN, D, tid);  // the first tile of LK

  // projection: one thread per (sub-tile, j) reads W[d][j] along j; the
  // queries are read no more, so the projection overwrites them
  for (int t = tid; t < nsub * D; t += kGroupedThreads) {
    const int lb = (t / D) * kSubL;
    const int j = t % D;
    float acc[kSubL];
#pragma unroll
    for (int l = 0; l < kSubL; ++l) acc[l] = 0.f;
    for (int d = 0; d < D; d += C) {
      float wv[C];
#pragma unroll
      for (int e = 0; e < C; ++e) wv[e] = w[(size_t)(d + e) * D + j];
#pragma unroll
      for (int l = 0; l < kSubL; ++l) {
        const Chunk<C> gv = load_chunk<C>(g_s + (lb + l) * D + d);
#pragma unroll
        for (int e = 0; e < C; ++e) acc[l] += gv.v[e] * wv[e];
      }
    }
#pragma unroll
    for (int l = 0; l < kSubL; ++l) q_s[(lb + l) * D + j] = acc[l];
  }
  __syncthreads();

  // logits, tile by tile of LK: one thread per (group of kGroupL queries,
  // kLogitNodes nodes ns apart), the kGroupL x kLogitNodes sums in registers
  const float oscale = 1.f / sqrtf((float)D);
  for (int n0 = 0; n0 < N; n0 += TN) {
    const int nt = min(TN, N - n0);
    if (n0 > 0) {
      __syncthreads();  // every thread is done with the previous tile
      stage_rows<C>(buf, lk + (row0 + n0) * D, nt, D, tid);
      __syncthreads();
    }
    const int ns = (nt + kLogitNodes - 1) / kLogitNodes;
    for (int p = tid; p < ngroups * ns; p += kGroupedThreads) {
      const int g = p / ns;
      const int i = p - g * ns;
      const float* prow = q_s + g * kGroupL * D;
      const float* lr[kLogitNodes];
#pragma unroll
      for (int r = 0; r < kLogitNodes; ++r)  // a node past the tile reads the last row
        lr[r] = buf + min(i + r * ns, nt - 1) * DP;
      float acc[kGroupL][kLogitNodes];
#pragma unroll
      for (int a = 0; a < kGroupL; ++a)
#pragma unroll
        for (int r = 0; r < kLogitNodes; ++r) acc[a][r] = 0.f;
      for (int d = 0; d < D; d += C) {
        Chunk<C> lv[kLogitNodes];
#pragma unroll
        for (int r = 0; r < kLogitNodes; ++r) lv[r] = load_chunk<C>(lr[r] + d);
#pragma unroll
        for (int a = 0; a < kGroupL; ++a) {
          const Chunk<C> pv = load_chunk<C>(prow + a * D + d);
#pragma unroll
          for (int r = 0; r < kLogitNodes; ++r)
#pragma unroll
            for (int e = 0; e < C; ++e) acc[a][r] += pv.v[e] * lv[r].v[e];
        }
      }
#pragma unroll
      for (int r = 0; r < kLogitNodes; ++r) {
        const int n = i + r * ns;
        if (n >= nt) continue;
#pragma unroll
        for (int a = 0; a < kGroupL; ++a) {
          const int l = g * kGroupL + a;
          if (l < nl) out_b[(size_t)l * N + n0 + n] = acc[a][r] * oscale;
        }
      }
    }
  }
}

// The chunk the kernels walk their reduction axes in: 4 floats where every
// head starts on a 16-byte boundary, else 1.
inline int chunk_width(int D, int H) { return ((D / H) & 3) == 0 ? 4 : 1; }

// Raises the kernel's dynamic shared memory limit once it asks for more than
// the 48 KB every kernel may have. Remembers the largest size granted.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// Largest dynamic shared memory a block may ask for, and the SM count, of
// the current device (queried once per device); -1 when there is none.
struct DeviceInfo {
  int max_smem = -1;
  int sms = 0;
};

DeviceInfo device_info() {
  constexpr int kDevices = 64;
  static DeviceInfo info[kDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return DeviceInfo{};
  if (info[dev].max_smem < 0) {
    DeviceInfo d;
    if (cudaDeviceGetAttribute(&d.max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return DeviceInfo{};
    info[dev] = d;
  }
  return info[dev];
}

// The single kernel's tile, ring and W placement for a shape: tiles of
// min(kSingleTileN, N) nodes; W in shared memory where it fits beside
// kMinStagesBesideW slots per group; as many slots per group (up to
// kMaxStages) as the rest holds. Only a D of several thousand shrinks the
// tile; where not even two one-node slots fit, `smem` exceeds the device's
// limit and the wrapper raises.
struct SingleConfig {
  int tn, stages, smem;
  bool w_shared;
};

SingleConfig single_config(int N, int D, int H, int max_bytes) {
  const int C = chunk_width(D, H);
  const int budget = max_bytes / (int)sizeof(float) - kBarrierFloats;
  SingleConfig cfg{N < kSingleTileN ? N : kSingleTileN, 2, 0, false};
  for (;;) {
    const auto need = [&](int stages, bool w) {
      return (w ? D * D : 0) + kSingleGroups * single_group_floats(cfg.tn, D, H, C, stages);
    };
    cfg.w_shared = need(kMinStagesBesideW, true) <= budget;
    cfg.stages = kMaxStages;
    while (cfg.stages > 2 && need(cfg.stages, cfg.w_shared) > budget) --cfg.stages;
    if (need(cfg.stages, cfg.w_shared) <= budget || cfg.tn == 1) {
      cfg.smem = (int)sizeof(float) * (kBarrierFloats + need(cfg.stages, cfg.w_shared));
      return cfg;
    }
    cfg.tn = (cfg.tn + 1) / 2;
  }
}

template <int C, bool kWShared>
cudaError_t launch_single(const float* q, const float* k, const float* v, const float* lk,
                          const float* bias, const float* w, float* out, int B, int N,
                          int D, int H, const SingleConfig& cfg, int sms,
                          cudaStream_t stream) {
  constexpr int kBlock = kSingleGroups * kSingleThreads;
  static int granted = 0, occupancy_smem = -1, per_sm = 1;
  const auto kernel = pointer_step_single_kernel<C, kWShared>;
  cudaError_t err = allow_smem(kernel, cfg.smem, &granted);
  if (err != cudaSuccess) return err;
  if (cfg.smem != occupancy_smem) {  // blocks one SM holds at this shared memory
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, cfg.smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    occupancy_smem = cfg.smem;
  }
  const int grid = B < sms * per_sm ? B : sms * per_sm;
  kernel<<<dim3(grid), dim3(kBlock), cfg.smem, stream>>>(q, k, v, lk, bias, w, out, B, N, D,
                                                          H, cfg.tn, cfg.stages);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_grouped(const float* q, const float* k, const float* v, const float* lk,
                           const float* bias, const float* w, float* out, int B, int L,
                           int N, int D, int H, int smem, cudaStream_t stream) {
  static int granted = 0;
  cudaError_t err = allow_smem(pointer_step_grouped_kernel<C>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (L + kTileL - 1) / kTileL);
  pointer_step_grouped_kernel<C><<<grid, dim3(kGroupedThreads), smem, stream>>>(
      q, k, v, lk, bias, w, out, L, N, D, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pointer_step_single_smem_bytes(int N, int D, int H) {
  return single_config(N, D, H, device_info().max_smem).smem;
}

int pointer_step_grouped_smem_bytes(int N, int D, int H) {
  const int tn = grouped_tile_nodes(N);
  return (int)sizeof(float) * (tn * (D + chunk_width(D, H)) + 2 * kTileL * D +
                              kTileL * H * padded_nodes(tn) + 3 * kTileL * H);
}

// Largest dynamic shared memory a block may ask for on the current device.
int pointer_kernel_max_smem_bytes() { return device_info().max_smem; }

const char* pointer_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// L is ignored (one query per instance); kept so both entry points share a
// signature.
int pointer_step_single(const void* q, const void* k, const void* v, const void* lk,
                        const void* bias, const void* w, void* out, int B, int L, int N,
                        int D, int H, void* stream) {
  (void)L;
  const DeviceInfo dev = device_info();
  if (dev.max_smem < 0) return (int)cudaErrorNoDevice;
  const SingleConfig cfg = single_config(N, D, H, dev.max_smem);
  const auto launch =
      chunk_width(D, H) == 4 ? (cfg.w_shared ? launch_single<4, true> : launch_single<4, false>)
                             : (cfg.w_shared ? launch_single<1, true> : launch_single<1, false>);
  return (int)launch((const float*)q, (const float*)k, (const float*)v, (const float*)lk,
                     (const float*)bias, (const float*)w, (float*)out, B, N, D, H, cfg,
                     dev.sms, (cudaStream_t)stream);
}

int pointer_step_grouped(const void* q, const void* k, const void* v, const void* lk,
                         const void* bias, const void* w, void* out, int B, int L, int N,
                         int D, int H, void* stream) {
  const int smem = pointer_step_grouped_smem_bytes(N, D, H);
  const auto launch = chunk_width(D, H) == 4 ? launch_grouped<4> : launch_grouped<1>;
  return (int)launch((const float*)q, (const float*)k, (const float*)v, (const float*)lk,
                     (const float*)bias, (const float*)w, (float*)out, B, L, N, D, H, smem,
                     (cudaStream_t)stream);
}

}  // extern "C"
