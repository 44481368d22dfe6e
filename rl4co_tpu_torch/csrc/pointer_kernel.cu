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
// K, V, LK are [B, N, D], W is [D, D]; everything is contiguous f32. The
// single kernel's arithmetic is f32 on the CUDA cores; the grouped kernel
// takes its products on the tensor cores, in three TF32 passes that keep
// f32's precision, wherever the head width allows (else on the CUDA cores).
// Both walk the nodes in tiles with an online softmax (a running max and sum
// per row), so no buffer grows with N and any N runs. Scores, weights,
// glimpse and projection live in shared memory and registers only: device
// memory sees the inputs once per block and the logits once.
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

// Tensor-core products in f32 precision: `mma.sync` m16n8k8 on TF32 operands
// with the 3xTF32 split. An f32 value x is hi + lo, hi = tf32(x) and
// lo = tf32(x - hi), both rounded as `cvt.rna.tf32.f32` rounds a finite
// value: to nearest with ties away from zero, which is the bits plus 0x1000
// with the low 13 bits dropped. The split does that in integer arithmetic
// (`cvt.rna` costs a test for inf and NaN besides, and no operand here is
// either); lo keeps its low 13 bits, which the tensor cores do not read. A
// product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
// the two small terms first, into f32 accumulators. One TF32 pass keeps 11
// bits of each operand and misses the kernels' tolerance 16-60 times over
// (tests/test_torch_pointer_tf32_split.py); three passes stay within a few
// percent of it. Fragments of m16n8k8 (g = lane / 4,
// t = lane % 4): A (16 x 8, row-major) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8)
// c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
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
// Grouped queries on the CUDA cores: the kernel K1 runs for head widths the
// tensor-core kernel below does not take (D / H not 8, 16 or 32, or D above
// kMmaMaxD; e.g. D 20 with 2 heads). At L = 50 it is bound by operations.
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
// register tiles below, and kept 71 % with them (NVIDIA H100 80GB HBM3,
// 700 W). So the
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

// ---------------------------------------------------------------------------
// Grouped queries on the tensor cores. Replaces `_pallas_forward` / `_kernel`
// of rl4co_tpu/ops/pointer_kernel.py wherever the head width HD is 8, 16 or
// 32 and D <= kMmaMaxD (every grouped shape the port's models launch).
//
// What binds it. At L = 50 the step does about 50 f32 operations per byte
// moved. The kernel before this one did them on the CUDA cores and was
// bound by them (7x its f32 bound on an NVIDIA H100 80GB HBM3 at 700 W);
// this one takes its four products on the tensor cores, `mma.sync` m16n8k8
// with the 3xTF32 split above, and what binds it now is the rest: the
// splits, the softmax, the fragments' loads from shared memory and the
// staging, which no phase overlaps (PERF.md).
//
// One block per (instance, tile of R = 16 MT queries). Each 16 queries are
// the 16 rows of an m16 tile (an m-tile), so every product is a row of m16
// tiles:
//   scores   q_h [16, HD] . K_h,tile^T   per (head, m-tile), n8 tiles of nodes
//   glimpse  P_h [16, TN] . V_h,tile     per (head, m-tile), k8 steps of nodes
//   proj     g [16, D]    . W [D, D]     per m-tile, n8 tiles of W's columns
//   logits   proj [16, D] . LK_tile^T    per m-tile, n8 tiles of nodes
// - A warp owns whole (head, m-tile) pairs, so the online softmax runs on
//   the score accumulators in registers, with a shuffle over the four lanes
//   of a row, and the weights feed the glimpse product without passing
//   through shared memory: the accumulator holds row g's nodes 2t and 2t + 1
//   where the A operand wants its columns t and t + 4, so the k8 step takes
//   its nodes in the order 0 2 4 6 1 3 5 7 and reads V's rows in that order
//   (the sum over nodes does not depend on it). Only one __syncthreads per
//   node tile stands between the warps in that phase.
// - In the projection and the logits warp w takes m-tile w % MT and every
//   (NW / MT)-th n8 tile from w / MT, so it reads one m-tile's A fragments.
// - MT is chosen per launch (grouped_mma_tiles): L = 50 fills four m-tiles,
//   and a block of four stages K, V and LK and reads W once per instance
//   instead of four times; it runs 16 warps (one block per SM by registers)
//   and holds W in shared memory, copied while the first node tile is
//   computed. MT = 1 and 2 run 8 warps, two blocks per SM, and read W from
//   L2. Past one node tile MT is 1, and smaller MT keeps the SMs full at
//   small B.
// - A operands live in shared memory already split (hi and lo planes), rows
//   DP = D + 4 floats apart, so that a fragment's 32 loads hit 32 banks: the
//   queries, then in each (head, m-tile)'s place its glimpse, then the
//   projection. B operands are split as they are read: K, V and LK from
//   their tiles (rows DP apart: node g, column t is bank 4g + t, and V's
//   rows 2t and 2t + 1 at column g are banks 8t + g and 8t + 4 + g), W from
//   its copy (rows D + 8 apart: bank 8t + g) or from global memory.
// - Tiles of K and V land together in two buffers by `cp.async`, with the
//   tile's bias (-inf past the tile's nodes, so no mask is tested); the
//   first while the queries are split. LK's tiles alternate between the
//   buffers, the next in flight while one is used, the first during the
//   projection. Between node tiles (N > TN) each row's running max and sum
//   per head and its glimpse accumulators wait in shared memory.
// Shared memory (floats), TN = min(kGroupedTileN, N), TB = TN rounded up to
// 8: K [TN*DP], V [TN*DP], A planes [R*DP] x 2, bias [R*TB]; W [D*(D+8)] if
// MT = 4; past one node tile the glimpse accumulators [R*DP] and the running
// max and sum [R*H] each.
// ---------------------------------------------------------------------------
constexpr int kMmaMaxD = 256;                       // the projection: D / 8 n8 tiles
constexpr int kMaxNodeTiles8 = kGroupedTileN / 8;  // n8 tiles in a node tile
constexpr int kMmaMaxRegs = 128;    // registers per thread: 2 blocks of 256 threads per SM

__host__ __device__ constexpr int mma_threads(int MT) { return MT >= 4 ? 512 : 256; }
__host__ __device__ constexpr int mma_min_blocks(int MT) {
  return 65536 / (kMmaMaxRegs * mma_threads(MT));
}

__host__ __device__ __forceinline__ int grouped_mma_smem_floats(int N, int D, int H, int MT) {
  const int tn = grouped_tile_nodes(N), dp = D + 4, rows = kTileL * MT;
  return 2 * tn * dp + 2 * rows * dp + rows * ((tn + 7) & ~7) + (MT == 4 ? D * (D + 8) : 0) +
         (N > tn ? rows * dp + 2 * rows * H : 0);
}

template <int NT>
__device__ __forceinline__ void stage_rows_async(float* dst, const float* __restrict__ src,
                                                 int rows, int D, int tid) {
  const int DP = D + 4;
  for (int i = tid * 4; i < rows * D; i += NT * 4) {
    const int n = i / D;
    cp_async<4>(dst + n * DP + (i - n * D), src + i);
  }
}

// A fragment of columns k0..k0+7 of 16 rows kept split, rows P floats apart
__device__ __forceinline__ void load_a_split(const float* hi, const float* lo, int P, int k0,
                                             int g, int t, uint32_t (&a_hi)[4],
                                             uint32_t (&a_lo)[4]) {
  const int o0 = g * P + k0 + t, o1 = o0 + 8 * P;
  a_hi[0] = __float_as_uint(hi[o0]);
  a_hi[1] = __float_as_uint(hi[o1]);
  a_hi[2] = __float_as_uint(hi[o0 + 4]);
  a_hi[3] = __float_as_uint(hi[o1 + 4]);
  a_lo[0] = __float_as_uint(lo[o0]);
  a_lo[1] = __float_as_uint(lo[o1]);
  a_lo[2] = __float_as_uint(lo[o0 + 4]);
  a_lo[3] = __float_as_uint(lo[o1 + 4]);
}

// x split into the hi and lo planes at offset i
__device__ __forceinline__ void store_split(float* hi, float* lo, int i, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&b_hi)[2],
                                        uint32_t (&b_lo)[2]) {
  split_tf32(b0, b_hi[0], b_lo[0]);
  split_tf32(b1, b_hi[1], b_lo[1]);
}

template <int HD, int MT>
__global__ void __launch_bounds__(mma_threads(MT), mma_min_blocks(MT))
pointer_step_grouped_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ lk,
                                const float* __restrict__ bias, const float* __restrict__ w,
                                float* __restrict__ out, int L, int N, int D, int H) {
  constexpr int NT = mma_threads(MT);
  constexpr int NW = NT / 32;
  constexpr int R = kTileL * MT;  // query rows of the block
  constexpr int KS = HD / 8;      // k8 steps of a head's scores, n8 tiles of its glimpse
  constexpr bool WS = MT == 4;    // W in shared memory
  extern __shared__ __align__(16) float smem_mma[];
  const int DP = D + 4;
  const int TN = grouped_tile_nodes(N);
  const int TB = (TN + 7) & ~7;    // the bias tile's rows: whole n8 tiles
  float* kbuf = smem_mma;          // [TN*DP] a tile of K, later of LK
  float* vbuf = kbuf + TN * DP;    // [TN*DP] a tile of V, later of LK
  float* a_hi = vbuf + TN * DP;    // [R*DP] queries, glimpse, projection: hi
  float* a_lo = a_hi + R * DP;     // [R*DP] ... and lo
  float* b_s = a_lo + R * DP;      // [R*TB] the tile's bias, -inf past its nodes
  float* w_s = b_s + R * TB;       // [D*(D+8)] W, rows D + 8 apart (MT = 4)
  float* o_s = w_s + (WS ? D * (D + 8) : 0);  // [R*DP] glimpse accumulators between tiles
  float* m_s = o_s + R * DP;       // [R*H] running max between tiles
  float* l_s = m_s + R * H;        // [R*H] running sum between tiles

  const int b = blockIdx.x;
  const int l0 = blockIdx.y * R;
  const int nl = min(R, L - l0);  // queries of this block that exist
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * N;
  const size_t qrow0 = (size_t)b * L + l0;
  const float* bias_b = bias + qrow0 * N;
  float* out_b = out + qrow0 * N;

  // a node tile of K and V, and its bias: rows past the last query 0, nodes
  // past the tile -inf, so that they take no part in any softmax
  const auto stage_tile = [&](int n0, int nt) {
    stage_rows_async<NT>(kbuf, k + (row0 + n0) * D, nt, D, tid);
    stage_rows_async<NT>(vbuf, v + (row0 + n0) * D, nt, D, tid);
    const int nb = (nt + 7) & ~7;
    for (int i = tid; i < R * nb; i += NT) {
      const int r = i / nb, c = i - r * nb;
      if (r < nl && c < nt)
        cp_async<1>(b_s + r * TB + c, bias_b + (size_t)r * N + n0 + c);
      else
        b_s[r * TB + c] = c < nt ? 0.f : -INFINITY;
    }
    cp_async_commit();
  };
  stage_tile(0, min(TN, N));
  if (WS) {  // W, once, in flight while the first node tile is computed
    for (int i = tid * 4; i < D * D; i += NT * 4) {
      const int r = i / D;
      cp_async<4>(w_s + r * (D + 8) + (i - r * D), w + i);
    }
    cp_async_commit();
  }

  // queries of the block, split, while the first tile lands; rows past the
  // ragged edge are zero
  for (int i = tid * 4; i < R * D; i += NT * 4) {
    const int r = i / D, c = i - r * D;
    const Chunk<4> x = r < nl ? load_chunk<4>(q + qrow0 * D + i) : Chunk<4>{{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int e = 0; e < 4; ++e) store_split(a_hi, a_lo, r * DP + c + e, x.v[e]);
  }

  const float scale = 1.f / sqrtf((float)HD);
  for (int n0 = 0; n0 < N; n0 += TN) {
    const int nt = min(TN, N - n0);  // nodes of this tile; none past N is read
    const int nt8 = (nt + 7) >> 3;
    const bool first = n0 == 0;
    const bool last = n0 + TN >= N;
    if (!first) {
      __syncthreads();  // every warp is done with the previous tile
      stage_tile(n0, nt);
    }
    if (WS && first)
      cp_async_wait<1>();  // the tile, not W
    else
      cp_async_wait<0>();
    __syncthreads();

    // (head, m-tile) pairs; the m-tiles of a head first, so a warp's pairs
    // share its head where NW is a multiple of H
    for (int item = warp; item < H * MT; item += NW) {
      const int h = item % H, mt = item / H;
      if (mt * kTileL >= nl) continue;  // an m-tile wholly past the last query
      const int c0 = h * HD;
      const int rb = mt * kTileL;  // the m-tile's first row
      uint32_t q_hi[KS][4], q_lo[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        load_a_split(a_hi + rb * DP, a_lo + rb * DP, DP, c0 + ks * 8, g, t, q_hi[ks], q_lo[ks]);

      // scores of the head, n8 tile j: rows g and g + 8, nodes 8j + 2t and
      // 8j + 2t + 1; a node past the tile reads the tile's last row
      float s[kMaxNodeTiles8][4];
#pragma unroll
      for (int j = 0; j < kMaxNodeTiles8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        if (j < nt8) {
          const float* kr = kbuf + min(j * 8 + g, nt - 1) * DP + c0 + t;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            uint32_t b_hi[2], b_lo[2];
            split_b(kr[ks * 8], kr[ks * 8 + 4], b_hi, b_lo);
            mma_3xtf32(s[j], q_hi[ks], q_lo[ks], b_hi, b_lo);
          }
        }
      }

      // online softmax on the accumulators: element e is row g + 8 (e / 2),
      // node 8j + 2t + e % 2; nodes past the tile have a bias of -inf
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kMaxNodeTiles8; ++j) {
        if (j >= nt8) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 bv =
              *reinterpret_cast<const float2*>(b_s + (rb + g + 8 * i) * TB + j * 8 + 2 * t);
          s[j][2 * i] = s[j][2 * i] * scale + bv.x;
          s[j][2 * i + 1] = s[j][2 * i + 1] * scale + bv.y;
          mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        }
      }
      float m_new[2], alpha[2], sum[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m_new is finite: a masked score is -1e9, not -inf; on the first
        // tile there is nothing to rescale and no exp(-inf - (-inf)) is taken
        const float m_old = first ? -INFINITY : m_s[(rb + g + 8 * i) * H + h];
        m_new[i] = fmaxf(m_old, mx[i]);
        alpha[i] = first ? 0.f : expf(m_old - m_new[i]);
        sum[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMaxNodeTiles8; ++j)
        if (j < nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - m_new[e >> 1]);
            sum[e >> 1] += s[j][e];
          }
      float l_new[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_new[i] = (first ? 0.f : l_s[(rb + g + 8 * i) * H + h] * alpha[i]) + sum[i];
      }

      // glimpse: o [16, HD] += P [16, nt] . V_h [nt, HD], the earlier tiles'
      // sum rescaled to the new running max
      float o[KS][4];
#pragma unroll
      for (int nj = 0; nj < KS; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nj][e] = first ? 0.f
                           : o_s[(rb + g + (e >> 1) * 8) * DP + c0 + nj * 8 + 2 * t + (e & 1)] *
                                 alpha[e >> 1];
#pragma unroll
      for (int j = 0; j < kMaxNodeTiles8; ++j) {
        if (j >= nt8) continue;
        uint32_t p_hi[4], p_lo[4];  // A columns t, t + 4: nodes 8j + 2t, 8j + 2t + 1
        split_tf32(s[j][0], p_hi[0], p_lo[0]);
        split_tf32(s[j][2], p_hi[1], p_lo[1]);
        split_tf32(s[j][1], p_hi[2], p_lo[2]);
        split_tf32(s[j][3], p_hi[3], p_lo[3]);
        const float* v0 = vbuf + min(j * 8 + 2 * t, nt - 1) * DP + c0 + g;
        const float* v1 = vbuf + min(j * 8 + 2 * t + 1, nt - 1) * DP + c0 + g;
#pragma unroll
        for (int nj = 0; nj < KS; ++nj) {
          uint32_t b_hi[2], b_lo[2];
          split_b(v0[nj * 8], v1[nj * 8], b_hi, b_lo);
          mma_3xtf32(o[nj], p_hi, p_lo, b_hi, b_lo);
        }
      }

      __syncwarp();  // every lane has read the running max and sum
      const float inv_l[2] = {1.f / l_new[0], 1.f / l_new[1]};
#pragma unroll
      for (int nj = 0; nj < KS; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = (rb + g + (e >> 1) * 8) * DP + c0 + nj * 8 + 2 * t + (e & 1);
          // after the last tile the sum over the running sum is the glimpse,
          // written split over the pair's queries, which no other warp reads
          if (last)
            store_split(a_hi, a_lo, idx, o[nj][e] * inv_l[e >> 1]);
          else
            o_s[idx] = o[nj][e];
        }
      if (!last && t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m_s[(rb + g + 8 * i) * H + h] = m_new[i];
          l_s[(rb + g + 8 * i) * H + h] = l_new[i];
        }
    }
  }
  __syncthreads();  // the glimpse is whole; both buffers are free

  stage_rows_async<NT>(kbuf, lk + row0 * D, TN, D, tid);  // the first tile of LK
  cp_async_commit();
  if (WS) {
    cp_async_wait<1>();  // W, not the tile of LK
    __syncthreads();
  }

  // projection: warp w takes m-tile w % MT and W's n8 tiles w / MT,
  // w / MT + NW / MT, ... (PT at most), so each warp reads one m-tile's A
  // fragments, each once for its n8 tiles; m-tiles wholly past the last
  // query are skipped. The sums wait in registers until every warp has read
  // the glimpse, then go split over it.
  constexpr int NS = NW / MT;  // warps that share an m-tile
  constexpr int PT = kMmaMaxD / 8 / NS;
  const int mts = (nl + kTileL - 1) / kTileL;
  const int pm = warp % MT, pj = warp / MT;
  float acc[PT][4];
#pragma unroll
  for (int u = 0; u < PT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  if (pm < mts) {
    const float* w0 = w + (size_t)t * D + pj * 8 + g;
    const float* ws0 = w_s + t * (D + 8) + pj * 8 + g;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a_split(a_hi + pm * kTileL * DP, a_lo + pm * kTileL * DP, DP, k0, g, t, ah, al);
#pragma unroll
      for (int u = 0; u < PT; ++u) {
        if ((pj + u * NS) * 8 >= D) continue;
        uint32_t b_hi[2], b_lo[2];
        if (WS)
          split_b(ws0[k0 * (D + 8) + u * NS * 8], ws0[(k0 + 4) * (D + 8) + u * NS * 8], b_hi,
                  b_lo);
        else
          split_b(__ldg(w0 + (size_t)k0 * D + u * NS * 8),
                  __ldg(w0 + (size_t)(k0 + 4) * D + u * NS * 8), b_hi, b_lo);
        mma_3xtf32(acc[u], ah, al, b_hi, b_lo);
      }
    }
  }
  __syncthreads();  // every warp has read the glimpse
#pragma unroll
  for (int u = 0; u < PT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pm < mts && (pj + u * NS) * 8 < D)
        store_split(a_hi, a_lo,
                    (pm * kTileL + g + (e >> 1) * 8) * DP + (pj + u * NS) * 8 + 2 * t + (e & 1),
                    acc[u][e]);

  // logits, tile by tile of LK
  const float oscale = 1.f / sqrtf((float)D);
  for (int ti = 0, n0 = 0; n0 < N; ++ti, n0 += TN) {
    const int nt = min(TN, N - n0);
    cp_async_wait<0>();
    __syncthreads();  // tile ti has landed, the projection is whole; every
                      // warp is done with tile ti - 1
    const float* cur = (ti & 1) ? vbuf : kbuf;
    if (n0 + TN < N) {  // the next tile, into the buffer tile ti - 1 used
      stage_rows_async<NT>((ti & 1) ? kbuf : vbuf, lk + (row0 + n0 + TN) * D,
                           min(TN, N - n0 - TN), D, tid);
      cp_async_commit();
    }
    // warp w takes m-tile w % MT and the tile's n8 tiles w / MT, w / MT +
    // NW / MT, ...
    for (int jt = pj; jt < (nt + 7) >> 3 && pm < mts; jt += NS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* lr = cur + min(jt * 8 + g, nt - 1) * DP + t;
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8) {
        uint32_t ah[4], al[4], b_hi[2], b_lo[2];
        load_a_split(a_hi + pm * kTileL * DP, a_lo + pm * kTileL * DP, DP, k0, g, t, ah, al);
        split_b(lr[k0], lr[k0 + 4], b_hi, b_lo);
        mma_3xtf32(acc, ah, al, b_hi, b_lo);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = pm * kTileL + g + (e >> 1) * 8, c = jt * 8 + 2 * t + (e & 1);
        if (r < nl && c < nt) out_b[(size_t)r * N + n0 + c] = acc[e] * oscale;
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

// Largest dynamic shared memory a block may ask for, the SM count and the
// shared memory of an SM of the current device (queried once per device);
// max_smem -1 when there is none.
struct DeviceInfo {
  int max_smem = -1;
  int sms = 0;
  int smem_per_sm = 0;    // shared memory of one SM
  int smem_reserved = 0;  // shared memory the system keeps per block
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
        cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&d.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev) !=
            cudaSuccess)
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

// rows: queries per block; threads per block
template <typename Kernel>
cudaError_t launch_grouped(Kernel kernel, int rows, int threads, const float* q, const float* k,
                           const float* v, const float* lk, const float* bias, const float* w,
                           float* out, int B, int L, int N, int D, int H, int smem, int* granted,
                           cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (L + rows - 1) / rows);
  kernel<<<grid, dim3(threads), smem, stream>>>(q, k, v, lk, bias, w, out, L, N, D, H);
  return cudaGetLastError();
}

// The tensor-core kernel takes head widths 8, 16 and 32 up to D = kMmaMaxD;
// any other width runs on the CUDA cores.
inline bool grouped_on_tensor_cores(int D, int H) {
  const int hd = D / H;
  return (hd == 8 || hd == 16 || hd == 32) && D <= kMmaMaxD;
}

// m-tiles per block of the tensor-core kernel: at most as many as L fills
// (16 queries each), 1 past one node tile (whose accumulators take shared
// memory), and no more than keep 90 % of the blocks the SMs can hold at once
// busy, by registers and shared memory; 1 where nothing larger fits.
inline int grouped_mma_tiles(int B, int L, int N, int D, int H, const DeviceInfo& dev) {
  int mt = N > kGroupedTileN ? 1 : L > 2 * kTileL ? 4 : L > kTileL ? 2 : 1;
  for (; mt > 1; mt /= 2) {
    const int smem = (int)sizeof(float) * grouped_mma_smem_floats(N, D, H, mt);
    if (smem > dev.max_smem) continue;
    const int by_smem = dev.smem_per_sm / (smem + dev.smem_reserved);
    const int per_sm = by_smem < mma_min_blocks(mt) ? by_smem : mma_min_blocks(mt);
    const long long blocks = (long long)B * ((L + kTileL * mt - 1) / (kTileL * mt));
    if (10 * blocks >= 9LL * dev.sms * per_sm) break;
  }
  return mt;
}

}  // namespace

extern "C" {

int pointer_step_single_smem_bytes(int N, int D, int H) {
  return single_config(N, D, H, device_info().max_smem).smem;
}

// The least a launch asks for (the tensor-core kernel's one m-tile per
// block); a launch takes more m-tiles only where the device grants them.
int pointer_step_grouped_smem_bytes(int N, int D, int H) {
  if (grouped_on_tensor_cores(D, H))
    return (int)sizeof(float) * grouped_mma_smem_floats(N, D, H, 1);
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
  static int granted[11] = {};  // per kernel instance
  const auto go = [&](auto kernel, int rows, int threads, int smem, int* g) {
    return (int)launch_grouped(kernel, rows, threads, (const float*)q, (const float*)k,
                               (const float*)v, (const float*)lk, (const float*)bias,
                               (const float*)w, (float*)out, B, L, N, D, H, smem, g,
                               (cudaStream_t)stream);
  };
  if (!grouped_on_tensor_cores(D, H)) {
    const int smem = pointer_step_grouped_smem_bytes(N, D, H);
    return chunk_width(D, H) == 4 ? go(pointer_step_grouped_kernel<4>, kTileL, kGroupedThreads,
                                       smem, granted)
                                  : go(pointer_step_grouped_kernel<1>, kTileL, kGroupedThreads,
                                       smem, granted + 1);
  }
  const DeviceInfo dev = device_info();
  if (dev.max_smem < 0) return (int)cudaErrorNoDevice;
  const int mt = grouped_mma_tiles(B, L, N, D, H, dev);
  const int smem = (int)sizeof(float) * grouped_mma_smem_floats(N, D, H, mt);
  const int hd = D / H;
  const int i = 2 + 3 * (hd == 8 ? 0 : hd == 16 ? 1 : 2) + (mt == 1 ? 0 : mt == 2 ? 1 : 2);
  const auto by_mt = [&](auto k1, auto k2, auto k4) {
    return mt == 1   ? go(k1, kTileL, mma_threads(1), smem, granted + i)
           : mt == 2 ? go(k2, 2 * kTileL, mma_threads(2), smem, granted + i)
                     : go(k4, 4 * kTileL, mma_threads(4), smem, granted + i);
  };
  switch (hd) {
    case 8:
      return by_mt(pointer_step_grouped_mma_kernel<8, 1>, pointer_step_grouped_mma_kernel<8, 2>,
                   pointer_step_grouped_mma_kernel<8, 4>);
    case 16:
      return by_mt(pointer_step_grouped_mma_kernel<16, 1>, pointer_step_grouped_mma_kernel<16, 2>,
                   pointer_step_grouped_mma_kernel<16, 4>);
    default:
      return by_mt(pointer_step_grouped_mma_kernel<32, 1>, pointer_step_grouped_mma_kernel<32, 2>,
                   pointer_step_grouped_mma_kernel<32, 4>);
  }
}

}  // extern "C"
