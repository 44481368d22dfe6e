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
// arithmetic is f32. Scores, weights, glimpse and projection live in shared
// memory and registers only: device memory sees the inputs once per block
// and the logits once.
//
// Plain C interface (no PyTorch headers): raw device pointers, sizes, the
// stream. Each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // threads per block, single kernel
constexpr int kTileL = 16;     // queries per block in the grouped kernel
constexpr int kGroupedThreads = 256;  // threads per block, grouped kernel
constexpr int kSubL = 8;       // queries per thread in its scores, glimpse, projection
constexpr int kGroupL = 4;     // queries per thread in its logits phase

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax of one row of n floats in shared memory, in place, by one warp.
// The row maximum is subtracted first, so a row whose bias is -1e9
// everywhere still gives finite weights. Each lane touches only its own
// elements, so no synchronisation is needed inside.
__device__ __forceinline__ void warp_softmax_row(float* row, int n, int lane) {
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, row[i]);
  m = warp_max(m);
  float sum = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float e = expf(row[i] - m);
    row[i] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  const float inv = 1.f / sum;
  for (int i = lane; i < n; i += 32) row[i] *= inv;
}

// ---------------------------------------------------------------------------
// Single query per instance. One block per instance.
// Shared memory: q [D], glimpse [D], proj [D], scores [H*N].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pointer_step_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ lk,
                           const float* __restrict__ bias, const float* __restrict__ w,
                           float* __restrict__ out, int N, int D, int H) {
  extern __shared__ float smem[];
  float* q_s = smem;        // [D]
  float* g_s = q_s + D;     // [D]
  float* p_s = g_s + D;     // [D]
  float* s_s = p_s + D;     // [H*N]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  const int hd = D / H;
  const size_t row0 = (size_t)b * N;
  const float* kb = k + row0 * D;
  const float* vb = v + row0 * D;
  const float* lkb = lk + row0 * D;
  const float* bias_b = bias + row0;

  for (int d = tid; d < D; d += kThreads) q_s[d] = q[(size_t)b * D + d];
  __syncthreads();

  // scores: one thread per (head, node); each reads its head's hd
  // contiguous floats of K[n] (whole 32-byte sectors, 16-byte loads)
  const float scale = 1.f / sqrtf((float)hd);
  const bool vec4 = (hd & 3) == 0;
  for (int p = tid; p < H * N; p += kThreads) {
    const int h = p / N;
    const int n = p - h * N;
    const float* kr = kb + (size_t)n * D + h * hd;
    const float* qr = q_s + h * hd;
    float acc = 0.f;
    if (vec4) {
      const float4* kr4 = reinterpret_cast<const float4*>(kr);
      for (int j = 0; j < (hd >> 2); ++j) {
        const float4 kk = kr4[j];
        acc += qr[4 * j] * kk.x + qr[4 * j + 1] * kk.y + qr[4 * j + 2] * kk.z +
               qr[4 * j + 3] * kk.w;
      }
    } else {
      for (int j = 0; j < hd; ++j) acc += qr[j] * kr[j];
    }
    s_s[p] = acc * scale + bias_b[n];
  }
  __syncthreads();

  for (int h = warp; h < H; h += nwarps) warp_softmax_row(s_s + h * N, N, lane);
  __syncthreads();

  // glimpse: thread d walks the nodes; neighbouring threads read
  // neighbouring addresses of V[n]
  for (int d = tid; d < D; d += kThreads) {
    const float* wrow = s_s + (d / hd) * N;
    float acc = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) acc += wrow[n] * vb[(size_t)n * D + d];
    g_s[d] = acc;
  }
  __syncthreads();

  // projection: thread j reads W[d][j] along j
  for (int j = tid; j < D; j += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc += g_s[d] * w[(size_t)d * D + j];
    p_s[j] = acc;
  }
  __syncthreads();

  // logits: one warp per node
  const float oscale = 1.f / sqrtf((float)D);
  for (int n = warp; n < N; n += nwarps) {
    const float* lr = lkb + (size_t)n * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += p_s[d] * lr[d];
    acc = warp_sum(acc);
    if (lane == 0) out[row0 + n] = acc * oscale;
  }
}

// ---------------------------------------------------------------------------
// Grouped queries. One block per (instance, tile of kTileL queries).
// One [N, D] staging buffer in shared memory holds K, then V, then LK, so each
// is read from device memory once per block and shared by the tile's queries.
// Every thread keeps the accumulators of several queries in registers.
//
// The inner loops are bound by loads from shared memory, not by arithmetic,
// so they walk the reduction axis in chunks of C floats: with C = 4 one
// 16-byte load feeds four multiply-adds. That needs every head to start on a
// 16-byte boundary (D / H a multiple of 4); any other head width runs the
// same code with C = 1. Rows of the staging buffer are D + C floats apart:
// with C = 4 the eight threads of a quarter warp that read the same columns
// of neighbouring rows hit eight different 16-byte bank groups, with C = 1
// threads that walk down a column hit different banks.
// Shared memory: stage [N*(D+C)], q/glimpse [kTileL*D], proj [kTileL*D],
// scores [kTileL*H*NP] with rows padded to NP = N rounded up to 4.
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

template <int C>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           int N, int D, int tid) {
  const int DP = D + C;
  for (int i = tid * C; i < N * D; i += kGroupedThreads * C) {
    const int n = i / D;
    store_chunk<C>(dst + n * DP + (i - n * D), load_chunk<C>(src + i));
  }
}

template <int C>
__global__ void __launch_bounds__(kGroupedThreads)
pointer_step_grouped_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ lk,
                            const float* __restrict__ bias, const float* __restrict__ w,
                            float* __restrict__ out, int L, int N, int D, int H) {
  extern __shared__ __align__(16) float smem_grouped[];
  float* smem = smem_grouped;
  const int DP = D + C;
  const int NP = padded_nodes(N);
  float* buf = smem;                 // [N*DP]   K, then V, then LK
  float* q_s = buf + N * DP;         // [kTileL*D] queries, later the glimpse
  float* p_s = q_s + kTileL * D;     // [kTileL*D] projection
  float* s_s = p_s + kTileL * D;     // [kTileL*H*NP] scores, then weights

  const int b = blockIdx.x;
  const int l0 = blockIdx.y * kTileL;
  const int nl = min(kTileL, L - l0);  // queries of this tile that exist
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kGroupedThreads >> 5;
  constexpr int kSubTiles = kTileL / kSubL;
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
  stage_rows<C>(buf, k + row0 * D, N, D, tid);
  __syncthreads();

  // scores: one thread per (head, node, sub-tile of kSubL queries), the
  // sub-tile's accumulators in registers
  const float scale = 1.f / sqrtf((float)hd);
  for (int p = tid; p < kSubTiles * H * N; p += kGroupedThreads) {
    const int sub = p / (H * N);
    const int hn = p - sub * H * N;
    const int h = hn / N;
    const int n = hn - h * N;
    const int lb = sub * kSubL;
    const float* kr = buf + n * DP + h * hd;
    const float* qr = q_s + lb * D + h * hd;
    float acc[kSubL];
#pragma unroll
    for (int l = 0; l < kSubL; ++l) acc[l] = 0.f;
    for (int j = 0; j < hd; j += C) {
      const Chunk<C> kv = load_chunk<C>(kr + j);
#pragma unroll
      for (int l = 0; l < kSubL; ++l) {
        const Chunk<C> qv = load_chunk<C>(qr + l * D + j);
#pragma unroll
        for (int e = 0; e < C; ++e) acc[l] += qv.v[e] * kv.v[e];
      }
    }
#pragma unroll
    for (int l = 0; l < kSubL; ++l) {
      // rows past the edge hold zeros: they are never normalised or stored
      s_s[((lb + l) * H + h) * NP + n] =
          (lb + l < nl) ? acc[l] * scale + bias_b[(size_t)(lb + l) * N + n] : 0.f;
    }
  }
  __syncthreads();  // K is no longer needed

  for (int r = warp; r < nl * H; r += nwarps) warp_softmax_row(s_s + r * NP, N, lane);
  stage_rows<C>(buf, v + row0 * D, N, D, tid);
  __syncthreads();

  // glimpse: one thread per (sub-tile, d) walks the nodes; the queries are
  // read no more (their scores are done), so the glimpse overwrites them
  for (int t = tid; t < kSubTiles * D; t += kGroupedThreads) {
    const int lb = (t / D) * kSubL;
    const int d = t % D;
    const float* wrow = s_s + (lb * H + d / hd) * NP;
    float acc[kSubL];
#pragma unroll
    for (int l = 0; l < kSubL; ++l) acc[l] = 0.f;
    int n = 0;
    for (; n + C <= N; n += C) {
      float vv[C];
#pragma unroll
      for (int e = 0; e < C; ++e) vv[e] = buf[(n + e) * DP + d];
#pragma unroll
      for (int l = 0; l < kSubL; ++l) {
        const Chunk<C> pv = load_chunk<C>(wrow + l * H * NP + n);
#pragma unroll
        for (int e = 0; e < C; ++e) acc[l] += pv.v[e] * vv[e];
      }
    }
    for (; n < N; ++n) {  // the nodes past the last whole chunk
      const float vv = buf[n * DP + d];
#pragma unroll
      for (int l = 0; l < kSubL; ++l) acc[l] += wrow[l * H * NP + n] * vv;
    }
#pragma unroll
    for (int l = 0; l < kSubL; ++l) q_s[(lb + l) * D + d] = acc[l];
  }
  __syncthreads();  // V is no longer needed

  stage_rows<C>(buf, lk + row0 * D, N, D, tid);
  // projection: one thread per (sub-tile, j) reads W[d][j] along j
  for (int t = tid; t < kSubTiles * D; t += kGroupedThreads) {
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
        const Chunk<C> gv = load_chunk<C>(q_s + (lb + l) * D + d);
#pragma unroll
        for (int e = 0; e < C; ++e) acc[l] += gv.v[e] * wv[e];
      }
    }
#pragma unroll
    for (int l = 0; l < kSubL; ++l) p_s[(lb + l) * D + j] = acc[l];
  }
  __syncthreads();

  // logits: one thread per (group of kGroupL queries, node)
  const float oscale = 1.f / sqrtf((float)D);
  for (int p = tid; p < (kTileL / kGroupL) * N; p += kGroupedThreads) {
    const int g = p / N;
    const int n = p - g * N;
    if (g * kGroupL >= nl) continue;
    const float* lr = buf + n * DP;
    const float* wrow = p_s + g * kGroupL * D;
    float acc[kGroupL];
#pragma unroll
    for (int i = 0; i < kGroupL; ++i) acc[i] = 0.f;
    for (int d = 0; d < D; d += C) {
      const Chunk<C> lv = load_chunk<C>(lr + d);
#pragma unroll
      for (int i = 0; i < kGroupL; ++i) {
        const Chunk<C> pv = load_chunk<C>(wrow + i * D + d);
#pragma unroll
        for (int e = 0; e < C; ++e) acc[i] += pv.v[e] * lv.v[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kGroupL; ++i) {
      const int l = g * kGroupL + i;
      if (l < nl) out_b[(size_t)l * N + n] = acc[i] * oscale;
    }
  }
}

// The chunk the grouped kernel walks its reduction axes in: 4 floats where
// every head starts on a 16-byte boundary, else 1.
inline int grouped_chunk(int D, int H) { return ((D / H) & 3) == 0 ? 4 : 1; }

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

int g_single_granted = 0;

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
  return (int)sizeof(float) * (3 * D + H * N);
}

int pointer_step_grouped_smem_bytes(int N, int D, int H) {
  return (int)sizeof(float) * (N * (D + grouped_chunk(D, H)) + 2 * kTileL * D +
                              kTileL * H * padded_nodes(N));
}

// Largest dynamic shared memory a block may ask for on the current device.
int pointer_kernel_max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return -1;
  return bytes;
}

const char* pointer_kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// L is ignored (one query per instance); kept so both entry points share a
// signature.
int pointer_step_single(const void* q, const void* k, const void* v, const void* lk,
                        const void* bias, const void* w, void* out, int B, int L, int N,
                        int D, int H, void* stream) {
  (void)L;
  const int smem = pointer_step_single_smem_bytes(N, D, H);
  cudaError_t err = allow_smem(pointer_step_single_kernel, smem, &g_single_granted);
  if (err != cudaSuccess) return (int)err;
  pointer_step_single_kernel<<<dim3(B), dim3(kThreads), smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)lk,
      (const float*)bias, (const float*)w, (float*)out, N, D, H);
  return (int)cudaGetLastError();
}

int pointer_step_grouped(const void* q, const void* k, const void* v, const void* lk,
                         const void* bias, const void* w, void* out, int B, int L, int N,
                         int D, int H, void* stream) {
  const int smem = pointer_step_grouped_smem_bytes(N, D, H);
  const auto launch = grouped_chunk(D, H) == 4 ? launch_grouped<4> : launch_grouped<1>;
  return (int)launch((const float*)q, (const float*)k, (const float*)v, (const float*)lk,
                     (const float*)bias, (const float*)w, (float*)out, B, L, N, D, H, smem,
                     (cudaStream_t)stream);
}

}  // extern "C"
