// Block-Jacobi preconditioned CG on the pair-sparse normal equations, by hand
// for Hopper: kernels K1 and K1b, one template instantiated twice.
//
// Replaces super_tpu/pallas_kernels/pcg.py:_pairs_cg_kernel (K1) and
// _pairs_cg_kernel_chunked (K1b), which the JAX package takes once the
// one-hot matrices of K1 would pass 24 MiB (2 * jp * P * 4 bytes, jp = J
// rounded up to 128): at 480 x 640 and mesh step 16, J = 1216 nodes and
// P = 19,456 pairs.  Both solve (S + S^T + u I) x = b for `iterations`
// steps, warm-started from x0.  S holds P node pairs (n1, n2) with 7x7
// blocks B: y[n1] += B x[n2] and y[n2] += B^T x[n1]; pairs with an id
// outside [0, J) are sinks and add nothing.  The blocks and the
// preconditioner come in the JAX package's diagonal-band tables: row 8d+i of
// a (64, M) table holds M[i][(i+d) % 8], so entry (i, c) sits in row
// 8 * ((c - i) & 7) + i.  alpha and beta are guarded by |.| > 1e-30, as in
// the reference.  K1 reads the pair blocks in f32; K1b, as on the TPU, reads
// them rounded to bf16.  All arithmetic is f32.
//
// Bound on this card: every matvec streams both band tables (2 x 49 x P
// entries: 1.6 MB in f32 at P = 4096, 3.8 MB in bf16 at P = 19,456) and
// writes and re-reads the per-pair products (2 x 8 x P floats); each
// iteration needs two dot products over every node.  One thread block of
// 1024 threads runs all iterations: the five vectors (7 x J floats each)
// live in its shared memory, so J <= 1658, and everything else is read from
// L2, where it stays resident.  The whole solve moves its inputs from HBM
// once; its floor is the rate at which one SM reads L2.  A cooperative grid
// over all SMs is the follow-on.
//
// Design.  The TPU kernel gathers and scatters with one-hot matrix products
// and rolls the band rows, workarounds for the TPU's missing dynamic VMEM
// indexing.  Here threads index x[n2] directly:
//   - once per solve, two stable counting sorts (integer atomics for the
//     counts, warp match for the in-bucket ranks) give each node its pairs
//     by n1 and by n2 in ascending pair order.  The lists (perm, start) sit
//     in shared memory in K1 and in global memory in K1b, where they would
//     not fit (345 KB with the vectors at J = 1216); the bucket cursors
//     borrow the shared memory the vectors take later;
//   - vectors are node-major in shared memory (entry 7 j + i), so a thread
//     that handles one node reads its 7 entries without bank conflicts;
//   - per matvec, one thread per pair computes t1 = B x[n2] and
//     t2 = B^T x[n1] into pair-major scratch (8 floats, one 32-byte sector
//     per pair), then one thread per node row sums its two lists in order.
// No float atomics: every sum has a fixed order, so the result is the same
// from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Lists {
  int *perm1, *perm2, *start1, *start2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int band_row(int i, int c) { return 8 * ((c - i) & 7) + i; }

__device__ __forceinline__ bool valid_pair(int a, int b, int J) {
  return (unsigned)a < (unsigned)J && (unsigned)b < (unsigned)J;
}

// Sum of a[e] * b[e] over n entries; every thread returns the same value.
// `buf` alternates between calls so one barrier per call suffices.
__device__ float block_dot(const float* a, const float* b, int n, float* red, int buf) {
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) s = fmaf(a[e], b[e], s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  float* slot = red + 32 * buf;
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < NW; ++w) tot += slot[w];
  return tot;
}

// ap = (S + S^T + u I) v, node-major.  Ends with a barrier.
template <typename Band>
__device__ void matvec(const Band* __restrict__ blk, const Band* __restrict__ blkt,
                       const int* __restrict__ n1, const int* __restrict__ n2,
                       float* t1, float* t2, const Lists& ls, const float* v,
                       float* ap, float u, int J, int P) {
  for (int k = threadIdx.x; k < P; k += NT) {
    const int a = n1[k], b = n2[k];
    if (!valid_pair(a, b, J)) continue;
    float g1[7], g2[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      g1[c] = v[7 * a + c];
      g2[c] = v[7 * b + c];
    }
    float s1[8], s2[8];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const size_t row = (size_t)band_row(i, c) * P + k;
        a1 = fmaf(to_f32(blk[row]), g2[c], a1);
        a2 = fmaf(to_f32(blkt[row]), g1[c], a2);
      }
      s1[i] = a1;
      s2[i] = a2;
    }
    s1[7] = 0.f;
    s2[7] = 0.f;
    float4* o1 = reinterpret_cast<float4*>(t1 + 8 * (size_t)k);
    float4* o2 = reinterpret_cast<float4*>(t2 + 8 * (size_t)k);
    o1[0] = make_float4(s1[0], s1[1], s1[2], s1[3]);
    o1[1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
    o2[0] = make_float4(s2[0], s2[1], s2[2], s2[3]);
    o2[1] = make_float4(s2[4], s2[5], s2[6], s2[7]);
  }
  __syncthreads();  // t1/t2 (global, written by this block) are now visible
  for (int e = threadIdx.x; e < 7 * J; e += NT) {
    const int j = e / 7, i = e - 7 * j;
    float s = 0.f;
    for (int q = ls.start1[j]; q < ls.start1[j + 1]; ++q) s += t1[8 * (size_t)ls.perm1[q] + i];
    for (int q = ls.start2[j]; q < ls.start2[j + 1]; ++q) s += t2[8 * (size_t)ls.perm2[q] + i];
    ap[e] = s + u * v[e];
  }
  __syncthreads();
}

// z = Minv r with the block-Jacobi inverse in band form (64, J); one thread
// per node.
__device__ void precond(const float* __restrict__ minv, const float* r, float* z, int J) {
  for (int j = threadIdx.x; j < J; j += NT) {
    float rj[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) rj[c] = r[7 * j + c];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 7; ++c) s = fmaf(minv[(size_t)band_row(i, c) * J + j], rj[c], s);
      z[7 * j + i] = s;
    }
  }
}

// Stable bucket sort of the valid pairs by n1 (warp 0) and by n2 (warp 1);
// `cur` is 2 (J + 1) ints of shared scratch.
__device__ void build_lists(const int* __restrict__ n1, const int* __restrict__ n2,
                            const Lists& ls, int* cur, int J, int P) {
  int* cur1 = cur;
  int* cur2 = cur + (J + 1);
  for (int q = threadIdx.x; q <= J; q += NT) {
    cur1[q] = 0;
    cur2[q] = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P; k += NT) {
    const int a = n1[k], b = n2[k];
    if (valid_pair(a, b, J)) {
      atomicAdd(&cur1[a], 1);
      atomicAdd(&cur2[b], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    int* cnt = threadIdx.x == 0 ? cur1 : cur2;
    int* start = threadIdx.x == 0 ? ls.start1 : ls.start2;
    int s = 0;
    for (int j = 0; j < J; ++j) {
      const int c = cnt[j];
      start[j] = s;
      cnt[j] = s;  // the count becomes the bucket's write cursor
      s += c;
    }
    start[J] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int* keys = warp == 0 ? n1 : n2;
    int* cur_w = warp == 0 ? cur1 : cur2;
    int* perm = warp == 0 ? ls.perm1 : ls.perm2;
    const unsigned below = (1u << lane) - 1u;
    auto key_at = [&](int k) {
      return (k < P && valid_pair(n1[k], n2[k], J)) ? keys[k] : -1;
    };
    int next = key_at(lane);  // loads run one step ahead of their use
    for (int base = 0; base < P; base += 32) {
      const int k = base + lane;
      const int key = next;
      next = key_at(k + 32);
      const unsigned peers = __match_any_sync(FULL, key);
      const int pos = key >= 0 ? cur_w[key] : 0;
      __syncwarp();
      if (key >= 0) {
        perm[pos + __popc(peers & below)] = k;
        if (lane == __ffs(peers) - 1) cur_w[key] = pos + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// Band: float (K1) or __nv_bfloat16 (K1b).  kSmemLists: the pair lists in
// shared memory after the vectors (K1), or in i_scratch (K1b).
template <typename Band, bool kSmemLists>
__global__ void __launch_bounds__(NT, 1)
pairs_cg_kernel(const Band* __restrict__ blk, const Band* __restrict__ blkt,
                const int* __restrict__ n1, const int* __restrict__ n2,
                const float* __restrict__ minv, const float* __restrict__ b,
                const float* __restrict__ x0, const float* __restrict__ u_ptr,
                float* __restrict__ x_out, float* t_scratch, int* i_scratch, int J,
                int P, int iterations) {
  extern __shared__ float smem[];
  const int n = 7 * J;
  float* x = smem;
  float* r = x + n;
  float* p = r + n;
  float* z = p + n;
  float* ap = z + n;
  float* red = ap + n;  // 2 x 32 floats
  Lists ls;
  ls.perm1 = kSmemLists ? reinterpret_cast<int*>(red + 64) : i_scratch;
  ls.perm2 = ls.perm1 + P;
  ls.start1 = ls.perm2 + P;
  ls.start2 = ls.start1 + (J + 1);
  float* t1 = t_scratch;
  float* t2 = t_scratch + 8 * (size_t)P;
  const float u = *u_ptr;

  build_lists(n1, n2, ls, reinterpret_cast<int*>(smem), J, P);

  for (int e = threadIdx.x; e < n; e += NT) {
    const int j = e / 7, i = e - 7 * j;
    x[e] = x0[i * J + j];
    p[e] = x[e];
  }
  __syncthreads();
  matvec(blk, blkt, n1, n2, t1, t2, ls, p, ap, u, J, P);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int j = e / 7, i = e - 7 * j;
    r[e] = b[i * J + j] - ap[e];
  }
  __syncthreads();
  precond(minv, r, z, J);
  __syncthreads();
  int buf = 0;
  float rz = block_dot(r, z, n, red, buf);
  buf ^= 1;
  for (int e = threadIdx.x; e < n; e += NT) p[e] = z[e];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    matvec(blk, blkt, n1, n2, t1, t2, ls, p, ap, u, J, P);
    const float pap = block_dot(p, ap, n, red, buf);
    buf ^= 1;
    const float alpha = fabsf(pap) > 1e-30f ? rz / pap : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) {
      x[e] += alpha * p[e];
      r[e] -= alpha * ap[e];
    }
    __syncthreads();
    precond(minv, r, z, J);
    __syncthreads();
    const float rz_new = block_dot(r, z, n, red, buf);
    buf ^= 1;
    const float beta = fabsf(rz) > 1e-30f ? rz_new / rz : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) p[e] = z[e] + beta * p[e];
    rz = rz_new;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n; e += NT) {
    const int j = e / 7, i = e - 7 * j;
    x_out[i * J + j] = x[e];
  }
}

size_t smem_bytes(int J, int P, bool smem_lists) {
  const size_t lists = smem_lists ? (size_t)(2 * P + 2 * (J + 1)) * sizeof(int) : 0;
  return (size_t)(5 * 7 * J + 64) * sizeof(float) + lists;
}

template <typename Band, bool kSmemLists>
int launch(const void* blk, const void* blkt, const int* n1, const int* n2,
           const float* minv, const float* b, const float* x0, const float* u,
           float* x_out, float* t_scratch, int* i_scratch, int J, int P, int iterations,
           void* stream) {
  auto* kernel = pairs_cg_kernel<Band, kSmemLists>;
  const size_t smem = smem_bytes(J, P, kSmemLists);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Band*>(blk), static_cast<const Band*>(blkt), n1, n2, minv, b, x0, u,
      x_out, t_scratch, i_scratch, J, P, iterations);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// chunked = 0: K1 (f32 blocks, lists in shared memory); 1: K1b (bf16
// blocks, lists in global memory).
long long pairs_cg_smem_bytes(int J, int P, int chunked) {
  return (long long)smem_bytes(J, P, chunked == 0);
}

// Returns a cudaError_t code (0 on success).  t_scratch holds 2 x 8 x P
// floats (16-byte aligned); i_scratch 2 P + 2 (J + 1) ints for K1b, unused
// by K1.
int pairs_cg_launch(const void* blk, const void* blkt, const int* n1, const int* n2,
                    const float* minv, const float* b, const float* x0, const float* u,
                    float* x_out, float* t_scratch, int* i_scratch, int J, int P,
                    int iterations, int chunked, void* stream) {
  if (chunked)
    return launch<__nv_bfloat16, false>(blk, blkt, n1, n2, minv, b, x0, u, x_out, t_scratch,
                                        i_scratch, J, P, iterations, stream);
  return launch<float, true>(blk, blkt, n1, n2, minv, b, x0, u, x_out, t_scratch, i_scratch,
                             J, P, iterations, stream);
}

}  // extern "C"
