// Block-Jacobi preconditioned CG on the pair-sparse normal equations, by hand
// for Hopper.
//
// Replaces super_tpu/pallas_kernels/pcg.py:_pairs_cg_kernel.  It solves
// (S + S^T + u I) x = b for `iterations` steps, warm-started from x0.  S holds
// P node pairs (n1, n2) with 7x7 blocks B: y[n1] += B x[n2] and
// y[n2] += B^T x[n1]; pairs with an id outside [0, J) are sinks and add
// nothing.  The blocks and the preconditioner come in the JAX package's
// diagonal-band tables: row 8d+i of a (64, M) table holds M[i][(i+d) % 8], so
// entry (i, c) sits in row 8 * ((c - i) & 7) + i.  alpha and beta are guarded
// by |.| > 1e-30, as in the reference.
//
// Bound on this card: every iteration streams both band tables (2 x 49 x P
// floats, 1.6 MB at P = 4096) and two dot products need every node.  One
// thread block of 1024 threads runs all iterations: the vectors (7 x J each)
// live in its shared memory and the tables are read from L2, where they stay
// resident (2 MB of the 50 MB).  The floor is then one SM's L2 read rate,
// not HBM: the whole solve moves its 2.2 MB of inputs from HBM once.
//
// Design.  The TPU kernel gathers and scatters with one-hot matrix products
// and rolls the band rows, workarounds for the TPU's missing dynamic VMEM
// indexing.  Here threads index x[n2] directly:
//   - once per solve, two stable counting sorts (integer atomics for the
//     counts, warp match for the in-bucket ranks) give, for each node, the
//     list of its pairs by n1 and by n2 in ascending pair order.  pair_key
//     is sorted, so the n1 lists are contiguous; the kernel does not rely on
//     it;
//   - per matvec, one thread per pair computes t1 = B x[n2] and
//     t2 = B^T x[n1] (coalesced band reads) into a small global scratch,
//     then one thread per node row sums its two lists in order.
// No float atomics: every sum has a fixed order, so the result is the same
// from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float *x, *r, *p, *z, *ap, *red;
  int *perm1, *perm2, *start1, *start2, *cur1, *cur2;
};

__device__ __forceinline__ int band_row(int i, int c) { return 8 * ((c - i) & 7) + i; }

__device__ __forceinline__ bool valid_pair(int a, int b, int J) {
  return (unsigned)a < (unsigned)J && (unsigned)b < (unsigned)J;
}

// Sum of a[e] * b[e] over the 7J entries; every thread returns the same
// value.  `buf` alternates between calls so one barrier per call suffices.
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

// ap = (S + S^T + u I) v.  Ends with a barrier.
__device__ void matvec(const float* __restrict__ blk, const float* __restrict__ blkt,
                       const int* __restrict__ n1, const int* __restrict__ n2,
                       float* t1, float* t2, const Smem& sm, const float* v,
                       float* ap, float u, int J, int P) {
  for (int k = threadIdx.x; k < P; k += NT) {
    const int a = n1[k], b = n2[k];
    if (!valid_pair(a, b, J)) continue;
    float g1[7], g2[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      g1[c] = v[c * J + a];
      g2[c] = v[c * J + b];
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const size_t row = (size_t)band_row(i, c) * P + k;
        s1 = fmaf(blk[row], g2[c], s1);
        s2 = fmaf(blkt[row], g1[c], s2);
      }
      t1[i * P + k] = s1;
      t2[i * P + k] = s2;
    }
  }
  __syncthreads();  // t1/t2 (global, written by this block) are now visible
  for (int e = threadIdx.x; e < 7 * J; e += NT) {
    const int i = e / J, j = e - i * J;
    float s = 0.f;
    for (int q = sm.start1[j]; q < sm.start1[j + 1]; ++q) s += t1[i * P + sm.perm1[q]];
    for (int q = sm.start2[j]; q < sm.start2[j + 1]; ++q) s += t2[i * P + sm.perm2[q]];
    ap[e] = s + u * v[e];
  }
  __syncthreads();
}

// z = Minv r with the block-Jacobi inverse in band form (64, J).
__device__ void precond(const float* __restrict__ minv, const float* r, float* z, int J) {
  for (int e = threadIdx.x; e < 7 * J; e += NT) {
    const int i = e / J, j = e - i * J;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 7; ++c) s = fmaf(minv[(size_t)band_row(i, c) * J + j], r[c * J + j], s);
    z[e] = s;
  }
}

// Stable bucket sort of the valid pairs by n1 (warp 0) and by n2 (warp 1).
__device__ void build_lists(const int* __restrict__ n1, const int* __restrict__ n2,
                            const Smem& sm, int J, int P) {
  for (int q = threadIdx.x; q <= J; q += NT) {
    sm.cur1[q] = 0;
    sm.cur2[q] = 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P; k += NT) {
    const int a = n1[k], b = n2[k];
    if (valid_pair(a, b, J)) {
      atomicAdd(&sm.cur1[a], 1);
      atomicAdd(&sm.cur2[b], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    int* cnt = threadIdx.x == 0 ? sm.cur1 : sm.cur2;
    int* start = threadIdx.x == 0 ? sm.start1 : sm.start2;
    int s = 0;
    for (int j = 0; j < J; ++j) {
      start[j] = s;
      s += cnt[j];
      cnt[j] = start[j];  // the count becomes the bucket's write cursor
    }
    start[J] = s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int* keys = warp == 0 ? n1 : n2;
    int* cur = warp == 0 ? sm.cur1 : sm.cur2;
    int* perm = warp == 0 ? sm.perm1 : sm.perm2;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < P; base += 32) {
      const int k = base + lane;
      int key = -1;
      if (k < P && valid_pair(n1[k], n2[k], J)) key = keys[k];
      const unsigned peers = __match_any_sync(FULL, key);
      const int pos = key >= 0 ? cur[key] : 0;
      __syncwarp();
      if (key >= 0) {
        perm[pos + __popc(peers & below)] = k;
        if (lane == __ffs(peers) - 1) cur[key] = pos + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
pairs_cg_kernel(const float* __restrict__ blk, const float* __restrict__ blkt,
                const int* __restrict__ n1, const int* __restrict__ n2,
                const float* __restrict__ minv, const float* __restrict__ b,
                const float* __restrict__ x0, const float* __restrict__ u_ptr,
                float* __restrict__ x_out, float* t_scratch, int J, int P,
                int iterations) {
  extern __shared__ float smem[];
  const int n = 7 * J;
  Smem sm;
  sm.x = smem;
  sm.r = sm.x + n;
  sm.p = sm.r + n;
  sm.z = sm.p + n;
  sm.ap = sm.z + n;
  sm.red = sm.ap + n;                       // 2 x 32 floats
  int* ibase = reinterpret_cast<int*>(sm.red + 64);
  sm.perm1 = ibase;
  sm.perm2 = sm.perm1 + P;
  sm.start1 = sm.perm2 + P;
  sm.start2 = sm.start1 + (J + 1);
  sm.cur1 = sm.start2 + (J + 1);
  sm.cur2 = sm.cur1 + (J + 1);
  float* t1 = t_scratch;
  float* t2 = t_scratch + 7 * (size_t)P;
  const float u = *u_ptr;

  build_lists(n1, n2, sm, J, P);

  for (int e = threadIdx.x; e < n; e += NT) {
    sm.x[e] = x0[e];
    sm.p[e] = x0[e];
  }
  __syncthreads();
  matvec(blk, blkt, n1, n2, t1, t2, sm, sm.p, sm.ap, u, J, P);
  for (int e = threadIdx.x; e < n; e += NT) sm.r[e] = b[e] - sm.ap[e];
  __syncthreads();
  precond(minv, sm.r, sm.z, J);
  int buf = 0;
  float rz = block_dot(sm.r, sm.z, n, sm.red, buf);
  buf ^= 1;
  for (int e = threadIdx.x; e < n; e += NT) sm.p[e] = sm.z[e];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    matvec(blk, blkt, n1, n2, t1, t2, sm, sm.p, sm.ap, u, J, P);
    const float pap = block_dot(sm.p, sm.ap, n, sm.red, buf);
    buf ^= 1;
    const float alpha = fabsf(pap) > 1e-30f ? rz / pap : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) {
      sm.x[e] += alpha * sm.p[e];
      sm.r[e] -= alpha * sm.ap[e];
    }
    __syncthreads();
    precond(minv, sm.r, sm.z, J);
    const float rz_new = block_dot(sm.r, sm.z, n, sm.red, buf);
    buf ^= 1;
    const float beta = fabsf(rz) > 1e-30f ? rz_new / rz : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) sm.p[e] = sm.z[e] + beta * sm.p[e];
    rz = rz_new;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n; e += NT) x_out[e] = sm.x[e];
}

size_t smem_bytes(int J, int P) {
  return (size_t)(5 * 7 * J + 64) * sizeof(float) + (size_t)(2 * P + 4 * (J + 1)) * sizeof(int);
}

}  // namespace

extern "C" {

long long pairs_cg_smem_bytes(int J, int P) { return (long long)smem_bytes(J, P); }

// Returns a cudaError_t code (0 on success).  t_scratch holds 2 x 7 x P floats.
int pairs_cg_launch(const float* blk, const float* blkt, const int* n1, const int* n2,
                    const float* minv, const float* b, const float* x0, const float* u,
                    float* x_out, float* t_scratch, int J, int P, int iterations,
                    void* stream) {
  const size_t smem = smem_bytes(J, P);
  cudaError_t e = cudaFuncSetAttribute(pairs_cg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  pairs_cg_kernel<<<1, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      blk, blkt, n1, n2, minv, b, x0, u, x_out, t_scratch, J, P, iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"
