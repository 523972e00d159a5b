// Plain conjugate gradients on a dense symmetric matrix, by hand for Hopper.
//
// Replaces super_tpu/pallas_kernels/pcg.py:_pcg_kernel (entry pcg_pallas),
// the solve of linear_solver="pcg_pallas": the LM's damped normal matrix,
// block-preconditioned before the call (A-hat = L^-1 A L^-T, unit diagonal
// blocks), so the kernel runs CG from x0 = 0 with no preconditioner, for a
// fixed number of iterations, alpha and beta guarded by |.| > 1e-30.
//
// Bound on this card: every iteration reads the whole matrix once (n^2 f32:
// 31.7 MB at n = 2816, J = 384), and two dot products need every entry.  The
// matrix fits the 50 MB L2, so after the first pass the matvecs read L2, at
// the rate of all SMs together; the floor of the whole solve is one read of
// the matrix from HBM.
//
// Design.  The TPU kernel streams row tiles of A through VMEM on one core.
// Here one cooperative launch puts one block on every SM; the rows are split
// evenly across the blocks and a block's warps take one row at a time (16-byte
// loads, neighbouring lanes on neighbouring addresses) against a full copy
// of p in the block's shared memory.  An iteration has two grid-wide
// barriers: after the matvec (each block has written its partial of p.Ap)
// and after the x, r update (each block has written its rows of r and its
// partial of r.r).  Every block then sums the partials in block order, so
// all blocks hold the same alpha and beta, and each rebuilds its own copy of
// p = r + beta p from r.  No float atomics: the result is the same from run
// to run on a card with the same number of SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// Sum of a[e] * b[e] over n entries (shared memory); every thread returns
// the same value, and so does every block.
__device__ float block_dot(const float* a, const float* b, int n, float* red) {
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) s = fmaf(a[e], b[e], s);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < NW; ++w) tot += red[w];
  __syncthreads();  // red is reused by the next call
  return tot;
}

// Sum of the nb per-block partials, in block order; every thread of every
// block returns the same value.  The partials were written by other SMs in
// this launch: read them from L2 (__ldcg), never from a stale L1 line.
__device__ float grid_total(const float* part, int nb, float* red) {
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int q = threadIdx.x; q < nb; q += 32) s += __ldcg(part + q);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (threadIdx.x == 0) red[0] = s;
  }
  __syncthreads();
  const float tot = red[0];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(NT, 1)
dense_cg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ x, float* r, float* part, int n, int iterations) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = gridDim.x;
  const int row0 = (int)((long long)n * blockIdx.x / nb);
  const int row1 = (int)((long long)n * (blockIdx.x + 1) / nb);
  const int rows = row1 - row0;
  float* p = smem;          // n: every block's own full copy
  float* ap = p + n;        // this block's rows of A p
  float* red = ap + rows;   // NW floats
  float* part_pap = part;
  float* part_rr = part + nb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < n; e += NT) p[e] = b[e];
  for (int i = threadIdx.x; i < rows; i += NT) {
    x[row0 + i] = 0.f;
    r[row0 + i] = b[row0 + i];
  }
  __syncthreads();
  float rz = block_dot(p, p, n, red);

  const float4* p4 = reinterpret_cast<const float4*>(p);
  const int n4 = n / 4;
  for (int it = 0; it < iterations; ++it) {
    for (int i = warp; i < rows; i += NW) {
      const float4* arow = reinterpret_cast<const float4*>(a + (size_t)(row0 + i) * n);
      float s = 0.f;
#pragma unroll 4
      for (int q = lane; q < n4; q += 32) {
        const float4 av = arow[q];
        const float4 pv = p4[q];
        s = fmaf(av.x, pv.x, s);
        s = fmaf(av.y, pv.y, s);
        s = fmaf(av.z, pv.z, s);
        s = fmaf(av.w, pv.w, s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lane == 0) ap[i] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < rows; ++i) s = fmaf(p[row0 + i], ap[i], s);
      part_pap[blockIdx.x] = s;
    }
    grid.sync();
    const float pap = grid_total(part_pap, nb, red);
    const float alpha = fabsf(pap) > 1e-30f ? rz / pap : 0.f;
    for (int i = threadIdx.x; i < rows; i += NT) {
      x[row0 + i] += alpha * p[row0 + i];
      const float rn = __ldcg(r + row0 + i) - alpha * ap[i];
      r[row0 + i] = rn;
      ap[i] = rn;  // kept for this block's partial of r.r
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < rows; ++i) s = fmaf(ap[i], ap[i], s);
      part_rr[blockIdx.x] = s;
    }
    grid.sync();
    const float rz_new = grid_total(part_rr, nb, red);
    const float beta = fabsf(rz) > 1e-30f ? rz_new / rz : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) p[e] = __ldcg(r + e) + beta * p[e];
    rz = rz_new;
    __syncthreads();
  }
}

int num_blocks() {
  static int nb = -1;
  if (nb < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nb, cudaDevAttrMultiProcessorCount, dev);
  }
  return nb;
}

size_t smem_bytes(int n, int nb) {
  return (size_t)(n + (n + nb - 1) / nb + NW) * sizeof(float);
}

}  // namespace

extern "C" {

// Blocks of the cooperative grid: one per SM.
int dense_cg_blocks() { return num_blocks(); }

long long dense_cg_smem_bytes(int n) { return (long long)smem_bytes(n, num_blocks()); }

// Returns a cudaError_t code (0 on success).  n is a multiple of 4; a is
// (n, n) row-major and symmetric; r_scratch holds n floats, part_scratch
// 2 x dense_cg_blocks() floats.
int dense_cg_launch(const float* a, const float* b, float* x_out, float* r_scratch,
                    float* part_scratch, int n, int iterations, void* stream) {
  int nb = num_blocks();
  const size_t smem = smem_bytes(n, nb);
  cudaError_t e = cudaFuncSetAttribute(dense_cg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_cg_kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&a, (void*)&b, (void*)&x_out, (void*)&r_scratch,
                  (void*)&part_scratch, (void*)&n, (void*)&iterations};
  e = cudaLaunchCooperativeKernel((const void*)dense_cg_kernel, dim3(nb), dim3(NT), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
