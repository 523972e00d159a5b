// Tuple-Gram reduction of the tuple-grouped JTJ assembly, by hand for Hopper.
//
// Replaces super_tpu/pallas_kernels/gram.py:_gram_kernel.  Input: gradient
// rows h (Np, 28) and residuals r (Np,) in tuple-sorted padded order, and the
// sorted tuple id of each G-row block (block_tuple, Np / G).  Output: for
// every tuple t, gram[t] = sum over its rows of h^T h (28 x 28) and
// jtr[t] = sum of h^T r (28); tuples that no block visits are zero.
//
// Bound on this card: the bytes.  On the 480 x 640 main path (Np = 720,896,
// T = 4096) the inputs are 84 MB read once and the outputs 13 MB written
// once, while the 1.2 GFLOP of products need ~17 us of the f32 rate: the
// floor is ~29 us of HBM traffic.
//
// Design.  The TPU kernel walks the blocks in order and accumulates into the
// output row of the current tuple, a carried sum that Hopper's unordered
// blocks cannot have.  Here:
//   pass 1 (one thread block per span of SPAN G-blocks): the block stages
//     each G x 29 row tile [h | r] in shared memory and each of its 812
//     threads owns one (i, j) entry of the 28 x 29 Gram, summing over the
//     rows in a fixed order.  The sum runs on across the G-blocks of the
//     span while their tuple stays the same, and is written to a scratch row
//     at the last G-block of each (span, tuple) segment;
//   pass 2 (one thread block per tuple): finds the tuple's run of G-blocks by
//     binary search on the sorted block_tuple and adds its segment rows in
//     ascending order.
// No float atomics: every sum has one fixed order, so the result is the same
// from run to run.  Entry (i, j) and (j, i) are the same fmaf chain, so each
// Gram is bitwise symmetric.  Ids outside [0, T) are never read as a tuple.
#include <cuda_runtime.h>

namespace {

constexpr int D = 28;            // gradient width: 4 anchors x 7
constexpr int DE = D + 1;        // plus the residual column
constexpr int NOUT = D * DE;     // 812 Gram entries per block
constexpr int ROW = 32;          // shared-memory row stride (floats)
constexpr int P1_THREADS = 832;  // 26 warps >= NOUT
constexpr int P2_THREADS = 256;
constexpr int SPAN = 16;         // G-blocks per pass-1 thread block

__global__ void __launch_bounds__(P1_THREADS)
gram_partial_kernel(const float* __restrict__ h, const float* __restrict__ r,
                    const int* __restrict__ block_tuple,
                    float* __restrict__ partial, int nblocks, int G) {
  extern __shared__ float tile[];  // G rows of [h(28) | r | pad]
  const int b0 = blockIdx.x * SPAN;
  const int b1 = min(b0 + SPAN, nblocks);
  const int t = threadIdx.x;
  const bool owner = t < NOUT;
  const int i = t / DE;
  const int j = t - i * DE;
  float acc = 0.f;
  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous tile has been read
    const float* hb = h + (size_t)b * G * D;
    for (int e = t; e < G * D; e += blockDim.x) {
      const int g = e / D;
      tile[g * ROW + (e - g * D)] = hb[e];
    }
    for (int g = t; g < G; g += blockDim.x) tile[g * ROW + D] = r[(size_t)b * G + g];
    __syncthreads();
    if (owner) {
      float s = 0.f;
      for (int g = 0; g < G; ++g) s = fmaf(tile[g * ROW + i], tile[g * ROW + j], s);
      acc += s;
    }
    const bool seg_end = (b == b1 - 1) || (block_tuple[b + 1] != block_tuple[b]);
    if (seg_end) {
      if (owner) partial[(size_t)b * NOUT + t] = acc;
      acc = 0.f;
    }
  }
}

__device__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(P2_THREADS)
gram_combine_kernel(const float* __restrict__ partial,
                    const int* __restrict__ block_tuple,
                    float* __restrict__ gram, float* __restrict__ jtr,
                    int nblocks) {
  __shared__ int run[2];
  const int tup = blockIdx.x;
  if (threadIdx.x == 0) {
    run[0] = lower_bound(block_tuple, nblocks, tup);
    run[1] = lower_bound(block_tuple, nblocks, tup + 1);
  }
  __syncthreads();
  const int lo = run[0], hi = run[1];
  for (int e = threadIdx.x; e < NOUT; e += blockDim.x) {
    float acc = 0.f;
    if (lo < hi) {
      // Segment rows: every span end inside the run, then the run's end.
      for (int b = (lo / SPAN) * SPAN + SPAN - 1; b < hi - 1; b += SPAN)
        acc += partial[(size_t)b * NOUT + e];
      acc += partial[(size_t)(hi - 1) * NOUT + e];
    }
    const int i = e / DE;
    const int j = e - i * DE;
    if (j < D) gram[((size_t)tup * D + i) * D + j] = acc;
    else jtr[(size_t)tup * D + i] = acc;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success) of the two launches.  `partial`
// holds nblocks x 812 floats of scratch.
int tuple_gram_launch(const float* h, const float* r, const int* block_tuple,
                      float* partial, float* gram, float* jtr, int nblocks,
                      int G, int tuple_cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = G * ROW * (int)sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int grid1 = (nblocks + SPAN - 1) / SPAN;
  if (grid1 > 0) {
    gram_partial_kernel<<<grid1, P1_THREADS, smem, s>>>(h, r, block_tuple, partial,
                                                        nblocks, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gram_combine_kernel<<<tuple_cap, P2_THREADS, 0, s>>>(partial, block_tuple, gram, jtr,
                                                       nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
