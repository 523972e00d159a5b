// Fixed-order segmented sum of the assembly, by hand for Hopper.
//
// Replaces PyTorch's index_add_ (float atomics, an order that changes from
// run to run) in the port's assembly: the pair reduction and the graph-term
// pair rows (core/assembly.py:reduce_pairs, core/losses.py), the ARAP J^T r
// rows and the dense solvers' graph-term blocks (core/losses.py), and the
// node radii at frame 0 (core/graph.py).  It has no TPU kernel behind it:
// the JAX package sums these in a fixed order by one-hot matmul
// (super_tpu/core/assembly.py:segment_sum_matmul) or by XLA scatter-add.
//
//   out[s, f] = base[s, f] + sum over rows i with seg[i] == s of values[i, f]
//
// for s in [0, S), f in [0, F).  The rows come through a stable order of the
// rows by segment (order (R,)) and each segment's first position in it
// (offsets (S + 1,)), both made once a frame by the caller
// (kernels/segsum.py:segment_plan); rows whose segment lies outside [0, S)
// sit before offsets[0] or after offsets[S] and are left out.  Optionally
// each value is rounded to bf16 first (the sum stays f32).
//
// Bound on this card: the values, order, offsets, base and out each move
// once (the headline's pair reduction: 40,960 rows of 49 floats, 8 MB,
// ~2.5 us of HBM traffic); one add an entry, far below the f32 rate.
//
// Design.  A segment's rows are added in ascending sorted position, which
// is ascending source row within the segment.  One thread owns one
// (segment, column) output and walks its rows, so F threads read each row
// whole and coalesced.  A segment longer than 2 L rows (the pair table's
// sink collects ~23,000 rows on the headline) would make one thread walk
// them all; so a first kernel sums every aligned chunk of L sorted positions
// (one thread a (chunk, column)), and the second adds, for a long segment,
// its head rows, then the totals of the chunks it covers whole, then its
// tail rows, each part in ascending order.  Which order a segment takes
// depends only on its offsets: no float atomics, the same bits from launch
// to launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;        // sorted positions a chunk
constexpr int NT = 256;      // threads a CTA
constexpr int UNROLL = 8;    // loads in flight a thread

struct Args {
  const float* __restrict__ values;  // (R, F)
  const int* __restrict__ order;     // (R,)
  const int* __restrict__ offsets;   // (S + 1,)
  const float* __restrict__ base;    // (S, F) or null
  float* __restrict__ out;           // (S, F)
  float* __restrict__ chunks;        // (ceil(R / L), F)
  int R, S, F, round_bf16;
};

__device__ __forceinline__ float value(const Args& a, int pos, int f) {
  const float v = a.values[(long long)a.order[pos] * a.F + f];
  return a.round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc plus the rows at sorted positions [p0, p1), in ascending order; the
// loads of UNROLL rows are issued before their adds.
__device__ __forceinline__ float add_rows(const Args& a, float acc, int p0, int p1, int f) {
  int p = p0;
  for (; p + UNROLL <= p1; p += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) v[k] = value(a, p + k, f);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) acc += v[k];
  }
  for (; p < p1; ++p) acc += value(a, p, f);
  return acc;
}

__global__ void __launch_bounds__(NT) chunk_totals(Args a) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  const long long nc = (a.R + L - 1) / L;
  if (t >= nc * a.F) return;
  const int c = (int)(t / a.F), f = (int)(t % a.F);
  const int p0 = c * L, p1 = min(p0 + L, a.R);
  a.chunks[t] = add_rows(a, 0.0f, p0, p1, f);
}

__global__ void __launch_bounds__(NT) segment_totals(Args a) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)a.S * a.F) return;
  const int s = (int)(t / a.F), f = (int)(t % a.F);
  const int p0 = a.offsets[s], p1 = a.offsets[s + 1];
  float acc = a.base ? a.base[t] : 0.0f;
  if (p1 - p0 <= 2 * L) {
    acc = add_rows(a, acc, p0, p1, f);
  } else {
    const int c0 = (p0 + L - 1) / L, c1 = p1 / L;   // chunks covered whole
    acc = add_rows(a, acc, p0, c0 * L, f);
    int c = c0;
    for (; c + UNROLL <= c1; c += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v[k] = a.chunks[(long long)(c + k) * a.F + f];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) acc += v[k];
    }
    for (; c < c1; ++c) acc += a.chunks[(long long)c * a.F + f];
    acc = add_rows(a, acc, c1 * L, p1, f);
  }
  a.out[t] = acc;
}

int blocks(long long threads) { return (int)((threads + NT - 1) / NT); }

}  // namespace

extern "C" {

// out = base (or 0) + the segment sums.  Returns a cudaError_t code (0 on
// success).  R >= 1, S >= 1, F >= 1; base may be null; chunks holds
// ceil(R / 64) * F floats (L = 64); out must not overlap values or chunks.
int segment_sum_launch(const float* values, const int* order, const int* offsets,
                       const float* base, float* out, float* chunks, int R, int S, int F,
                       int round_bf16, void* stream) {
  const Args a{values, order, offsets, base, out, chunks, R, S, F, round_bf16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nc = (R + L - 1) / L;
  chunk_totals<<<blocks(nc * F), NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_totals<<<blocks((long long)S * F), NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
