// Plain conjugate gradients on a dense symmetric matrix, by hand for Hopper.
//
// Replaces super_tpu/pallas_kernels/pcg.py:_pcg_kernel (entry pcg_pallas),
// the solve of linear_solver="pcg_pallas": the LM's damped normal matrix,
// block-preconditioned before the call (A-hat = L^-1 A L^-T, unit diagonal
// blocks), so the kernel runs CG from x0 = 0 with no preconditioner, for a
// fixed number of iterations, alpha and beta guarded by |.| > 1e-30.
//
// Bound on this card: one read of the matrix (n^2 f32: 28.9 MB at n = 2688,
// J = 384; 290 MB at the dense graph's n = 8512).  Everything after that
// read is latency: 32 iterations, each a matvec and two dot products over
// the whole grid.
//
// Design.  One cooperative launch, one 512-thread CTA per SM, each owning a
// contiguous range of rows; the system is taken at its own n (any n).
// - One pass over the matrix.  The CTA reads its rows as one sequence of
//   16-byte chunks (scalar loads where rows are not 16-byte aligned), in
//   tiles of 8 chunks a thread, and keeps the chunks that are not all +-0
//   in shared memory as (float4, chunk index), in row order and ascending
//   column order, their places found by a scan of each tile.  The matrix is
//   the LM's 7 x 7 node blocks, ~93% exact zeros (~50 of a row's 672 chunks
//   at J = 384), so a CTA's rows take ~21 KB; a NaN or Inf chunk is kept.
//   The rows past the store's capacity are read from global memory on every
//   iteration (the overflow route, the same chunks, zeros skipped alike), so
//   a fully dense matrix is solved right, more slowly.
// - One grid barrier an iteration.  Each CTA writes its rows of A p to a
//   double-buffered exchange (buffer it % 2); after grid.sync() every CTA
//   loads all of A p from L2 and, against its own full copy of p, sums p.Ap
//   over all n in one fixed order, so every CTA holds the same alpha,
//   bitwise; it updates its own full copy of r in shared memory, sums r.r
//   in the same order (the same beta everywhere) and rebuilds its full copy
//   of p.  x is kept for the CTA's own rows.  A CTA overwrites buffer k % 2
//   only after barrier k + 1, which every reader of iteration k has
//   reached.
// No float atomics: the result is the same from run to run on a card with
// the same number of SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SMEM_MAX = 232448;  // one CTA's shared memory on Hopper
constexpr int CHUNK_BYTES = sizeof(float4) + sizeof(int);
constexpr int U = 8;            // chunks a thread loads per tile of the pass
constexpr int TILE = U * NT;    // chunks per tile
constexpr int SCAN = U * NW;    // warp counts per tile, 4 per lane of warp 0
constexpr int AP_BATCH = 16;    // entries of A p a thread loads per round
constexpr int UNSET = INT_MAX;

// Shared memory of a CTA at dim n on nb CTAs: p and r (4 ceil(n/4) floats
// each), the chunk store (values, then chunk indices), per row x, the
// row's start in the store and its chunk count (-1: overflow route), two
// buffers of NW floats for sums, and two of the pass's SCAN counts and
// total.
struct Layout {
  int n4, rows_max, chunks;
  long long fixed, bytes;
};

Layout layout(int n, int nb) {
  Layout l;
  l.n4 = (n + 3) / 4;
  l.rows_max = (n + nb - 1) / nb;
  l.fixed = 32LL * l.n4 + 12LL * l.rows_max + 8LL * NW + 8LL * (SCAN + 1);
  const long long room = SMEM_MAX - l.fixed;
  const long long dense = (long long)l.rows_max * l.n4;
  l.chunks = room <= 0 ? 0 : (int)(dense < room / CHUNK_BYTES ? dense : room / CHUNK_BYTES);
  l.bytes = l.fixed + (long long)l.chunks * CHUNK_BYTES;
  return l;
}

__device__ __forceinline__ bool nonzero(float4 v) {
  return ((__float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
           __float_as_uint(v.w)) & 0x7fffffffu) != 0u;
}

// Columns 4q .. 4q+3 of a row, zero past n.
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ row, int q, int n,
                                             bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(row) + q);
  const int c = 4 * q;
  return make_float4(__ldg(row + c), c + 1 < n ? __ldg(row + c + 1) : 0.f,
                     c + 2 < n ? __ldg(row + c + 2) : 0.f,
                     c + 3 < n ? __ldg(row + c + 3) : 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Every lane returns the same sum, added in one fixed tree.
__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// The CTA's sum of every thread's s, in one fixed order: every thread of
// every CTA returns the same value for the same terms.  The caller syncs
// the CTA before red is written again.
__device__ float block_total(float s, float* red) {
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < NW; ++w) tot += red[w];
  return tot;
}

__global__ void __launch_bounds__(NT, 1)
dense_cg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ x, float* ap_x, int* stats, int n,
                int iterations, int chunks, int aligned_rows) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = gridDim.x;
  const int n4 = (n + 3) / 4;
  const int rows_max = (n + nb - 1) / nb;
  const int row0 = (int)((long long)n * blockIdx.x / nb);
  const int rows = (int)((long long)n * (blockIdx.x + 1) / nb) - row0;
  const bool aligned = aligned_rows != 0;
  float* p = reinterpret_cast<float*>(smem);
  float* r = p + 4 * n4;
  float4* vals = reinterpret_cast<float4*>(r + 4 * n4);
  int* cols = reinterpret_cast<int*>(vals + chunks);
  float* x_own = reinterpret_cast<float*>(cols + chunks);
  int* row_start = reinterpret_cast<int*>(x_own + rows_max);
  int* row_cnt = row_start + rows_max;
  float* red_pap = reinterpret_cast<float*>(row_cnt + rows_max);
  float* red_rr = red_pap + NW;
  int* scan = reinterpret_cast<int*>(red_rr + NW);  // 2 x (SCAN + 1)
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;

  for (int e = threadIdx.x; e < 4 * n4; e += NT) {
    const float v = e < n ? b[e] : 0.f;
    p[e] = v;
    r[e] = v;
  }
  for (int i = threadIdx.x; i < rows; i += NT) {
    x_own[i] = 0.f;
    row_start[i] = UNSET;
  }

  // The pass.  Chunk c of the CTA's rows is chunk c % n4 of row c / n4; in
  // a tile, thread t loads chunks t, t + NT, ...  A chunk's place in the
  // store is the number of nonzero chunks before it: the tile's base, the
  // counts of the tile's earlier (u, warp) groups, the lanes below it.
  const int total = rows * n4;
  const float4* rows4 = reinterpret_cast<const float4*>(a + (size_t)row0 * n);
  int base = 0, t0 = 0;
  for (int tile = 0; t0 < total && base < chunks; ++tile, t0 += TILE) {
    int* cnt = scan + (tile & 1) * (SCAN + 1);
    float4 v[U];
    unsigned m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = t0 + u * NT + threadIdx.x;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < total) {
        if (aligned) {
          v[u] = __ldg(rows4 + c);
        } else {
          const int i = c / n4;
          v[u] = load_chunk(a + (size_t)(row0 + i) * n, c - i * n4, n, false);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      m[u] = __ballot_sync(FULL, nonzero(v[u]));
      if (lane == 0) cnt[u * NW + warp] = __popc(m[u]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the SCAN counts, in (u, warp) order
      int e[SCAN / 32], s = 0;
#pragma unroll
      for (int k = 0; k < SCAN / 32; ++k) {
        e[k] = cnt[(SCAN / 32) * lane + k];
        s += e[k];
      }
      int incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int ex = incl - s;
#pragma unroll
      for (int k = 0; k < SCAN / 32; ++k) {
        cnt[(SCAN / 32) * lane + k] = ex;
        ex += e[k];
      }
      if (lane == 31) cnt[SCAN] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = t0 + u * NT + threadIdx.x;
      const int pos = base + cnt[u * NW + warp] + __popc(m[u] & below);
      const int i = c / n4, q = c - i * n4;
      if (((m[u] >> lane) & 1u) && pos < chunks) {
        vals[pos] = v[u];
        cols[pos] = q;
      }
      if (c < total && q == 0) row_start[i] = pos;
    }
    base += cnt[SCAN];
  }
  __syncthreads();
  // A row is kept if it was read to its end within the store.
  for (int i = threadIdx.x; i < rows; i += NT) {
    const int st = row_start[i];
    const int en = i + 1 < rows ? row_start[i + 1] : (t0 >= total ? base : UNSET);
    row_cnt[i] = st != UNSET && en != UNSET && en <= chunks ? en - st : -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int kept = 0, spilled = 0;
    for (int i = 0; i < rows; ++i) {
      if (row_cnt[i] < 0) ++spilled;
      else kept += row_cnt[i];
    }
    stats[2 * blockIdx.x] = kept;
    stats[2 * blockIdx.x + 1] = spilled;
  }
  float rz = 0.f;
  for (int e = threadIdx.x; e < n; e += NT) rz = fmaf(r[e], r[e], rz);
  rz = block_total(rz, red_rr);

  // Rows are dealt to warps in turn: the overflow route's rows, which
  // close the CTA's range, fall to different warps.
  const bool one_batch = n <= AP_BATCH * NT;
  for (int it = 0; it < iterations; ++it) {
    float* ap_g = ap_x + (it & 1) * n;
    for (int i = warp; i < rows; i += NW) {
      float s = 0.f;
      const int cnt = row_cnt[i];
      if (cnt >= 0) {
        const int st = row_start[i];
        for (int k = lane; k < cnt; k += 32) s = dot4(vals[st + k], p4[cols[st + k]], s);
      } else {
        const float* row = a + (size_t)(row0 + i) * n;
#pragma unroll 4
        for (int q = lane; q < n4; q += 32) {
          const float4 v = load_chunk(row, q, n, aligned);
          if (nonzero(v)) s = dot4(v, p4[q], s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) ap_g[row0 + i] = s;
    }
    grid.sync();
    // A p from L2, AP_BATCH entries a thread per round (one round at
    // n <= 8192), and p.Ap over all n.
    float apv[AP_BATCH];
    float s = 0.f;
    for (int e0 = 0; e0 < n; e0 += AP_BATCH * NT) {
#pragma unroll
      for (int u = 0; u < AP_BATCH; ++u) {
        const int e = e0 + threadIdx.x + u * NT;
        apv[u] = e < n ? __ldcg(ap_g + e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < AP_BATCH; ++u) {
        const int e = e0 + threadIdx.x + u * NT;
        if (e < n) s = fmaf(p[e], apv[u], s);
      }
    }
    const float pap = block_total(s, red_pap);
    const float alpha = fabsf(pap) > 1e-30f ? rz / pap : 0.f;
    for (int i = threadIdx.x; i < rows; i += NT) x_own[i] = fmaf(alpha, p[row0 + i], x_own[i]);
    s = 0.f;
    for (int e0 = 0; e0 < n; e0 += AP_BATCH * NT) {
      if (!one_batch) {
#pragma unroll
        for (int u = 0; u < AP_BATCH; ++u) {
          const int e = e0 + threadIdx.x + u * NT;
          apv[u] = e < n ? __ldcg(ap_g + e) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < AP_BATCH; ++u) {
        const int e = e0 + threadIdx.x + u * NT;
        if (e < n) {
          const float rn = fmaf(-alpha, apv[u], r[e]);
          r[e] = rn;
          s = fmaf(rn, rn, s);
        }
      }
    }
    const float rz_new = block_total(s, red_rr);
    const float beta = fabsf(rz) > 1e-30f ? rz_new / rz : 0.f;
    for (int e = threadIdx.x; e < n; e += NT) p[e] = fmaf(beta, p[e], r[e]);
    rz = rz_new;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows; i += NT) x[row0 + i] = x_own[i];
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

// Allows the kernel the whole of a CTA's shared memory and checks that one
// CTA of it fits an SM, once per process.
cudaError_t prepare() {
  static cudaError_t status = cudaErrorNotReady;
  if (status == cudaErrorNotReady) {
    status = cudaFuncSetAttribute(dense_cg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)SMEM_MAX);
    int per_sm = 0;
    if (status == cudaSuccess)
      status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_cg_kernel, NT,
                                                             (size_t)SMEM_MAX);
    if (status == cudaSuccess && per_sm < 1) status = cudaErrorCooperativeLaunchTooLarge;
  }
  return status;
}

}  // namespace

extern "C" {

// CTAs of the cooperative grid: one per SM.
int dense_cg_blocks() { return num_blocks(); }

// Shared memory a CTA needs at dim n before any chunk is kept: p, r and the
// per-row state.  Past 232,448 bytes (n ~ 28,000) the kernel cannot run.
long long dense_cg_smem_bytes(int n) { return layout(n, num_blocks()).fixed; }

// Chunks (16 bytes of a row and their index) one CTA keeps in shared memory
// at dim n; its rows past them are read from global memory on every
// iteration.
int dense_cg_chunk_capacity(int n) { return layout(n, num_blocks()).chunks; }

// Returns a cudaError_t code (0 on success).  a is (n, n) row-major and
// symmetric, its rows 16-byte aligned where aligned_rows is set (n % 4 == 0
// and a 16-byte aligned); ap_scratch holds 2 n floats, stats
// 2 dense_cg_blocks() ints: each CTA's chunks kept and rows on the overflow
// route.
int dense_cg_launch(const float* a, const float* b, float* x_out, float* ap_scratch, int* stats,
                    int n, int iterations, int aligned_rows, void* stream) {
  const int nb = num_blocks();
  const Layout l = layout(n, nb);
  if (l.fixed > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  int chunks = l.chunks;
  void* args[] = {(void*)&a,          (void*)&b, (void*)&x_out,      (void*)&ap_scratch,
                  (void*)&stats,      (void*)&n, (void*)&iterations, (void*)&chunks,
                  (void*)&aligned_rows};
  e = cudaLaunchCooperativeKernel((const void*)dense_cg_kernel, dim3(nb), dim3(NT), args,
                                  (size_t)l.bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
