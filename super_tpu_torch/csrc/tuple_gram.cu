// K2, the tuple-Gram reduction of the tuple-grouped JTJ assembly, by hand
// for Hopper: one kernel template with two row sources.
//
// Replaces super_tpu/pallas_kernels/gram.py:_gram_kernel.  For every tuple
// t, gram[t] = sum of h^T h (28 x 28) and jtr[t] = sum of h^T r (28) over
// the rows of the G-row blocks that the sorted block_tuple (Np / G) maps to
// t; tuples that no block visits are zero.  The rows come
//   - from memory (tuple_gram_launch): h (Np, 28) and r (Np,) in padded
//     slot order, the TPU kernel's own function;
//   - from the data term (data_gram_launch): each slot's point-to-plane
//     gradient row and residual against the frozen association, computed in
//     registers from the LM context (core/losses.py:data_rows, the JAX
//     package's frozen_chunk_partial_fm), so that h never reaches device
//     memory.  This instance also returns cost = sum of r^2, and skips the
//     blocks of the sink tuple T - 1, whose slots the layout masks
//     (core/assembly.py:build_tuple_layout); it writes the sink's zeros.
//
// Bound on this card (480 x 640 main path: Np = 720,896, G = 64, T = 4,096).
// From memory: 84 MB of rows read once and 13 MB of Grams written, ~29 us
// of HBM traffic; the 1.2 GFLOP of products take ~17 us of the f32 rate.
// From the data term: ~54 bytes of inputs per live slot and the 13 MB of
// Grams (30 MB in all on frame 1), and ~1,340 flops of row math and
// products per slot with both masks set (0.41 GFLOP): ~9 us.
//
// Design.
//   - One cooperative launch, as many CTAs as fit on the SMs together.  The
//     blocks [0, E) are split into one contiguous, equal range per CTA
//     (E = nb from memory; in the data instance E is the sink's first block,
//     found in block_tuple by two rounds of 256 samples).
//   - A CTA walks its range in tiles of up to 256 rows.  It loads a tile's
//     inputs into registers while it forms the previous tile's products,
//     stages the rows [h | r | 0] in shared memory (15 float2 a row; the
//     data instance computes one row a thread, and its float2 stores meet
//     no bank conflict), then 238 of its 256
//     threads accumulate the Gram's upper triangle and jtr column in
//     registers: each owns a 2 x 2 tile of the 28 x 30 product, over the
//     even or the odd rows of every block, and only the 119 tiles on or
//     above the diagonal are formed.  The data instance skips the products
//     of a block whose slots are all masked.  Several CTAs share an SM, so one
//     CTA's loads and row math overlap another's products.
//   - At each tuple boundary the even and odd sums are added and the tuple
//     is written once, mirrored, so that each Gram is bitwise symmetric.  A
//     tuple whose run crosses a range boundary writes its part to scratch
//     (two slots a CTA); after one grid barrier every CTA the run touches
//     finds the run's ends in block_tuple and adds a share of its entries
//     over the parts, in CTA order.  The tuple of the inactive surfels
//     (all masked) and, from memory, the sink make runs of thousands of
//     blocks: their parts, and the work of adding them, spread over ~100
//     CTAs each.
//   - The cost: a sum per thread, a fixed tree per CTA, the CTAs' sums
//     added in CTA order after the barrier.
//   - Tuples that no block visits are zero: the CTA holding the block after
//     a gap writes it, and the gap before the sink (the unused capacity,
//     thousands of tuples) and the sink where it is skipped are shared out
//     among all CTAs.
// No float atomics, and every sum has one fixed order: the same result bit
// for bit from launch to launch on one card.  Tuple ids outside [0, T) are
// never written, and node ids are clamped into [0, J).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 28;             // gradient width: 4 anchors x 7
constexpr int GRAM = D * D;       // 784
constexpr int NOUT = GRAM + D;    // a tuple's outputs: its Gram, then jtr
constexpr int NT = 256;           // threads a CTA, rows a tile
constexpr int ROW2 = 15;          // a staged row in float2: h (28), r, 0
constexpr int NTILE = 119;        // 2 x 2 tiles (ip <= jp < 15) of the 28 x 30 product
constexpr int ODD = 128;          // first thread of the odd rows
constexpr int MIN_G = 8;          // so that a tile holds at most 32 G-blocks
constexpr int MAX_TB = NT / MIN_G;
constexpr int NCONST = 40;        // a block's tuple: beta of its 4 anchors, their 12 coordinates

struct Args {
  const int* bt;    // (nb,) sorted tuple id of each G-block
  float* gram;      // (T, 28, 28)
  float* jtr;       // (T, 28)
  float* scratch;   // CTAs x (2 NOUT + 1)
  int nb, G, T;
};

struct Memory {
  static constexpr bool kData = false;
  const float* h;   // (Np, 28)
  const float* r;   // (Np,)
};

struct Data {
  static constexpr bool kData = true;
  const float* points;     // (3, Np)
  const float* knn_w;      // (4, Np)
  const uint8_t* sf_mask;  // (Np,)
  const float* tuple_knn;  // (12, T): anchor a's coordinate i in row 3 a + i
  const int* tuple_nodes;  // (T, 4), element strides nodes_st, nodes_sa
  const float* o;          // (3, Np)
  const float* n;          // (3, Np)
  const uint8_t* amask;    // (Np,)
  const float* beta;       // (J, 7)
  float* cost;             // ()
  float weight;
  int J, nodes_st, nodes_sa;
};

struct Smem {
  float2 rows[NT * ROW2];
  float stage[NOUT];
  float4 odd[NTILE];
  float cst[MAX_TB * NCONST];
  int tup[MAX_TB];
  int live[MAX_TB];
  float wsum[NT / 32];
};

// CTA c's blocks are [range_start(c), range_start(c + 1)); cta_of(b) is the
// CTA whose range holds block b < E.
__device__ __forceinline__ int range_start(int E, int c, int N) {
  return (int)((long long)E * c / N);
}

__device__ __forceinline__ int cta_of(int b, int E, int N) {
  return (int)(((long long)(b + 1) * N + E - 1) / E) - 1;
}

// First block of [lo, hi) whose tuple is not below lim (hi if none):
// block_tuple is sorted, so NT samples bracket it, and each further round
// narrows the bracket NT-fold.
__device__ int first_not_below(const int* bt, int lo, int hi, int lim) {
  while (lo < hi) {  // blocks before lo are below lim, from hi on not
    const int step = (hi - lo + NT - 1) / NT;
    const int pos = lo + (int)threadIdx.x * step;
    const int cnt = __syncthreads_count(pos < hi && bt[pos] < lim);
    if (step == 1) return lo + cnt;
    const int nlo = cnt == 0 ? lo : lo + (cnt - 1) * step + 1;
    hi = min(hi, lo + cnt * step);
    lo = nlo;
  }
  return lo;
}

// First block of tuple t's run, which holds block b: the NT blocks before b
// first, most runs being short.
__device__ int run_start(const int* bt, int b, int t) {
  const int w0 = max(b - NT, 0);
  const int r = first_not_below(bt, w0, b, t);
  return r == w0 && w0 > 0 ? first_not_below(bt, 0, w0, t) : r;
}

// First block after tuple t's run, which holds block b (blocks from E on
// are not read).
__device__ int run_end(const int* bt, int b, int E, int t) {
  const int w1 = min(b + 1 + NT, E);
  const int r = first_not_below(bt, b + 1, w1, t + 1);
  return r == w1 && w1 < E ? first_not_below(bt, w1, E, t + 1) : r;
}

__device__ void write_out(const float* v, float* g, float* j) {
  for (int e = threadIdx.x; e < NOUT; e += NT) {
    if (e < GRAM) g[e] = v[e];
    else j[e - GRAM] = v[e];
  }
}

__device__ void write_zero(const Args& a, int t) {
  for (int e = threadIdx.x; e < NOUT; e += NT) {
    if (e < GRAM) a.gram[(size_t)t * GRAM + e] = 0.f;
    else a.jtr[(size_t)t * D + e - GRAM] = 0.f;
  }
}

// Entry (i, j) of the 28 x 30 product into the staged tuple: the upper
// triangle mirrored, column 28 (h^T r) into jtr, column 29 (zeros) dropped.
__device__ __forceinline__ void put(float* s, int i, int j, float v) {
  if (j < D) {
    if (i <= j) {
      s[i * D + j] = v;
      s[j * D + i] = v;
    }
  } else if (j == D) {
    s[GRAM + i] = v;
  }
}

// A tile's rows, loaded into registers (load_rows) one tile ahead of the
// products, then written to shared memory (store_rows).  From memory: this
// thread's 16-byte words of h, and r.
struct MemoryRows {
  float4 h[7];
  float r;
};

__device__ __forceinline__ MemoryRows load_rows(const Memory& src, int nb, int tb, int nblk,
                                                int G) {
  MemoryRows in;
  const int nrow = nblk * G;
  const size_t s0 = (size_t)tb * G;
  const float4* h4 = reinterpret_cast<const float4*>(src.h + s0 * D);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int e = threadIdx.x + k * NT;
    in.h[k] = e < nrow * 7 ? h4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  in.r = (int)threadIdx.x < nrow ? src.r[s0 + threadIdx.x] : 0.f;
  return in;
}

__device__ __forceinline__ float store_rows(const Memory& src, Smem& sm, const MemoryRows& in,
                                            int nblk, int G) {
  const int nrow = nblk * G;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int e = threadIdx.x + k * NT;
    if (e < nrow * 7) {
      const int s = e / 7, p = e - 7 * s;
      sm.rows[s * ROW2 + 2 * p] = make_float2(in.h[k].x, in.h[k].y);
      sm.rows[s * ROW2 + 2 * p + 1] = make_float2(in.h[k].z, in.h[k].w);
    }
  }
  if ((int)threadIdx.x < nrow) sm.rows[threadIdx.x * ROW2 + 14] = make_float2(in.r, 0.f);
  return 0.f;
}

// From the data term, one slot a thread: its masks, point, normal, target
// point and anchor weights, loaded at once (not behind the masks: one round
// trip).
struct DataRows {
  bool live;
  float p[3], n[3], o[3], w[4];
};

__device__ __forceinline__ DataRows load_rows(const Data& src, int nb, int tb, int nblk, int G) {
  DataRows in;
  const int tid = threadIdx.x;
  const size_t np = (size_t)nb * G;
  const size_t s = (size_t)tb * G + tid;
  in.live = false;
  if (tid < nblk * G) {
    in.live = src.sf_mask[s] && src.amask[s];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      in.p[i] = src.points[i * np + s];
      in.n[i] = src.n[i * np + s];
      in.o[i] = src.o[i * np + s];
    }
#pragma unroll
    for (int an = 0; an < 4; ++an) in.w[an] = src.knn_w[an * np + s];
  }
  return in;
}

// The slot's blended warp and gradient row, as core/losses.py computes them
// (_warp_fm_batched, _frozen_residual, _rows_fm_batched) with the 4 anchors
// unrolled: columns anchor-major [w ndqw, w ndqv (3), w n (3)], the weight
// applied, a masked slot zero.  Returns the slot's r^2.
__device__ __forceinline__ float store_rows(const Data& src, Smem& sm, const DataRows& in,
                                            int nblk, int G) {
  const int tid = threadIdx.x;
  if (tid >= nblk * G) return 0.f;
  const int j = tid / G;
  float h[2 * ROW2];
#pragma unroll
  for (int q = 0; q < 2 * ROW2; ++q) h[q] = 0.f;
  float cost = 0.f;
  if (in.live) {
    const float* q = sm.cst + j * NCONST;
    const float wt = src.weight;
    const float px = in.p[0], py = in.p[1], pz = in.p[2];
    const float nx = in.n[0], ny = in.n[1], nz = in.n[2];
    float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll
    for (int an = 0; an < 4; ++an) {
      const float w = in.w[an];
      const float* b = q + 7 * an;
      const float* g = q + D + 3 * an;
      const float qw = b[0], qx = b[1], qy = b[2], qz = b[3];
      const float vx = px - g[0], vy = py - g[1], vz = pz - g[2];
      const float cx = qy * vz - qz * vy, cy = qz * vx - qx * vz, cz = qx * vy - qy * vx;
      const float dx = qy * cz - qz * cy, dy = qz * cx - qx * cz, dz = qx * cy - qy * cx;
      const float sx = w * (vx + 2.f * qw * cx + 2.f * dx + b[4] + g[0]);
      const float sy = w * (vy + 2.f * qw * cy + 2.f * dy + b[5] + g[1]);
      const float sz = w * (vz + 2.f * qw * cz + 2.f * dz + b[6] + g[2]);
      if (an == 0) {
        tx = sx; ty = sy; tz = sz;
      } else {
        tx += sx; ty += sy; tz += sz;
      }
      const float ndqw = 2.f * (nx * cx + ny * cy + nz * cz);
      const float qv_v = qx * vx + qy * vy + qz * vz;
      const float n_qv = nx * qx + ny * qy + nz * qz;
      const float n_v = nx * vx + ny * vy + nz * vz;
      const float ex = ny * vz - nz * vy, ey = nz * vx - nx * vz, ez = nx * vy - ny * vx;
      h[7 * an] = wt * (w * ndqw);
      h[7 * an + 1] = wt * (w * (2.f * (qv_v * nx + n_qv * vx - 2.f * n_v * qx - qw * ex)));
      h[7 * an + 2] = wt * (w * (2.f * (qv_v * ny + n_qv * vy - 2.f * n_v * qy - qw * ey)));
      h[7 * an + 3] = wt * (w * (2.f * (qv_v * nz + n_qv * vz - 2.f * n_v * qz - qw * ez)));
      h[7 * an + 4] = wt * (w * nx);
      h[7 * an + 5] = wt * (w * ny);
      h[7 * an + 6] = wt * (w * nz);
    }
    const float r = wt * (nx * (tx - in.o[0]) + ny * (ty - in.o[1]) + nz * (tz - in.o[2]));
    h[D] = r;
    cost = r * r;
    sm.live[j] = 1;
  }
#pragma unroll
  for (int q = 0; q < ROW2; ++q) sm.rows[tid * ROW2 + q] = make_float2(h[2 * q], h[2 * q + 1]);
  return cost;
}

// This thread's 2 x 2 tile of the product: rows 2 ip, 2 ip + 1, columns
// 2 jp, 2 jp + 1, over the even (odd = false) or the odd rows of a block.
struct Tile {
  bool odd, owner;
  int k, ip, jp;
};

// Close the segment of tuple t: add the odd rows' sums to the even rows',
// stage the tuple mirrored, and write it to its rows, or where its run
// crosses a range boundary (split) to CTA c's scratch slot: 0 for the
// range's first segment (nseg = 0), else 1.  A tuple id outside [0, T) is
// not written.  Zeroes acc.
__device__ void close_segment(Smem& sm, const Tile& w, float4& acc, const Args& a, int c, int t,
                              bool split, int nseg) {
  if (w.odd && w.owner) sm.odd[w.k] = acc;
  __syncthreads();
  if (!w.odd && w.owner) {
    const float4 o = sm.odd[w.k];
    put(sm.stage, 2 * w.ip, 2 * w.jp, acc.x + o.x);
    put(sm.stage, 2 * w.ip, 2 * w.jp + 1, acc.y + o.y);
    put(sm.stage, 2 * w.ip + 1, 2 * w.jp, acc.z + o.z);
    put(sm.stage, 2 * w.ip + 1, 2 * w.jp + 1, acc.w + o.w);
  }
  __syncthreads();
  if ((unsigned)t < (unsigned)a.T) {
    if (split) {
      float* part = a.scratch + ((size_t)c * 2 + (nseg == 0 ? 0 : 1)) * NOUT;
      write_out(sm.stage, part, part + GRAM);
    } else {
      write_out(sm.stage, a.gram + (size_t)t * GRAM, a.jtr + (size_t)t * D);
    }
  }
  acc = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Tuple t's run crosses the ranges of CTAs lo..hi, each of which wrote its
// part to scratch (CTA lo to slot lo_slot, the others to slot 0; a CTA
// with an empty range wrote zeros).  CTA x adds its share of the 812
// entries over the parts, in a fixed order: W lanes an entry take the
// parts in CTA order, W apart, then a fixed shuffle tree adds the lanes.
__device__ void combine_share(const Args& a, int t, int lo, int hi, int x, int lo_slot) {
  const int L = hi - lo + 1, i = x - lo;
  const int e0 = NOUT * i / L, S = NOUT * (i + 1) / L - e0;
  int W = 32;
  while (W > 1 && W * S > NT) W >>= 1;
  const int g = threadIdx.x / W, lane = threadIdx.x % W;
  for (int base = 0; base < S; base += NT / W) {
    const bool mine = base + g < S;
    const int e = e0 + base + g;
    float s = 0.f;
    if (mine) {
#pragma unroll 4
      for (int p = lane; p < L; p += W) {
        const size_t slot = p == 0 ? (size_t)lo * 2 + lo_slot : (size_t)(lo + p) * 2;
        s += __ldcg(a.scratch + slot * NOUT + e);
      }
    }
    for (int off = W / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off, W);
    if (mine && lane == 0 && (unsigned)t < (unsigned)a.T) {
      if (e < GRAM) a.gram[(size_t)t * GRAM + e] = s;
      else a.jtr[(size_t)t * D + e - GRAM] = s;
    }
  }
}

template <class Src>
__global__ void __launch_bounds__(NT, 3) gram_kernel(const Args a, const Src src) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, c = blockIdx.x, N = gridDim.x;
  const int G = a.G, T = a.T;
  const int* bt = a.bt;
  const int L = first_not_below(bt, 0, a.nb, T - 1);  // the sink's first block
  const int E = Src::kData ? L : a.nb;
  const int b0 = range_start(E, c, N), b1 = range_start(E, c + 1, N);

  // Tuples after the last one below the sink (the unused capacity), and the
  // sink where it has no blocks or they are skipped: zeros, shared out among
  // the CTAs.
  const int tend = Src::kData || L == a.nb ? T : T - 1;
  for (int t = (L > 0 ? max(bt[L - 1] + 1, 0) : 0) + c; t < tend; t += N) write_zero(a, t);
  // An empty range (E < N) has a zero part, which the combine may add.
  if (b0 == b1) {
    float* part = a.scratch + (size_t)c * 2 * NOUT;
    for (int e = tid; e < NOUT; e += NT) part[e] = 0.f;
  }

  Tile w;
  w.odd = tid >= ODD;
  w.k = w.odd ? tid - ODD : tid;
  w.owner = w.k < NTILE;
  w.ip = 0;
  int q = w.owner ? w.k : 0, n = 15;
  while (q >= n) {
    q -= n;
    ++w.ip;
    --n;
  }
  w.jp = w.ip + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float cost = 0.f;
  int cur = 0, nseg = 0;               // tuple of the open segment; segments closed
  bool open = false, before = false;   // a segment is open; its run began before b0

  const int TB = NT / G;
  auto in = load_rows(src, a.nb, b0, min(TB, b1 - b0), G);
  for (int tb = b0; tb < b1; tb += TB) {
    const int nblk = min(TB, b1 - tb);
    for (int e = tid; e < nblk; e += NT) {
      sm.tup[e] = bt[tb + e];
      sm.live[e] = Src::kData ? 0 : 1;
    }
    if constexpr (Src::kData) {
      for (int e = tid; e < nblk * NCONST; e += NT) {
        const int j = e / NCONST, q = e - j * NCONST;
        const int t = bt[tb + j];
        float v = 0.f;
        if ((unsigned)t < (unsigned)T) {
          if (q < D) {
            const int node = min(
                max(src.tuple_nodes[(size_t)t * src.nodes_st + (size_t)(q / 7) * src.nodes_sa], 0),
                src.J - 1);
            v = src.beta[(size_t)node * 7 + q % 7];
          } else {
            v = src.tuple_knn[(size_t)(q - D) * T + t];
          }
        }
        sm.cst[e] = v;
      }
    }
    __syncthreads();
    cost += store_rows(src, sm, in, nblk, G);
    if (tb + TB < b1) in = load_rows(src, a.nb, tb + TB, min(TB, b1 - tb - TB), G);
    __syncthreads();
    for (int j = 0; j < nblk; ++j) {
      const int t = sm.tup[j];
      if (!open || t != cur) {
        if (open) close_segment(sm, w, acc, a, c, cur, before, nseg++);
        const int prev = open ? cur : (b0 > 0 ? bt[b0 - 1] : -1);
        before = !open && b0 > 0 && prev == t;
        // Unvisited tuples before this block's; the gap before the sink
        // was shared out above.
        for (int z = max(prev + 1, 0); z < (tb + j < L ? min(t, T) : 0); ++z) write_zero(a, z);
        cur = t;
        open = true;
      }
      if (w.owner && sm.live[j]) {
        const float2* rows = sm.rows + j * G * ROW2;
#pragma unroll 4
        for (int g = w.odd ? 1 : 0; g < G; g += 2) {
          const float2 x = rows[g * ROW2 + w.ip];
          const float2 y = rows[g * ROW2 + w.jp];
          acc.x = fmaf(x.x, y.x, acc.x);
          acc.y = fmaf(x.x, y.y, acc.y);
          acc.z = fmaf(x.y, y.x, acc.z);
          acc.w = fmaf(x.y, y.y, acc.w);
        }
      }
    }
    __syncthreads();  // the tile's rows are read before the next tile's are staged
  }
  if (open) close_segment(sm, w, acc, a, c, cur, before || (b1 < E && bt[b1] == cur), nseg);

  if constexpr (Src::kData) {
    float v = cost;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((tid & 31) == 0) sm.wsum[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < NT / 32; ++i) s += sm.wsum[i];
      a.scratch[(size_t)N * 2 * NOUT + c] = s;
    }
  }

  grid.sync();

  // Runs that cross range boundaries: every CTA a run touches adds its
  // share of the run's entries.  A CTA takes part in the runs of its first
  // and its last block's tuples; one with an empty range in the run that
  // passes its position.
  if (b1 > b0) {
    const int tf = bt[b0], tl = bt[b1 - 1];
    const bool fb = b0 > 0 && bt[b0 - 1] == tf;   // tf's run began before b0
    const bool la = b1 < E && bt[b1] == tl;        // tl's run goes on after b1
    if (fb || (la && tf == tl)) {
      const int rs = fb ? run_start(bt, b0, tf) : b0;
      const int lo = cta_of(rs, E, N);
      const int hi = la && tf == tl ? cta_of(run_end(bt, b1, E, tl) - 1, E, N) : c;
      combine_share(a, tf, lo, hi, c, range_start(E, lo, N) >= rs ? 0 : 1);
    }
    if (la && tl != tf) combine_share(a, tl, c, cta_of(run_end(bt, b1, E, tl) - 1, E, N), c, 1);
  } else if (b0 > 0 && b0 < E && bt[b0 - 1] == bt[b0]) {
    const int t = bt[b0];
    const int rs = run_start(bt, b0, t), lo = cta_of(rs, E, N);
    combine_share(a, t, lo, cta_of(run_end(bt, b0, E, t) - 1, E, N), c,
                  range_start(E, lo, N) >= rs ? 0 : 1);
  }
  if constexpr (Src::kData) {
    if (c == 0 && tid < 32) {
      float s = 0.f;
      for (int cc = tid; cc < N; cc += 32) s += __ldcg(a.scratch + (size_t)N * 2 * NOUT + cc);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (tid == 0) *src.cost = s;
    }
  }
}

// A cooperative launch through cudaLaunchKernelEx with the cooperative
// attribute: the same launch as cudaLaunchCooperativeKernel, in the form
// that CUDA graph capture records as a cooperative kernel node
// (core/compiled.py captures the tracking step).
cudaError_t launch_cooperative(const void* kernel, dim3 grid, dim3 block, void** args,
                               size_t smem, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelExC(&config, kernel, args);
}

// CTAs of the cooperative grid: as many as fit on the SMs together, asked
// once per process and instance; 0 where the query fails.
template <class Src>
int ctas() {
  static int n = -1;
  if (n < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram_kernel<Src>, NT, 0);
    n = e == cudaSuccess ? sms * per_sm : 0;
  }
  return n;
}

template <class Src>
int launch(const Args& a, const Src& src, void* stream) {
  const int n = ctas<Src>();
  if (n <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (a.G < MIN_G || a.G > NT || a.T <= 0 || a.nb < 0) return (int)cudaErrorInvalidValue;
  void* params[] = {(void*)&a, (void*)&src};
  const cudaError_t e = launch_cooperative((const void*)gram_kernel<Src>, dim3(n), dim3(NT),
                                           params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch a launch needs: two parts of 812 and a cost a CTA.
// data = 0: tuple_gram_launch; 1: data_gram_launch.
long long tuple_gram_scratch_floats(int data) {
  const int n = data ? ctas<Data>() : ctas<Memory>();
  return (long long)n * (2 * NOUT + 1);
}

// Rows from memory.  Returns a cudaError_t code (0 on success).  h 16-byte
// aligned; 8 <= G <= 256.
int tuple_gram_launch(const float* h, const float* r, const int* block_tuple, float* gram,
                      float* jtr, float* scratch, int nb, int G, int T, void* stream) {
  const Args a{block_tuple, gram, jtr, scratch, nb, G, T};
  return launch(a, Memory{h, r}, stream);
}

// Rows from the data term; also writes cost = sum of r^2.  tuple_nodes is
// read through its element strides (the layout's is a transposed view).
// Returns a cudaError_t code (0 on success).  8 <= G <= 256.
int data_gram_launch(const float* points, const float* knn_w, const uint8_t* sf_mask,
                     const float* tuple_knn, const int* tuple_nodes, const int* block_tuple,
                     const float* o, const float* n, const uint8_t* amask, const float* beta,
                     float* gram, float* jtr, float* cost, float* scratch, float weight, int nb,
                     int G, int T, int J, int nodes_st, int nodes_sa, void* stream) {
  const Args a{block_tuple, gram, jtr, scratch, nb, G, T};
  const Data src{points, knn_w, sf_mask, tuple_knn, tuple_nodes, o, n, amask, beta, cost,
                 weight, J, nodes_st, nodes_sa};
  return launch(a, src, stream);
}

}  // extern "C"
