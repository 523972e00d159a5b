// Fixed-order segmented sum of the assembly, by hand for Hopper.
//
// Replaces PyTorch's index_add_ (float atomics, an order that changes from
// run to run) in the port's assembly: the pair reduction and the graph-term
// pair rows (core/assembly.py:reduce_pairs, core/losses.py), the ARAP J^T r
// rows and the dense solvers' graph-term blocks (core/losses.py), and the
// node radii at frame 0 (core/graph.py); on the autograd path the backward
// pass of segment_gather and the soft splat's pixel sums (segment_reduce).
// It has no TPU kernel behind it: the JAX package sums these in a fixed
// order by one-hot matmul (super_tpu/core/assembly.py:segment_sum_matmul)
// or by XLA scatter-add.
//
//   out[s, f] = base[s, f] (or 0) + sum of values[order[p], f]
//               over p in [offsets[s], offsets[s + 1])
//
// for s in [0, S), f in [0, F).  order (R,) is a stable order of the rows
// by segment and offsets (S + 1,) each segment's first position in it
// (kernels/segsum.py:segment_plan); rows whose segment lies outside [0, S)
// sit before offsets[0] or after offsets[S] and are left out.  Optionally
// each value is rounded to bf16 first (the sum stays f32).
//
// Bound on this card: the rows, order, offsets, base and out each move
// once, and one add an entry is far below the f32 rate.  The headline's
// pair rows (40,960 x 49) are 9.0 MB, 2.7 us of HBM traffic; the soft
// splat's pixel sums (2,097,152 x 4 into 307,201) 48 MB, 14 us; the dense
// solvers' blocks, most of whose 1,032,192 segments are empty and copy
// base to out, 63 MB, 19 us.  The rows are gathered by order, 16 to 196
// bytes each, so the sectors read exceed the bytes used (the splat's
// 16-byte rows take a 32-byte sector each).  Neither the tensor cores nor
// TMA serve the sum: it is one add an entry, and TMA copies boxes of
// contiguous memory, not rows gathered by an index.
//
// Design: one launch, each row read once, no serial chain longer than a
// tile.
// - Tiles of TR sorted positions, [t TR, (t + 1) TR), each summing its rows
//   in [offsets[0], offsets[S]); TR = 16 G for G groups of 16 rows, chosen
//   by the caller (kernels/segsum.py:tile_rows): as many groups as one
//   pass of a CTA's 256 threads covers at the width (at most 32, ~4,096
//   entries), or, for wide rows whose tiles outnumber a wave of CTAs,
//   twice that, summed in two halves (the dense graph's 97,280 pair rows
//   of width 49: 608 tiles of 160 rows, one a CTA, where 80-row tiles took
//   two a CTA in turn).  Rows wider than 64 floats are cut into slabs of 64
//   columns; a unit of work is one tile of one slab.  Persistent CTAs (at
//   least 5 an SM) walk their units in a two-stage ring, two instances of
//   one template: with one part a unit, the next unit is in flight while a
//   unit is summed; with two, the stages are the unit's halves, and each
//   half of the next unit is gathered as soon as its buffer is summed.
// - A unit stages its slice of order in shared memory (coalesced loads,
//   which need no offset), then gathers its rows into shared memory with
//   cp.async: a warp takes whole rows, its lanes consecutive 16-byte
//   chunks where the width is a multiple of 4 and the rows are aligned,
//   consecutive words otherwise.  While they are in flight it finds the
//   segment of its first row in offsets by a 256-ary search (none below a
//   few thousand segments) and, in one round over the offsets after it,
//   marks the first row of every segment that begins in the tile.  One
//   row in 17 of shared memory is padding, so the walk below meets no bank
//   conflict.
// - Level 1: a thread per (column, group) adds its 16 rows in order.  A
//   segment that begins and ends in the group is written; the group hands
//   on its rows before its first segment start (pre) and after its last
//   (tail).
// - Level 2: a slot of lanes per column (G rounded up to a power of 2, so
//   several columns share a warp) adds the groups' pre parts over each run
//   of groups by a segmented shuffle scan (a fixed tree), and a segment
//   that spans groups is its tail plus that run.  A segment that ends in
//   the tile is written.  A tile hands on at most two carries: the rows of
//   the segment it starts inside (head) and of the segment that runs on
//   past its end (tail), in a static (2 units, 64) scratch.
// - Level 3: a CTA queues its units' hand-offs and settles them together:
//   each takes a ticket on its segment's first unit, and the last of the
//   segment's tiles to arrive adds the carries in tile order, resetting
//   the counter to 0 for the next launch.  Up to 8 carries one thread a
//   column adds in order; more (the sinks: hundreds to thousands) the
//   CTA adds as chunks of 8, each a tree, dealt out to 256 / width parts a
//   column, each part's in order, the parts by a pairwise tree.
// - Empty segments get base (or 0), with 16-byte stores, from CTAs of their
//   own where the SMs hold them.
// Every association depends only on offsets, the width and the tile size,
// never on which CTA ran first: no float atomics, the same bits from launch
// to launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;       // threads a CTA
constexpr int NW = NT / 32;
constexpr int K = 16;         // rows a group: one thread's run in level 1
constexpr int GMAX = 32;      // groups a tile: one warp's lanes in level 2
constexpr int SLAB = 64;      // columns a unit at most
constexpr int LIGHT = 8;      // carries one thread adds alone in level 3
constexpr int MARK = 8;       // offsets a thread reads a round of prepare(), at most
constexpr int MIN_CTAS = 5;   // CTAs an SM at least (registers)
constexpr int QUEUE = 64;     // hand-offs a CTA queues before it settles them
constexpr unsigned FULL = 0xffffffffu;

int pow2_at_least(int g) {
  int w = 1;
  while (w < g) w <<= 1;
  return w;
}

struct Args {
  const float* __restrict__ values;  // (R, F)
  const int* __restrict__ order;     // (R,)
  const int* __restrict__ offsets;   // (S + 1,)
  const float* __restrict__ base;    // (S, F) or null
  float* __restrict__ out;           // (S, F)
  float* __restrict__ head_carry;    // (U, FC)
  float* __restrict__ tail_carry;    // (U, FC)
  int* __restrict__ tickets;         // (U,) 0 on entry and on exit
  int R, S, F, FC, G, W, TR, nslabs, U, mark, round_bf16, vec16;
};

// One unit in shared memory, written by thread 0 of its prepare().
struct Unit {
  int u, c0, fw;          // unit, its slab's first column and width
  int r0, r1;             // its rows [r0, r1) of the tile (none: r0 >= r1)
  int first_start, first_end;   // extent of row r0's segment
  int end_seg, end_end;   // the segment of row r1 - 1, its end
  int head_open;          // row r0 continues a segment begun in an earlier tile:
  int first_seg, head_unit, head_n;  // that segment, its first unit, its tiles
  int last_seg, last_n;   // the last segment begun here (-1: none), its tiles
};

// A segment handed on by a unit: its first unit (the ticket counter's), its
// tiles.
struct Job {
  int seg, unit, n;
};

// A CTA's hand-offs, settled together (settle()).
struct Queue {
  Job req[QUEUE];         // hand-offs of the CTA's units
  Job done[QUEUE];        // segments whose last tile the CTA holds
  int nreq, ndone;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared-memory row of tile row r: one padding row after every 16.
__device__ __forceinline__ int padded(int r) { return r + (r >> 4); }

// Dynamic shared memory: two buffers of a part's rows (b = 0, 1), then per
// unit parity (p = 0, 1) the order slice and the segment starts, the
// groups' pre and tail parts, and NT floats for the combines.  The places
// are computed where used, so that no pointer stays in a register.
extern __shared__ float4 smem4[];
template <int NH>
__device__ __forceinline__ float* smem_buf(const Args& a, int b) {
  return reinterpret_cast<float*>(smem4) + b * padded(a.TR / NH) * a.FC;
}
template <int NH>
__device__ __forceinline__ int* smem_idx(const Args& a, int p) {
  return reinterpret_cast<int*>(smem_buf<NH>(a, 2)) + p * a.TR;
}
template <int NH>
__device__ __forceinline__ int* smem_head(const Args& a, int p) {
  return smem_idx<NH>(a, 2) + p * padded(a.TR);
}
template <int NH>
__device__ __forceinline__ float* smem_pre(const Args& a) {
  return reinterpret_cast<float*>(smem_head<NH>(a, 2));
}
template <int NH>
__device__ __forceinline__ float* smem_tail(const Args& a) {
  return smem_pre<NH>(a) + a.G * a.FC;
}
template <int NH>
__device__ __forceinline__ float* smem_part(const Args& a) {
  return smem_tail<NH>(a) + a.G * a.FC;
}

// base[s, col], or 0 without base.
__device__ __forceinline__ float base_of(const Args& a, int s, int col) {
  return a.base ? a.base[(long long)s * a.F + col] : 0.f;
}

// out[s, col] = b + sum, b = base_of(a, s, col) (or sum without base).
__device__ __forceinline__ void put(const Args& a, int s, int col, float b, float sum) {
  a.out[(long long)s * a.F + col] = a.base ? b + sum : sum;
}

// Unit u's slice of order into shared memory (coalesced), and its
// segment-start marks cleared.  Every thread calls it.  It needs no offset,
// so its reads start with the kernel's.
__device__ void stage_order(const Args& a, int u, int* idx, int* head) {
  const int base = u / a.nslabs * a.TR;
  for (int r = threadIdx.x; r < a.TR; r += NT) {
    head[padded(r)] = -1;
    if (base + r < a.R) idx[r] = a.order[base + r];
  }
}

// Unit u's rows [w0, w1): its tile's sorted positions within [p0, p1).
__device__ __forceinline__ void window(const Args& a, int u, int p0, int p1, int& w0, int& w1) {
  const int base = u / a.nslabs * a.TR;
  w0 = max(base, p0);
  w1 = min(base + a.TR, p1);
}

// Unit u's first segment and segment starts, into shared memory, while its
// rows are in flight.  Every thread calls it.  Its global reads form two
// dependent steps: the search's rounds (none below mark NT segments) and
// one round over the unit's offsets.
__device__ void prepare(const Args& a, int p0, int p1, int u, Unit* un, int* head) {
  const int tid = threadIdx.x;
  const int t = u / a.nslabs, slab = u - t * a.nslabs, base = t * a.TR;
  int w0, w1;
  window(a, u, p0, p1, w0, w1);
  if (tid == 0) {
    un->u = u;
    un->c0 = slab * SLAB;
    un->fw = min(SLAB, a.F - slab * SLAB);
    un->r0 = w0 - base;
    un->r1 = w1 - base;
  }
  if (w0 >= w1) return;
  // Segment of row w0, the largest s with offsets[s] <= w0, lies in [lo,
  // hi): offsets[lo] <= w0 < offsets[hi] throughout.  The search stops
  // where one round below covers the rest.
  int lo = 0, hi = a.S;
  while (hi - lo > a.mark * NT) {
    const int step = (hi - lo + NT) / (NT + 1);
    const int p = lo + step * (tid + 1);
    const int c = __syncthreads_count(p < hi && a.offsets[p] <= w0);
    hi = min(hi, lo + (c + 1) * step);
    lo += c * step;
  }
  // Segments lo, lo + 1, ... whose rows begin before w1, mark NT a round:
  // each non-empty one with rows in the window marks its first row where
  // that lies in the window; the one holding row w0 gives its extent, the
  // one holding row w1 - 1 its end.
  for (int s0 = lo;; s0 += a.mark * NT) {
    int o[MARK], e[MARK];
#pragma unroll
    for (int k = 0; k < MARK; ++k) {
      const int s = s0 + k * NT + tid;
      o[k] = k < a.mark && s < a.S ? a.offsets[s] : w1;
      e[k] = k < a.mark && s < a.S ? a.offsets[s + 1] : w1;
    }
#pragma unroll
    for (int k = 0; k < MARK; ++k) {
      const int s = s0 + k * NT + tid;
      if (o[k] < w1 && e[k] > o[k] && e[k] > w0) {
        if (o[k] >= w0) head[padded(o[k] - base)] = s;
        else un->first_seg = s;
        if (o[k] <= w0) {
          un->first_start = o[k];
          un->first_end = e[k];
        }
        if (e[k] >= w1) {
          un->end_seg = s;
          un->end_end = e[k];
        }
      }
    }
    if (!__syncthreads_or(tid == NT - 1 && a.offsets[min(s0 + a.mark * NT - 1, a.S)] < w1))
      break;
  }
  if (tid == 0) {
    const int head_open = un->first_start < w0;
    un->head_open = head_open;
    if (head_open) {
      const int t0 = un->first_start / a.TR, t1 = (un->first_end - 1) / a.TR;
      un->head_unit = t0 * a.nslabs + slab;
      un->head_n = t1 - t0 + 1;
    }
    const int ls = un->end_seg == un->first_seg && head_open ? -1 : un->end_seg;
    un->last_seg = ls;
    un->last_n = ls < 0 ? 0 : (un->end_end - 1) / a.TR - t + 1;
  }
}

// Part h of unit u's rows (tile rows [h TR / NH, (h + 1) TR / NH)) into
// buf (cp.async, one commit group): a warp takes whole rows, its lanes
// consecutive words (16-byte chunks where vec16) of consecutive rows.
template <int NH>
__device__ void gather(const Args& a, int u, int h, int p0, int p1, const int* idx, float* buf) {
  const int t = u / a.nslabs, slab = u - t * a.nslabs, half = a.TR / NH;
  int w0, w1;
  window(a, u, p0, p1, w0, w1);
  const int r0 = max(w0 - t * a.TR, h * half), r1 = min(w1 - t * a.TR, (h + 1) * half);
  const int c0 = slab * SLAB, fw = min(SLAB, a.F - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = a.vec16 ? fw >> 2 : fw;        // copies a row
  const int rows = words < 32 ? 32 / words : 1;    // rows a warp a step
  const int r_lane = lane / words, wl = lane - r_lane * words;
  for (int r = r_lane < rows ? r0 + warp * rows + r_lane : r1; r < r1; r += NW * rows) {
    const float* src = a.values + (long long)idx[r] * a.F + c0;
    float* dst = buf + padded(r - h * half) * fw;
    if (a.vec16)
      for (int w = wl; w < words; w += 32) cp_async16(dst + 4 * w, src + 4 * w);
    else
      for (int w = wl; w < words; w += 32) cp_async4(dst + w, src + w);
  }
  cp_async_commit();
}

// Level 3: segment job.seg from the carries of its n tiles, in tile order:
// the tail carry of its first unit, then the head carries of the next.
// Column f of up to LIGHT carries: one thread adds them in order.
__device__ void finish_light(const Args& a, const Job& job, int f) {
  const float* tail = a.tail_carry + (long long)job.unit * a.FC;
  const float* head = a.head_carry + (long long)job.unit * a.FC;
  const long long step = (long long)a.nslabs * a.FC;
  const int col = (job.unit % a.nslabs) * SLAB + f;
  const float b = base_of(a, job.seg, col);
  float c[LIGHT];
#pragma unroll
  for (int j = 0; j < LIGHT; ++j)
    c[j] = j == 0 ? __ldcg(tail + f) : (j < job.n ? __ldcg(head + j * step + f) : 0.f);
  float acc = c[0];
#pragma unroll
  for (int j = 1; j < LIGHT; ++j)
    if (j < job.n) acc += c[j];
  put(a, job.seg, col, b, acc);
}

// More carries, by the whole CTA: they are cut into chunks of 8, each added
// as a tree; the chunks are dealt out to 256 / fw parts a column, each
// part's added in order, four chunks in flight; the parts by a pairwise
// tree in sm (NT floats).
__device__ void finish_heavy(const Args& a, const Job& job, float* sm) {
  const float* tail = a.tail_carry + (long long)job.unit * a.FC;
  const float* head = a.head_carry + (long long)job.unit * a.FC;
  const long long step = (long long)a.nslabs * a.FC;
  const int c0 = (job.unit % a.nslabs) * SLAB, fw = min(SLAB, a.F - c0);
  const int n = job.n, np = NT / fw, nch = (n + 7) / 8;
  const int f = threadIdx.x % fw, p = threadIdx.x / fw;
  float acc = 0.f;
  if (p < np) {
    for (int ch = p; ch < nch; ch += 4 * np) {
      float c[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = 8 * (ch + i * np) + k;
          c[i][k] = j >= n ? 0.f : (j == 0 ? __ldcg(tail + f) : __ldcg(head + j * step + f));
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (ch + i * np < nch)
          acc += ((c[i][0] + c[i][1]) + (c[i][2] + c[i][3])) +
                 ((c[i][4] + c[i][5]) + (c[i][6] + c[i][7]));
    }
    sm[p * fw + f] = acc;
  }
  __syncthreads();
  for (int w = 1; w < np; w <<= 1) {
    if (p < np && (p & (2 * w - 1)) == 0 && p + w < np) sm[p * fw + f] += sm[(p + w) * fw + f];
    __syncthreads();
  }
  if (p == 0) put(a, job.seg, c0 + f, base_of(a, job.seg, c0 + f), sm[f]);
  __syncthreads();
}

// Level 3 for the CTA's queued hand-offs: each takes a ticket on its
// segment's first unit; the last of a segment's tiles to arrive finishes
// it and resets the counter to 0.  Every thread calls it; a thread that
// wrote carries since the last settle() fences them first.
__device__ void settle(const Args& a, Queue* q, float* sm, bool& carried) {
  if (carried) __threadfence();
  carried = false;
  __syncthreads();
  if (threadIdx.x < q->nreq) {
    const Job r = q->req[threadIdx.x];
    if (atomicAdd(&a.tickets[r.unit], 1) == r.n - 1) {
      a.tickets[r.unit] = 0;
      q->done[atomicAdd(&q->ndone, 1)] = r;
    }
  }
  __threadfence();
  __syncthreads();
  const int nd = q->ndone;
  for (int it = threadIdx.x; it < nd * a.FC; it += NT) {
    const Job& job = q->done[it / a.FC];
    const int f = it % a.FC;
    if (job.n <= LIGHT && f < min(SLAB, a.F - (job.unit % a.nslabs) * SLAB))
      finish_light(a, job, f);
  }
  for (int d = 0; d < nd; ++d)
    if (q->done[d].n > LIGHT) finish_heavy(a, q->done[d], sm);
  __syncthreads();
  if (threadIdx.x == 0) q->nreq = q->ndone = 0;
}

// Level 1 on part h of a gathered unit (in buf): a thread per (column,
// group) adds the group's 16 rows in order.  Every thread calls it.
template <int NH>
__device__ void level1(const Args& a, const Unit& un, int h, const float* buf, const int* head,
                       float* pre, float* tail, int* gseg) {
  const int fw = un.fw, G = a.G, gh = G / NH;
  for (int it = threadIdx.x; it < gh * fw; it += NT) {
    const int g = h * gh + it / fw, f = it % fw;
    const int r0 = g * K, i0 = un.r0 - r0, i1 = un.r1 - r0;  // rows [i0, i1) of the group
    const float* col = buf + padded(r0 - h * gh * K) * fw + f;
    const int* hd = head + padded(r0);
    float acc = 0.f, first = 0.f, b = 0.f;   // b: base of seg, read at its start
    int seg = -1;
    for (int i = max(i0, 0); i < min(i1, K); ++i) {
      const int h = hd[i];
      if (h >= 0) {
        if (seg >= 0) put(a, seg, un.c0 + f, b, acc);
        else first = acc;
        seg = h;
        b = base_of(a, seg, un.c0 + f);
        acc = 0.f;
      }
      float v = col[i * fw];
      if (a.round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      acc += v;
    }
    pre[f * G + g] = seg >= 0 ? first : acc;
    tail[f * G + g] = acc;
    if (f == 0) gseg[g] = seg;
  }
}

// Level 2 on a unit whose groups are summed, and its hand-offs queued.
// Every thread calls it.
__device__ void level2(const Args& a, const Unit& un, const float* pre, const float* tail,
                       const int* gseg, Queue* q, bool& carried) {
  const int fw = un.fw, G = a.G;
  // A slot of W lanes (G rounded up to a power of 2) per column, 32 / W
  // columns a warp, over the groups.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = a.W, g = lane & (W - 1), slot = lane / W;
  const unsigned hm = __ballot_sync(FULL, lane < G && gseg[lane] >= 0);  // groups with a start
  const int seg = g < G ? gseg[g] : -1;
  const unsigned upto = (2u << g) - 1;           // groups <= g
  const unsigned starts = 1u | (hm << 1);        // a run of pre parts starts here
  const int rs = 31 - __clz(starts & upto);
  const unsigned above = hm & ~upto;
  const int e0 = hm ? __ffs(hm) - 1 : G - 1;     // where the tile's first run ends
  const int nx = above ? __ffs(above) - 1 : G - 1;  // where the run after g ends
  for (int f0 = warp * (32 / W); f0 < fw; f0 += NW * (32 / W)) {
    const int f = f0 + slot;
    const bool in = g < G && f < fw;
    const float b = in && seg >= 0 ? base_of(a, seg, un.c0 + f) : 0.f;
    float v = in ? pre[f * G + g] : 0.f;
    for (int d = 1; d < W; d <<= 1) {
      const float up = __shfl_up_sync(FULL, v, d, W);
      if (g - d >= rs) v = up + v;
    }
    const float run0 = __shfl_sync(FULL, v, e0, W);
    const float rest = __shfl_sync(FULL, v, nx, W);
    if (in && seg >= 0) {
      const float tv = tail[f * G + g];
      const float total = nx > g ? tv + rest : tv;
      if (above || un.last_n == 1) {
        put(a, seg, un.c0 + f, b, total);
      } else {
        a.tail_carry[(long long)un.u * a.FC + f] = total;
        carried = true;
      }
    }
    if (g == 0 && f < fw && un.head_open) {
      a.head_carry[(long long)un.u * a.FC + f] = run0;
      carried = true;
    }
  }
  // Hand-offs for level 3.
  if (threadIdx.x == 0) {
    if (un.head_open) q->req[q->nreq++] = Job{un.first_seg, un.head_unit, un.head_n};
    if (un.last_n > 1) q->req[q->nreq++] = Job{un.last_seg, un.u, un.last_n};
  }
}

// Empty segments: base (or 0), shared out over ctas CTAs, four entries of
// out a thread (16-byte loads and stores where out and base are aligned).
template <typename I>
__device__ void write_empty_as(const Args& a, int cta, int ctas) {
  const I total = (I)a.S * (I)a.F, stride = (I)ctas * NT;
  const I first = (I)cta * NT + threadIdx.x;
  const bool vec = (reinterpret_cast<uintptr_t>(a.out) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.base) & 15) == 0;
  const I nv = vec ? total / 4 : 0;
  for (I q = first; q < nv; q += stride) {
    const I e = 4 * q;
    int s = (int)(e / (I)a.F), col = (int)(e - (I)s * (I)a.F);
    bool empty[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col == a.F) {
        ++s;
        col = 0;
      }
      empty[k] = a.offsets[s] == a.offsets[s + 1];
      ++col;
    }
    if (!(empty[0] || empty[1] || empty[2] || empty[3])) continue;
    const float4 b = a.base ? *reinterpret_cast<const float4*>(a.base + e)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    if (empty[0] && empty[1] && empty[2] && empty[3]) {
      *reinterpret_cast<float4*>(a.out + e) = b;
    } else {
      if (empty[0]) a.out[e] = b.x;
      if (empty[1]) a.out[e + 1] = b.y;
      if (empty[2]) a.out[e + 2] = b.z;
      if (empty[3]) a.out[e + 3] = b.w;
    }
  }
  for (I e = 4 * nv + first; e < total; e += stride) {
    const int s = (int)(e / (I)a.F);
    if (a.offsets[s] == a.offsets[s + 1]) a.out[e] = a.base ? a.base[e] : 0.f;
  }
}

__device__ void write_empty(const Args& a, int cta, int ctas) {
  if ((long long)a.S * a.F < (1LL << 32)) write_empty_as<unsigned>(a, cta, ctas);
  else write_empty_as<unsigned long long>(a, cta, ctas);
}

// The units a CTA walks: blockIdx.x, then every gridDim.x-th, in a
// two-stage ring.  With one part a unit (NH = 1), the next unit is gathered
// into the other buffer while a unit is summed.  With two (NH = 2), the
// stages are the unit's halves: while one half is summed the other is in
// flight, and each half of the next unit is gathered into its buffer as
// soon as that is summed.  One commit group a part (empty past a CTA's last
// unit), so that "all but the last group" is always the part to sum next.
template <int NH>
__global__ void __launch_bounds__(NT, MIN_CTAS) segment_sum_kernel(Args a) {
  __shared__ Unit units[2];
  __shared__ int gseg[GMAX];
  __shared__ Queue q;
  const int p0 = a.offsets[0], p1 = a.offsets[a.S];
  // The empty segments go to the CTAs without a unit where there are any.
  const int e0 = (int)gridDim.x > a.U ? a.U : 0;
  if (threadIdx.x == 0) q.nreq = q.ndone = 0;
  bool carried = false;   // this thread wrote carries not yet fenced
  int u = blockIdx.x;
  if (u < a.U) {
    stage_order(a, u, smem_idx<NH>(a, 0), smem_head<NH>(a, 0));
    __syncthreads();
    gather<NH>(a, u, 0, p0, p1, smem_idx<NH>(a, 0), smem_buf<NH>(a, 0));
    if (NH == 2) gather<NH>(a, u, 1, p0, p1, smem_idx<NH>(a, 0), smem_buf<NH>(a, 1));
    prepare(a, p0, p1, u, &units[0], smem_head<NH>(a, 0));
  }
  if ((int)blockIdx.x >= e0) write_empty(a, blockIdx.x - e0, gridDim.x - e0);
  for (int k = 0; u < a.U; u += gridDim.x, ++k) {
    const int st = k & 1, next = u + gridDim.x;
    const Unit& un = units[st];
    if (NH == 1) {
      if (next < a.U) {
        stage_order(a, next, smem_idx<NH>(a, st ^ 1), smem_head<NH>(a, st ^ 1));
        __syncthreads();
        gather<NH>(a, next, 0, p0, p1, smem_idx<NH>(a, st ^ 1), smem_buf<NH>(a, st ^ 1));
        prepare(a, p0, p1, next, &units[st ^ 1], smem_head<NH>(a, st ^ 1));
      } else {
        cp_async_commit();
      }
      cp_async_wait_prior();
      __syncthreads();
      if (un.r0 < un.r1) level1<NH>(a, un, 0, smem_buf<NH>(a, st), smem_head<NH>(a, st), smem_pre<NH>(a), smem_tail<NH>(a), gseg);
    } else {
      cp_async_wait_prior();   // half 0 of u
      __syncthreads();
      if (un.r0 < un.r1) level1<NH>(a, un, 0, smem_buf<NH>(a, 0), smem_head<NH>(a, st), smem_pre<NH>(a), smem_tail<NH>(a), gseg);
      __syncthreads();
      if (next < a.U) {
        stage_order(a, next, smem_idx<NH>(a, st ^ 1), smem_head<NH>(a, st ^ 1));
        __syncthreads();
        gather<NH>(a, next, 0, p0, p1, smem_idx<NH>(a, st ^ 1), smem_buf<NH>(a, 0));
      } else {
        cp_async_commit();
      }
      cp_async_wait_prior();   // half 1 of u
      __syncthreads();
      if (un.r0 < un.r1) level1<NH>(a, un, 1, smem_buf<NH>(a, 1), smem_head<NH>(a, st), smem_pre<NH>(a), smem_tail<NH>(a), gseg);
      __syncthreads();
      if (next < a.U) gather<NH>(a, next, 1, p0, p1, smem_idx<NH>(a, st ^ 1), smem_buf<NH>(a, 1));
      else cp_async_commit();
    }
    __syncthreads();
    if (un.r0 < un.r1) level2(a, un, smem_pre<NH>(a), smem_tail<NH>(a), gseg, &q, carried);
    __syncthreads();
    if (NH == 2 && next < a.U) {
      prepare(a, p0, p1, next, &units[st ^ 1], smem_head<NH>(a, st ^ 1));
      __syncthreads();
    }
    if (q.nreq > QUEUE - 2) {
      settle(a, &q, smem_part<NH>(a), carried);
      __syncthreads();
    }
  }
  __syncthreads();
  if (q.nreq > 0) settle(a, &q, smem_part<NH>(a), carried);
}

// Dynamic shared memory at slab width fc, g groups a tile and nh parts a
// unit: two buffers of a part's rows, and per unit parity the order slice
// and the segment starts.
long long smem_bytes(int fc, int g, int nh) {
  const int tr = K * g, trp = tr + tr / 16, brp = tr / nh + tr / nh / 16;
  return 4LL * (2LL * brp * fc + 2LL * tr + 2LL * trp + 2LL * g * fc + NT);
}

int sm_count() {
  static int n = -1;
  if (n < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// CTAs of an instance an SM holds at a shared-memory size, asked once a
// size.
template <int NH>
int per_sm(long long bytes) {
  static long long seen[16];
  static int count[16];
  static int filled = 0;
  for (int i = 0; i < filled; ++i)
    if (seen[i] == bytes) return count[i];
  int c = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c, segment_sum_kernel<NH>, NT,
                                                    (size_t)bytes) != cudaSuccess)
    return 0;
  if (filled < 16) {
    seen[filled] = bytes;
    count[filled++] = c;
  }
  return c;
}

}  // namespace

extern "C" {

// out = base (or 0) + the segment sums, with tiles of tile_rows sorted
// positions (kernels/segsum.py:tile_rows: 16 g rows, g <= 32 groups, and g
// min(F, 64) <= 256, or g even and g / 2 min(F, 64) <= 256).  Returns a cudaError_t code (0 on success).  R >= 1,
// S >= 1, F >= 1; base may be null; carries holds 2 U min(F, 64) floats and
// tickets U ints, 0 on entry (and so on exit), U = ceil(R / tile_rows)
// ceil(F / 64); out must not overlap values, base or carries.
int segment_sum_launch(const float* values, const int* order, const int* offsets,
                       const float* base, float* out, float* carries, int* tickets, int R, int S,
                       int F, int tile_rows, int round_bf16, void* stream) {
  // A unit is one part where its groups fit one level-1 pass, else two.
  const int fc = F < SLAB ? F : SLAB, g = tile_rows / K, nh = g * fc <= NT ? 1 : 2;
  if (tile_rows % (nh * K) != 0 || g < 1 || g > GMAX || g / nh * fc > NT)
    return (int)cudaErrorInvalidValue;
  const int nslabs = (F + SLAB - 1) / SLAB, units = (R + tile_rows - 1) / tile_rows * nslabs;
  // Offsets a unit's marking round reads: twice the segments a unit holds
  // on average, in whole rounds of NT, at most MARK NT.
  const long long per_unit = 2LL * S * nslabs / units;
  const int mark = (int)(per_unit / NT + 1 < MARK ? per_unit / NT + 1 : MARK);
  const Args a{values,
               order,
               offsets,
               base,
               out,
               carries,
               carries + (long long)units * fc,
               tickets,
               R,
               S,
               F,
               fc,
               g,
               pow2_at_least(g),
               tile_rows,
               nslabs,
               units,
               mark,
               round_bf16,
               (F % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0) ? 1 : 0};
  const long long bytes = smem_bytes(fc, g, nh);
  const int fit = nh == 1 ? per_sm<1>(bytes) : per_sm<2>(bytes);
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  // A CTA a unit, and CTAs of their own for the empty segments (16 entries
  // of out a thread) while the SMs hold them.
  const long long want = units + ((long long)S * F + 16 * NT - 1) / (16 * NT);
  const long long cap = (long long)fit * sm_count();
  const int grid = (int)(want < cap ? want : cap);
  if (nh == 1)
    segment_sum_kernel<1><<<grid, NT, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(a);
  else
    segment_sum_kernel<2><<<grid, NT, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
