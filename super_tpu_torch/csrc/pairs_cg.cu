// Block-Jacobi preconditioned CG on the pair-sparse normal equations, by hand
// for Hopper: kernels K1 and K1b, one template instantiated twice, each one
// cooperative launch with one thread block (CTA) on every SM.
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
// them rounded to bf16 (round to nearest even, as Tensor.to(bfloat16)),
// rounded here from the f32 tables.  All arithmetic is f32.
//
// Bound (chip_smoke.py:bound()): the bytes the solve needs, each read once
// (the 49 used band rows of both tables for the valid pairs, in f32 for K1
// and bf16 for K1b, the node ids, 49 rows of the preconditioner, b, x0, u,
// x), against its f32 operations (33 matvecs of 2 x 98 FMAs a valid pair,
// the preconditioner and the vector updates): 0.5 us for K1 and 2.0 us for
// K1b on the seeded systems.  Each SM holds ~1% of the work, so what this
// design can reach is set by latency instead: per iteration two grid
// barriers (after the p.Ap partials and after the r.z partials; 64 at 32
// iterations, plus 3 at the start: counts zeroed, counts complete, first
// residual), each with a read of the partials after it, and one gather of
// the neighbours' z and p; plus, once, the list build and one read of the
// pair blocks into shared memory.  chip_smoke.py times an iteration on the
// seeded systems and on the same systems with every pair a sink, where
// only the barriers and their sums are left: that floor, and the start (17
// us in K1 and 44 us in K1b on an NVIDIA H100 80GB HBM3 at 700 W), are in
// PERF.md beside the ~7 us an iteration of K1 takes.  Tensor cores are
// not used: every pair has its own 7x7 block against its own 7-vector, so
// no operand is shared by enough rows to feed wgmma; the work is 98 FMAs a
// pair per matvec.
//
// Design.
//   - Owner computes.  The nodes are split into contiguous ranges, one per
//     CTA, by a prefix over node weights (n1-list length + n2-list length +
//     1), so that every CTA holds about the same number of list entries;
//     with few nodes (J below the SM count) or a hub node some CTAs own
//     nothing and only take part in the barriers.  A CTA computes Ap, x, r
//     and z for its own nodes only: Ap[n] sums, in this order, B_k p[n2_k]
//     over its n1 list and B_k^T p[n1_k] over its n2 list, each in
//     ascending pair order, then adds u p[n].  So a column of `blk` is read
//     only by n1's owner and one of `blkt` only by n2's owner, and no
//     per-pair product leaves the SM.
//   - Own state in shared memory.  x, r, Ap, p and z of a CTA's own nodes
//     and their list bounds stay in its shared memory for the whole solve
//     (state kept in global memory cost a round trip through L2 at every
//     phase: an L1 line does not survive a store).  Only z and p, which
//     other CTAs read, are also written to global memory.  A range holds at
//     most (2 P + J) / SMs + 1 nodes; the host reserves that much.
//   - Lists built in parallel, in a fixed order.  Integer atomics count the
//     entries per node (global memory); every CTA scans the counts to find
//     its range; each CTA compacts the pairs of its own nodes in ascending
//     pair order (coalesced steps of 4 pairs a thread, one block scan a
//     step), and two warps place them, stably, into the per-node lists
//     (warp match for equal nodes in a 32-entry step).
//   - Pair blocks resident in shared memory.  Each CTA copies the 49 used
//     entries of the blocks of its list entries, in list order, into the
//     shared memory the node state leaves, once per solve, one thread an
//     entry with its 49 copies in flight (cp.async in K1; in K1b loads, a
//     rounding to bf16 and stores).  Entries past the budget
//     (pairs_cg_capacity: 964 in K1 and 1,416 in K1b at the paths' shapes,
//     against ~90 and ~330 per CTA in use), as at a hub node, are read from
//     global memory by the same code each matvec.  These are gathers of
//     single 4-byte values with a stride of P, which TMA bulk copies
//     (contiguous, 16-byte multiples) do not fit.
//   - Two grid barriers per iteration (cooperative_groups' grid sync), after
//     the p.Ap partials and after the r.z partials.  Every CTA sums the
//     per-CTA partials in CTA order.  p is double-buffered in global
//     memory: owners publish z before the second barrier; after it every
//     CTA forms a neighbour's new p as z + beta p_old itself (the same fma
//     as the owner, so the same bits), while the owner writes p_new into the
//     other buffer for the next iteration.  Values other SMs wrote in this
//     launch are read with __ldcg.  A barrier fused with its sum (each CTA
//     publishing (epoch, partial) and polling all the others) was slower:
//     ~4,000 threads polling the same lines.
// No float atomics: every sum has a fixed order, so the result is the same
// bits from run to run on a card with the same number of SMs.
//
// Limits: J and P below 2^24 (entry codes 2k + side and the node-weight
// prefix 2 P + J in 32-bit ints), and the node state of (2 P + J) / SMs + 2
// nodes (168 bytes each) within the 227 KB of shared memory: 2 P + J up to
// ~160,000 on 132 SMs (the dense graph has 40,128).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DYN_BYTES = 232448 - 64;        // all a block may use, less `Own`
constexpr int PROD_FLOATS = 8 * NT;           // one tile's per-entry products
constexpr int RED_WORDS = 2 * NW + 8;         // reduction and scan scratch
constexpr int FIXED_BYTES = (PROD_FLOATS + RED_WORDS) * 4;
constexpr int NODE_FLOATS = 40;               // x, r, Ap, p, z: 8 floats each
constexpr int NODE_BYTES = NODE_FLOATS * 4 + 8;   // and two list bounds

// A block in shared memory: 49 entries padded to whole 16-byte words (52
// f32 or 56 bf16), read with 16-byte loads; the odd word stride (13 or 7)
// keeps 8 neighbouring threads on distinct banks.
template <typename Band>
__host__ __device__ constexpr int block_stride() {
  return sizeof(Band) == 4 ? 52 : 56;
}

// List entries whose blocks fit in shared memory beside `node_cap` node
// states (a multiple of 4, so that the blocks start on 16 bytes); negative
// if the node states alone do not fit.
template <typename Band>
__host__ __device__ constexpr int capacity(int node_cap) {
  const int c = (DYN_BYTES - FIXED_BYTES - node_cap * NODE_BYTES) /
                (4 + block_stride<Band>() * (int)sizeof(Band));
  return c < 0 ? c : c / 4 * 4;
}

// The 49 entries of block e as f32.
__device__ __forceinline__ void load_block(const float* blocks, int e, float* blk) {
  const float4* src = reinterpret_cast<const float4*>(blocks + e * block_stride<float>());
#pragma unroll
  for (int q = 0; q < 13; ++q) {
    const float4 v = src[q];
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * q + t < 49) blk[4 * q + t] = f[t];
  }
}
__device__ __forceinline__ void load_block(const __nv_bfloat16* blocks, int e, float* blk) {
  const uint4* src = reinterpret_cast<const uint4*>(blocks + e * block_stride<__nv_bfloat16>());
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    const uint4 v = src[q];
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 8; ++t)  // a bf16 is the high half of its f32
      if (8 * q + t < 49)
        blk[8 * q + t] = __uint_as_float(t & 1 ? w[t / 2] & 0xffff0000u : w[t / 2] << 16);
  }
}

struct Args {
  const float *blk, *blkt;   // (64, P) band tables, f32
  const int *n1, *n2;        // (P,)
  const float *minv;         // (64, J)
  const float *b, *x0, *u;   // (7, J), (7, J), ()
  float* x;                  // (7, J) out
  float* fs;                 // float scratch, pairs_cg_float_scratch(J) floats
  int* is;                   // int scratch, pairs_cg_int_scratch(J, P) ints
  int J, P, iterations, node_cap;
};

__device__ __forceinline__ int band_row(int i, int c) { return 8 * ((c - i) & 7) + i; }

__device__ __forceinline__ bool valid_pair(int a, int b, int J) {
  return (unsigned)a < (unsigned)J && (unsigned)b < (unsigned)J;
}

// A pair-block entry as the kernel computes with it.
__device__ __forceinline__ float band_value(float v, float) { return v; }
__device__ __forceinline__ float band_value(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// p_new = z + beta p_old: owner and readers use this one expression.
__device__ __forceinline__ float p_next(float z, float p_old, float beta) {
  return __fmaf_rn(beta, p_old, z);
}

// Sum of v over the block in a fixed order; thread 0 gets the total.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NW; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

// Exclusive prefix of v over the block (thread order); *total gets the sum.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < NW; ++w) {
    if (w < warp) before += red[w];
    tot += red[w];
  }
  __syncthreads();
  *total = tot;
  return before + incl - v;
}

// Grid barrier, then the sum of the nb per-CTA partials in CTA order;
// every thread of every CTA gets the same value.  Other SMs wrote them:
// read from L2.
__device__ float grid_sum(float v, float* part, float* red, cg::grid_group& grid) {
  v = block_sum(v, red);
  if (threadIdx.x == 0) part[blockIdx.x] = v;
  grid.sync();
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int q = threadIdx.x; q < gridDim.x; q += 32) s += __ldcg(part + q);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (threadIdx.x == 0) red[NW] = s;
  }
  __syncthreads();
  return red[NW];
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Everything a CTA knows about the nodes it owns.
struct Own {
  int j0, j1;   // node range
  int e0, m;    // its list entries: ent[e0, e0 + m)
  int m1;       // of which the n1 lists take the first m1 (before placing)
  int res;      // entries with their block in shared memory
};

template <typename Band>
__global__ void __launch_bounds__(NT, 1) pairs_cg_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* prod = reinterpret_cast<float*>(smem_raw);             // 8 NT
  float* red = prod + PROD_FLOATS;                              // RED_WORDS
  int* ired = reinterpret_cast<int*>(red + NW + 1);             // NW + 7
  float* node = red + RED_WORDS;                                // node_cap x 40
  int* bounds = reinterpret_cast<int*>(node + NODE_FLOATS * a.node_cap);  // 2 node_cap
  int* nbr_s = bounds + 2 * a.node_cap;                         // cap
  Band* blocks = reinterpret_cast<Band*>(nbr_s + capacity<Band>(a.node_cap));  // cap x stride
  __shared__ Own own;

  const int J = a.J, P = a.P, nb = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
  const int gtid = bid * NT + tid, gstride = nb * NT;
  int* cnt1 = a.is;            // entries per node, n1 lists
  int* cnt2 = cnt1 + J;        // n2 lists
  int* es = cnt2 + J;          // first entry of each own node
  int* cur1 = es + J;          // placement cursors; after placement
  int* cur2 = cur1 + J;        // cur2 is the end of each own node's entries
  int* tmp = cur2 + J;         // 2 P: compacted pairs of each CTA
  int* tkey = tmp + 2 * P;     // 2 P: their nodes
  int* ent = tkey + 2 * P;     // 2 P: list entries, 2 k + side
  int* cta_entries = ent + 2 * P;   // nb: list entries per CTA (left on return)
  float* z8 = a.fs;            // 8 J: z, published
  float* pbuf = z8 + 8 * J;    // 2 x 8 J: p, published, double-buffered
  float* part_pap = pbuf + 16 * J;   // nb
  float* part_rz = part_pap + nb;    // nb
  const float u = *a.u;

  // ---- Lists. -----------------------------------------------------------
  for (int j = gtid; j < 2 * J; j += gstride) cnt1[j] = 0;
  grid.sync();
  for (int k = gtid; k < P; k += gstride) {
    const int p1 = a.n1[k], p2 = a.n2[k];
    if (valid_pair(p1, p2, J)) {
      atomicAdd(cnt1 + p1, 1);
      atomicAdd(cnt2 + p2, 1);
    }
  }
  grid.sync();

  // Every CTA scans all node weights w = c1 + c2 + 1; node j goes to CTA
  // floor(prefix_j * nb / W).  Own nodes get their first entry and cursors.
  if (tid == 0) {
    own.j0 = J;
    own.j1 = 0;
    own.m1 = 0;
  }
  int wsum = 0;
  for (int j = tid; j < J; j += NT) wsum += __ldcg(cnt1 + j) + __ldcg(cnt2 + j) + 1;
  int W;
  block_scan(wsum, ired, &W);
  int carry = 0, m1_part = 0;
  for (int base = 0; base < J; base += NT) {
    const int j = base + tid;
    const int c1 = j < J ? __ldcg(cnt1 + j) : 0, c2 = j < J ? __ldcg(cnt2 + j) : 0;
    const int w = j < J ? c1 + c2 + 1 : 0;
    int chunk;
    const int excl = carry + block_scan(w, ired, &chunk);
    carry += chunk;
    if (j < J && (int)((long long)excl * nb / W) == bid) {
      atomicMin(&own.j0, j);
      atomicMax(&own.j1, j + 1);
      const int e = excl - j;  // entries of the nodes before j
      es[j] = e;
      cur1[j] = e;
      cur2[j] = e + c1;
      m1_part += c1;
    }
  }
  if (m1_part) atomicAdd(&own.m1, m1_part);
  __syncthreads();
  if (tid == 0) {
    if (own.j1 <= own.j0) {
      own.j0 = own.j1 = 0;
      own.e0 = own.m = 0;
    } else {
      const int last = own.j1 - 1;
      own.e0 = es[own.j0];
      own.m = es[last] + __ldcg(cnt1 + last) + __ldcg(cnt2 + last) - own.e0;
    }
    own.res = min(own.m, capacity<Band>(a.node_cap));
    cta_entries[bid] = own.m;
  }
  __syncthreads();
  const int j0 = own.j0, j1 = own.j1, e0 = own.e0, m = own.m, res = own.res;
  const int nn = j1 - j0, rows = 7 * nn;

  if (m > 0) {
    // Compact this CTA's pairs in ascending order, 4 NT pairs a step: a
    // thread takes 4 consecutive pairs, and one block scan of its two counts
    // (packed in one int) places them.
    int base1 = e0, base2 = e0 + own.m1;
    for (int base = 0; base < P; base += 4 * NT) {
      const int k0 = base + 4 * tid;
      int p1[4], p2[4];
      unsigned f1 = 0, f2 = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = k0 + q < P;
        p1[q] = in ? __ldg(a.n1 + k0 + q) : -1;
        p2[q] = in ? __ldg(a.n2 + k0 + q) : -1;
        const bool v = valid_pair(p1[q], p2[q], J);
        f1 |= (unsigned)(v && p1[q] >= j0 && p1[q] < j1) << q;
        f2 |= (unsigned)(v && p2[q] >= j0 && p2[q] < j1) << q;
      }
      int tot;
      const int ex = block_scan(__popc(f1) | (__popc(f2) << 16), ired, &tot);
      int o1 = base1 + (ex & 0xffff), o2 = base2 + (ex >> 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (f1 >> q & 1) {
          tkey[o1] = p1[q];
          tmp[o1++] = k0 + q;
        }
        if (f2 >> q & 1) {
          tkey[o2] = p2[q];
          tmp[o2++] = k0 + q;
        }
      }
      base1 += tot & 0xffff;
      base2 += tot >> 16;
    }
    __syncthreads();
    // Stable placement: warp 0 the n1 lists, warp 1 the n2 lists.
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
      int* cur = warp == 0 ? cur1 : cur2;
      const int lo = e0 + (warp == 0 ? 0 : own.m1);
      const int hi = warp == 0 ? e0 + own.m1 : e0 + m;
      const unsigned below = (1u << lane) - 1u;
      // Loads run one step ahead of their use.
      int k_next = lo + lane < hi ? tmp[lo + lane] : -1;
      int key_next = lo + lane < hi ? tkey[lo + lane] : -1;
      for (int base = lo; base < hi; base += 32) {
        const int k = k_next, key = key_next;
        const int q = base + 32 + lane;
        k_next = q < hi ? tmp[q] : -1;
        key_next = q < hi ? tkey[q] : -1;
        const unsigned peers = __match_any_sync(FULL, key);
        const int pos = key >= 0 ? cur[key] : 0;
        __syncwarp();
        if (key >= 0) {
          ent[pos + __popc(peers & below)] = 2 * k + warp;
          if (lane == __ffs(peers) - 1) cur[key] = pos + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // Pair blocks of the first `res` entries into shared memory, entry-major
    // (block_stride apart): a thread an entry, its 49 copies all in flight
    // at once.
    for (int e = tid; e < res; e += NT) {
      const int code = ent[e0 + e];
      const int k = code >> 1;
      const float* src = ((code & 1) ? a.blkt : a.blk) + k;
      nbr_s[e] = (code & 1) ? a.n1[k] : a.n2[k];
      if constexpr (sizeof(Band) == 4) {
#pragma unroll
        for (int q = 0; q < 49; ++q)
          cp_async4(blocks + e * block_stride<Band>() + q,
                    src + (size_t)band_row(q / 7, q % 7) * P);
      } else {
        float v[49];
#pragma unroll
        for (int q = 0; q < 49; ++q) v[q] = __ldg(src + (size_t)band_row(q / 7, q % 7) * P);
#pragma unroll
        for (int q = 0; q < 49; ++q)
          blocks[e * block_stride<Band>() + q] = __float2bfloat16_rn(v[q]);
      }
    }
    if constexpr (sizeof(Band) == 4) cp_async_wait_all();
  }
  // Own node state: 40 floats a node (x, r, Ap, p, z at 0, 8, 16, 24, 32)
  // and the node's entries [lo, hi) relative to e0.
  for (int l = tid; l < nn; l += NT) {
    bounds[2 * l] = es[j0 + l] - e0;
    bounds[2 * l + 1] = cur2[j0 + l] - e0;
  }
  __syncthreads();
  auto xs = [&](int l, int i) -> float& { return node[NODE_FLOATS * l + i]; };
  auto rs = [&](int l, int i) -> float& { return node[NODE_FLOATS * l + 8 + i]; };
  auto aps = [&](int l, int i) -> float& { return node[NODE_FLOATS * l + 16 + i]; };
  auto ps = [&](int l, int i) -> float& { return node[NODE_FLOATS * l + 24 + i]; };
  auto zs = [&](int l, int i) -> float& { return node[NODE_FLOATS * l + 32 + i]; };

  // ---- The solve. -------------------------------------------------------
  // For the own rows: the sum over each node's entries of B v[nbr], in list
  // order, for v given by get_v(node, out[7]); then finish(l, i, sum) for
  // local node l, row i.  Tiles of NT entries: one thread an entry computes
  // its 7 products into `prod`, then one thread a row adds its node's
  // entries of the tile to the row's sum (carried in Ap between tiles).
  auto matvec = [&](auto get_v, auto finish) {
    for (int t0 = 0; t0 == 0 || t0 < m; t0 += NT) {
      const int e = t0 + tid;
      if (e < m) {
        float blk[49];
        int nbr;
        if (e < res) {
          nbr = nbr_s[e];
          load_block(blocks, e, blk);
        } else {
          const int code = ent[e0 + e];
          const int k = code >> 1;
          const float* tab = (code & 1) ? a.blkt : a.blk;
          nbr = (code & 1) ? a.n1[k] : a.n2[k];
#pragma unroll
          for (int q = 0; q < 49; ++q)
            blk[q] = band_value(__ldg(tab + (size_t)band_row(q / 7, q % 7) * P + k), Band());
        }
        float v[7];
        get_v(nbr, v);
        float s[8];
#pragma unroll
        for (int i = 0; i < 7; ++i) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < 7; ++c) acc = fmaf(blk[7 * i + c], v[c], acc);
          s[i] = acc;
        }
        s[7] = 0.f;
        float4* o = reinterpret_cast<float4*>(prod + 8 * tid);
        o[0] = make_float4(s[0], s[1], s[2], s[3]);
        o[1] = make_float4(s[4], s[5], s[6], s[7]);
      }
      __syncthreads();
      const bool last = t0 + NT >= m;
      for (int q = tid; q < rows; q += NT) {
        const int l = q / 7, i = q - 7 * l;
        const int lo = max(bounds[2 * l], t0), hi = min(bounds[2 * l + 1], t0 + NT);
        float acc = t0 == 0 ? 0.f : aps(l, i);
        for (int f = lo; f < hi; ++f) acc += prod[8 * (f - t0) + i];
        if (last)
          finish(l, i, acc);
        else
          aps(l, i) = acc;
      }
      __syncthreads();
    }
  };

  // z = Minv r for the own rows, kept and published; returns this thread's
  // share of r.z.  A thread's first row of the band table stays in
  // registers for the whole solve.
  float minv_row[7];
  if (tid < rows) {
    const int l = tid / 7, i = tid - 7 * l;
#pragma unroll
    for (int c = 0; c < 7; ++c) minv_row[c] = __ldg(a.minv + (size_t)band_row(i, c) * J + j0 + l);
  }
  auto precond = [&]() {
    float rz = 0.f;
    for (int q = tid; q < rows; q += NT) {
      const int l = q / 7, i = q - 7 * l, n = j0 + l;
      float z = 0.f;
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const float mc = q == tid ? minv_row[c] : __ldg(a.minv + (size_t)band_row(i, c) * J + n);
        z = fmaf(mc, rs(l, c), z);
      }
      zs(l, i) = z;
      z8[8 * n + i] = z;
      rz = fmaf(rs(l, i), z, rz);
    }
    return rz;
  };

  // r = b - A x0; z = Minv r; p_{-1} = 0.
  matvec(
      [&](int n, float* v) {
#pragma unroll
        for (int c = 0; c < 7; ++c) v[c] = __ldg(a.x0 + (size_t)c * J + n);
      },
      [&](int l, int i, float s) {
        const int n = j0 + l;
        const float x0 = a.x0[(size_t)i * J + n];
        xs(l, i) = x0;
        rs(l, i) = a.b[(size_t)i * J + n] - (s + u * x0);
        ps(l, i) = 0.f;
        pbuf[8 * J + 8 * n + i] = 0.f;
      });
  float rz = grid_sum(precond(), part_rz, red, grid);
  float beta = 0.f;

  for (int it = 0; it < a.iterations; ++it) {
    float* p_cur = pbuf + 8 * J * (it & 1);
    const float* p_old = pbuf + 8 * J * ((it + 1) & 1);
    float pap_t = 0.f;
    matvec(
        [&](int n, float* v) {
          const float4* zq = reinterpret_cast<const float4*>(z8 + 8 * n);
          const float4* pq = reinterpret_cast<const float4*>(p_old + 8 * n);
          const float4 za = __ldcg(zq), zb = __ldcg(zq + 1);
          const float4 pa = __ldcg(pq), pb = __ldcg(pq + 1);
          v[0] = p_next(za.x, pa.x, beta);
          v[1] = p_next(za.y, pa.y, beta);
          v[2] = p_next(za.z, pa.z, beta);
          v[3] = p_next(za.w, pa.w, beta);
          v[4] = p_next(zb.x, pb.x, beta);
          v[5] = p_next(zb.y, pb.y, beta);
          v[6] = p_next(zb.z, pb.z, beta);
        },
        [&](int l, int i, float s) {
          const float p = p_next(zs(l, i), ps(l, i), beta);
          ps(l, i) = p;
          p_cur[8 * (j0 + l) + i] = p;
          const float ap = s + u * p;
          aps(l, i) = ap;
          pap_t = fmaf(p, ap, pap_t);
        });
    const float pap = grid_sum(pap_t, part_pap, red, grid);
    const float alpha = fabsf(pap) > 1e-30f ? rz / pap : 0.f;
    for (int q = tid; q < rows; q += NT) {
      const int l = q / 7, i = q - 7 * l;
      xs(l, i) += alpha * ps(l, i);
      rs(l, i) -= alpha * aps(l, i);
    }
    __syncthreads();
    const float rz_new = grid_sum(precond(), part_rz, red, grid);
    beta = fabsf(rz) > 1e-30f ? rz_new / rz : 0.f;
    rz = rz_new;
  }
  for (int q = tid; q < rows; q += NT) {
    const int l = q / 7, i = q - 7 * l;
    a.x[(size_t)i * J + j0 + l] = xs(l, i);
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

// Most nodes a CTA's range can hold, (2 P + J) / nb + 1, rounded up to an
// even count (the list bounds then end on 16 bytes).
int node_cap(int J, int P) { return ((2 * P + J) / num_blocks() + 3) & ~1; }

// Shared memory attribute and occupancy, checked once per process and
// instance; returns a cudaError_t code.
template <typename Band>
int prepare() {
  static int rc = -1;
  if (rc < 0) {
    auto* kernel = pairs_cg_kernel<Band>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DYN_BYTES);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, DYN_BYTES);
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
    rc = (int)e;
  }
  return rc;
}

template <typename Band>
int launch(const Args& args, void* stream) {
  if (capacity<Band>(args.node_cap) < 0) return (int)cudaErrorInvalidValue;
  const int rc = prepare<Band>();
  if (rc != 0) return rc;
  void* params[] = {(void*)&args};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)pairs_cg_kernel<Band>,
                                              dim3(num_blocks()), dim3(NT), params, DYN_BYTES,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// CTAs of the cooperative grid: one per SM.
int pairs_cg_blocks() { return num_blocks(); }

// List entries a CTA keeps with their blocks in shared memory at J nodes
// and P pairs; negative where the node state alone would not fit.
int pairs_cg_capacity(int J, int P, int chunked) {
  const int nc = node_cap(J, P);
  return chunked ? capacity<__nv_bfloat16>(nc) : capacity<float>(nc);
}

long long pairs_cg_float_scratch(int J) { return 24LL * J + 2LL * num_blocks(); }

// The last pairs_cg_blocks() ints hold each CTA's count of list entries
// when the kernel returns.
long long pairs_cg_int_scratch(int J, int P) { return 5LL * J + 6LL * P + num_blocks(); }

// Returns a cudaError_t code (0 on success).  chunked = 0: K1 (f32
// blocks); 1: K1b (blocks rounded to bf16).  The band tables are f32 in
// both; scratch as sized above (float scratch 16-byte aligned).
int pairs_cg_launch(const float* blk, const float* blkt, const int* n1, const int* n2,
                    const float* minv, const float* b, const float* x0, const float* u,
                    float* x_out, float* f_scratch, int* i_scratch, int J, int P,
                    int iterations, int chunked, void* stream) {
  const Args args{blk, blkt, n1, n2, minv, b, x0, u, x_out, f_scratch, i_scratch,
                  J, P, iterations, node_cap(J, P)};
  return chunked ? launch<__nv_bfloat16>(args, stream) : launch<float>(args, stream);
}

}  // extern "C"
