// K1's register body `regs`: the tile's carry and both passes of every rep
// in registers, neighbour lanes by warp shuffle.
//
// The shared-memory `swar` body (stencil_tile.cuh) moves every packed word
// through shared memory six times a rep (the rows pass's load and store,
// the cols pass's three loads and its store) between two block-wide
// barriers, and that traffic, not device memory or arithmetic, is what
// bounded K1 on an H100: ~230 MB a rep through shared memory at 1920x2520
// RGB, >= 7 us of the 15 us a rep took. This body keeps `swar`'s packing
// (rows 2q and 2q+1 as the two 16-bit fields of one 32-bit word, so
// swar_ok's exactness argument and the 0x00FF00FF re-zero mask carry over)
// and moves the words to registers:
//
//   * a thread holds STENCIL_REGS_V consecutive flat lanes of Q row pairs
//     (stencil_regs_q); a warp holds 32 * V lanes by 2 * Q rows, and
//     the warps of a block stack vertically (the block's extent is
//     2 * Q * warps rows by 32 * V lanes);
//   * the rows pass reads the thread's own words (one byte-permute per word
//     for the straddled pair, as swar); only the pair row above a warp and
//     the one below it come from the neighbour warps, through a small
//     double-buffered exchange in shared memory: one barrier a rep;
//   * the cols pass (taps h*C lanes apart) reads the thread's own words;
//     the h*C words at each end of its V lanes come from the neighbour
//     lanes by __shfl_up_sync / __shfl_down_sync, 2*h*C shuffles per V
//     words. The rows and cols passes of one pair row run back to back, so
//     the rows-pass intermediate lives only for that row.
//
// Nothing beyond the extent is read: the block's top and bottom warps see
// zero pair rows, a warp's end lanes see their own words. Those values are
// wrong, and the error moves in by h rows and h*C lanes a rep, so after
// `fuse` reps the block stores only what the ghost bands (fuse*h rows and
// fuse*h*C lanes per side, the left band rounded up to 8 lanes) leave of
// its extent: the host's cuda_stencil.regs_geometry gives that tile as
// g.tile_h x g.tile_w, and `fuse` stays a launch argument (1 on the serving
// path). Every rep re-zeroes what lies outside the image (rows outside
// [0, rows_real), the frames layout's gap rows, lanes outside [0, wc)) with
// masks each thread computes once per launch.
//
// The taps are fixed at compile time: the body runs the binomial filters
// of size 3 and 5 (gaussian, gaussian5; 1 2 1 and 1 4 6 4 1 in both
// passes, >> 4 and >> 8), whose adds and shifts the compiler spreads over
// the integer and FMA pipes (12% faster than taps read at run time, on an
// H100 at 1920x2520 RGB). Loads and stores go straight between device
// memory and registers, 8 lanes (one 8-byte access) per row and thread
// where the row allows it. A filter size and a channel count (1 or 3) make
// one instance: the shuffles at a thread's edges are unrolled for h*C
// words.
#pragma once

#include "stencil_tile.cuh"

// K1's body index after stencil_tile.cuh's (cuda_stencil.K1_BODIES).
#define STENCIL_BODY_REGS 3
#define STENCIL_REGS_V 8          // flat lanes a thread holds
#define STENCIL_REGS_ALIGN 8      // a block's first lane and its tile width
#define STENCIL_REGS_WARPS 8      // warps a block stacks

// Row pairs a thread holds at filter size k: 8 at k = 3 (127-128 registers,
// no spill); 6 at k = 5, whose wider windows spill at 8 (mirrored by
// cuda_stencil.REGS_Q).
__host__ __device__ constexpr int stencil_regs_q(int k) {
  return k == 3 ? 8 : 6;
}

// Lanes of a block's left ghost band: gc = fuse*h*C rounded up to whole
// 8-lane groups, so every thread's lanes start 8 lanes aligned.
__host__ __device__ inline int stencil_regs_left(int gc) {
  return (gc + STENCIL_REGS_ALIGN - 1) / STENCIL_REGS_ALIGN *
         STENCIL_REGS_ALIGN;
}

// Shared memory of a block: the exchange rows, two buffers of each warp's
// first and last pair row (mirrored by cuda_stencil.regs_smem_bytes).
__host__ __device__ constexpr size_t stencil_regs_smem() {
  return (size_t)2 * STENCIL_REGS_WARPS * 2 * 32 * STENCIL_REGS_V *
         sizeof(uint32_t);
}

// Whether a block's register extent (STENCIL_REGS_WARPS warps of 2 * q
// rows by 32 * STENCIL_REGS_V lanes) leaves a tile (tile_w a multiple of
// 8) inside the ghost bands of `fuse` reps of halo h.
__host__ inline bool stencil_regs_tile_fits(const StencilGeometry& g,
                                            int fuse, int h, int q) {
  const int gc = fuse * h * g.channels;
  return g.tile_h >= 1 && g.tile_w >= STENCIL_REGS_ALIGN &&
         g.tile_w % STENCIL_REGS_ALIGN == 0 &&
         stencil_regs_left(gc) + g.tile_w + gc <= 32 * STENCIL_REGS_V &&
         g.tile_h + 2 * fuse * h <= 2 * q * STENCIL_REGS_WARPS;
}

// Whether the regs body runs this launch: binomial taps of size 3 or 5
// (gaussian, gaussian5: a swar plan that shifts by 2 * (k - 1)) in both
// passes, one or three channels, and a tile that the ghost bands of
// `fuse` reps leave inside the block's extent.
__host__ inline bool stencil_regs_runs(const StencilParams& p,
                                       const StencilGeometry& g, int fuse) {
  if (p.kind != 0 || (p.k != 3 && p.k != 5) || p.shift != 2 * (p.k - 1) ||
      (g.channels != 1 && g.channels != 3))
    return false;
  for (int i = 0, b = 1; i < p.k; b = b * (p.k - 1 - i) / (i + 1), ++i)
    if (p.row_taps[i] != b || p.col_taps[i] != b) return false;
  return stencil_regs_tile_fits(g, fuse, p.k / 2, stencil_regs_q(p.k));
}

// One output of a binomial pass of size KT over its KT inputs w(0) ..
// w(KT-1): 1 2 1 or 1 4 6 4 1, the taps fixed at compile time.
template <int KT, class W>
__device__ __forceinline__ uint32_t stencil_binomial(W w) {
  if constexpr (KT == 3) return w(0) + w(2) + 2u * w(1);
  return w(0) + w(4) + 4u * (w(1) + w(3)) + 6u * w(2);
}

// Lanes [x0, x0 + 8) of a source row whose lanes [0, n) hold data (zero
// elsewhere), x0 a multiple of 8: one 8-byte load (two 4-byte ones where
// rows are only 4-byte aligned), bytes at a ragged edge.
__device__ __forceinline__ uint2 stencil_ld8(const uint8_t* row, int x0,
                                             int n, int vec) {
  if (x0 >= 0 && x0 + 8 <= n && vec >= 4) {
    if (vec >= 8) return __ldg(reinterpret_cast<const uint2*>(row + x0));
    const unsigned int* q = reinterpret_cast<const unsigned int*>(row + x0);
    return make_uint2(__ldg(q), __ldg(q + 1));
  }
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = x0 + i;
    if ((unsigned)l < (unsigned)n)
      w[i >> 2] |= (uint32_t)__ldg(row + l) << (8 * (i & 3));
  }
  return make_uint2(w[0], w[1]);
}

// Store lanes [x0, x0 + 8) of a destination row, only those below n
// (x0 >= 0, a multiple of 8).
__device__ __forceinline__ void stencil_st8(uint8_t* row, int x0, int n,
                                            int vec, uint2 v) {
  if (x0 + 8 <= n && vec >= 4) {
    if (vec >= 8) {
      *reinterpret_cast<uint2*>(row + x0) = v;
    } else {
      reinterpret_cast<uint32_t*>(row + x0)[0] = v.x;
      reinterpret_cast<uint32_t*>(row + x0)[1] = v.y;
    }
    return;
  }
  const uint32_t w[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (x0 + i < n) row[x0 + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

// Four words of lanes i -> the bytes of row 2q (low fields) into *lo and
// of row 2q+1 (high fields) into *hi.
__device__ __forceinline__ void stencil_unpack4(const uint32_t* w,
                                                uint32_t* lo, uint32_t* hi) {
  const uint32_t x = __byte_perm(w[0], w[1], 0x6240);  // a0 a1 b0 b1
  const uint32_t y = __byte_perm(w[2], w[3], 0x6240);  // a2 a3 b2 b3
  *lo = __byte_perm(x, y, 0x5410);
  *hi = __byte_perm(x, y, 0x7632);
}

// The parts of a regs block that do not depend on the rep's arithmetic,
// which both register bodies call: the thread's place in the block's
// extent, the load into packed words with the re-zero masks, the exchange
// of pair rows between warps, the zeroing of lanes past a ragged right
// edge and the store of the tile.

// The thread's lanes past a ragged right edge (wc not a multiple of 8)
// keep their first `kept` lanes: the others are zeroed after each rep.
__device__ __forceinline__ int stencil_regs_kept(const StencilGeometry& g,
                                                 int x0) {
  return x0 < 0 ? 0 : max(0, min(STENCIL_REGS_V, g.wc - x0));
}

// Load the thread's Q row pairs from image row r0 and lane x0 as packed
// words, and the re-zero mask of each pair: 0x00FF per kept row, none
// where the thread's lanes all lie outside the image (kept == 0). g and
// load_vec are the kernel's own parameters, as b holds them.
template <int Q>
__device__ __forceinline__ void stencil_regs_load(
    const StencilImageBounds& b, const StencilGeometry& g, int load_vec,
    int r0, int x0, int kept, uint32_t (&P)[Q][STENCIL_REGS_V],
    uint32_t (&rowm)[Q]) {
  int phase = b.keep_phase(r0);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int ra = r0 + 2 * q;
    const uint8_t* sa = b.load_row(ra);
    const uint8_t* sb = b.load_row(ra + 1);
    const uint2 zero = make_uint2(0, 0);
    const uint2 lo = sa ? stencil_ld8(sa, x0, g.wc, load_vec) : zero;
    const uint2 hi = sb ? stencil_ld8(sb, x0, g.wc, load_vec) : zero;
    stencil_pack4(lo.x, hi.x, P[q]);
    stencil_pack4(lo.y, hi.y, P[q] + 4);
    const bool ka = b.keep_step(ra, phase);
    const bool kb = b.keep_step(ra + 1, phase);
    rowm[q] = kept ? (ka ? 0x000000FFu : 0u) | (kb ? 0x00FF0000u : 0u) : 0u;
  }
}

// The exchange of rep t: each warp's first and last pair row into buffer
// t & 1 of `xch` (the j-th 16 bytes of every lane contiguous), one
// barrier, then where the pair row above this warp's first and the one
// below its last lie (nullptr past the block: zero rows). Nothing writes
// that buffer again before every warp has passed the barrier of rep
// t + 1, after its sweep.
template <int Q>
__device__ __forceinline__ void stencil_regs_exchange(
    uint4* xch, int t, int warp, int lane,
    const uint32_t (&P)[Q][STENCIL_REGS_V], const uint4** above,
    const uint4** below) {
  constexpr int VQ = STENCIL_REGS_V / 4, nw = STENCIL_REGS_WARPS;
  uint4* buf = xch + (size_t)(t & 1) * nw * 2 * VQ * 32;
  uint4* mine = buf + warp * 2 * VQ * 32;
#pragma unroll
  for (int j = 0; j < VQ; ++j) {
    mine[j * 32 + lane] = make_uint4(P[0][4 * j], P[0][4 * j + 1],
                                     P[0][4 * j + 2], P[0][4 * j + 3]);
    mine[(VQ + j) * 32 + lane] =
        make_uint4(P[Q - 1][4 * j], P[Q - 1][4 * j + 1],
                   P[Q - 1][4 * j + 2], P[Q - 1][4 * j + 3]);
  }
  __syncthreads();
  *above = warp > 0 ? buf + ((warp - 1) * 2 + 1) * VQ * 32 + lane : nullptr;
  *below = warp + 1 < nw ? buf + (warp + 1) * 2 * VQ * 32 + lane : nullptr;
}

// The thread's words of an exchanged pair row (zero for nullptr).
__device__ __forceinline__ void stencil_regs_neighbour(
    const uint4* row, uint32_t (&w)[STENCIL_REGS_V]) {
#pragma unroll
  for (int j = 0; j < STENCIL_REGS_V / 4; ++j) {
    const uint4 a = row ? row[j * 32] : make_uint4(0, 0, 0, 0);
    w[4 * j] = a.x, w[4 * j + 1] = a.y, w[4 * j + 2] = a.z,
    w[4 * j + 3] = a.w;
  }
}

// Zero the lanes past a ragged right edge.
template <int Q>
__device__ __forceinline__ void stencil_regs_clear_ragged(
    int kept, uint32_t (&P)[Q][STENCIL_REGS_V]) {
  if (kept > 0 && kept < STENCIL_REGS_V) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int v = 0; v < STENCIL_REGS_V; ++v)
        if (v >= kept) P[q][v] = 0;
  }
}

// Store the tile whose output origin is (row0, col0): the thread's lanes
// if they lie in it, each of its rows that does.
template <int Q>
__device__ __forceinline__ void stencil_regs_store(
    const StencilImageBounds& b, const StencilGeometry& g, int store_vec,
    int row0, int col0, int r0, int x0,
    const uint32_t (&P)[Q][STENCIL_REGS_V]) {
  if (x0 < col0 || x0 >= col0 + g.tile_w || x0 >= g.wc) return;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    uint32_t lo[2], hi[2];
    stencil_unpack4(P[q], &lo[0], &hi[0]);
    stencil_unpack4(P[q] + 4, &lo[1], &hi[1]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int row = r0 + 2 * q + s;
      if (row < row0 || row >= row0 + g.tile_h) continue;
      uint8_t* d = b.store_row(row);
      if (d)
        stencil_st8(d, x0, g.wc, store_vec,
                    s ? make_uint2(hi[0], hi[1]) : make_uint2(lo[0], lo[1]));
    }
  }
}

// `fuse` reps of one block's tile, whose output origin is (blockIdx.y *
// tile_h, blockIdx.x * tile_w), from src to dst; blockDim.x is 32 *
// STENCIL_REGS_WARPS and the dynamic shared memory stencil_regs_smem(). Two
// blocks an SM: 128 registers a thread.
template <int KT, int C>
__global__ void __launch_bounds__(STENCIL_REGS_WARPS * 32, 2)
    stencil_fused_regs_kernel(const uint8_t* __restrict__ src,
                              uint8_t* __restrict__ dst, StencilParams p,
                              StencilGeometry g, int fuse, int load_vec,
                              int store_vec) {
  constexpr int V = STENCIL_REGS_V, Q = stencil_regs_q(KT);
  constexpr int H = KT / 2, HC = H * C;
  static_assert(H >= 1 && H <= 2 && HC <= V, "one pair row and one "
                "neighbour thread per side");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xch = reinterpret_cast<uint4*>(smem);
  const StencilImageBounds b{src, dst, g, load_vec, store_vec};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * g.tile_h, col0 = blockIdx.x * g.tile_w;
  // The image row of the thread's first row and lane of its first lane.
  const int r0 = row0 - fuse * H + warp * 2 * Q;
  const int x0 = col0 - stencil_regs_left(fuse * HC) + lane * V;
  // The carry, and the re-zero mask of each pair.
  const int kept = stencil_regs_kept(g, x0);
  uint32_t P[Q][V], rowm[Q];
  stencil_regs_load(b, g, load_vec, r0, x0, kept, P, rowm);

  for (int t = 0; t < fuse; ++t) {
    const uint4 *above, *below;
    stencil_regs_exchange(xch, t, warp, lane, P, &above, &below);

    // One sweep down the pair rows: the rows pass of row q, then its cols
    // pass. W(r) is the pair (row r, row r+1): pair r/2 for even r, a
    // straddle for odd r; pair row q reads W(2q - h) .. W(2q + h), that is
    // the old pair rows q-1 .. q+1. `c` carries W(2q - 1) (k = 3) or the
    // old pair row q-1 (k = 5) from one row to the next.
    uint32_t c[V];
    stencil_regs_neighbour(above, c);
    if constexpr (KT == 3) {
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = stencil_straddle(c[v], P[0][v]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint32_t below_row[V];
      if (q + 1 == Q) stencil_regs_neighbour(below, below_row);
      uint32_t x[V + 2 * HC];  // the cols pass's window: T at v - HC ..
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t cur = P[q][v];
        const uint32_t nxt = q + 1 < Q ? P[q + 1][v] : below_row[v];
        const uint32_t s1 = stencil_straddle(cur, nxt);
        if constexpr (KT == 3) {
          const uint32_t w[3] = {c[v], cur, s1};
          x[HC + v] = stencil_binomial<3>([&](int i) { return w[i]; });
          c[v] = s1;
        } else {
          const uint32_t w[5] = {c[v], stencil_straddle(c[v], cur), cur, s1,
                                 nxt};
          x[HC + v] = stencil_binomial<5>([&](int i) { return w[i]; });
          c[v] = cur;
        }
      }
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        x[j] = __shfl_up_sync(0xFFFFFFFFu, x[V + j], 1);
        x[V + HC + j] = __shfl_down_sync(0xFFFFFFFFu, x[HC + j], 1);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t acc =
            stencil_binomial<KT>([&](int j) { return x[v + j * C]; });
        P[q][v] = (acc >> (2 * (KT - 1))) & rowm[q];
      }
    }
    stencil_regs_clear_ragged(kept, P);
  }

  stencil_regs_store(b, g, store_vec, row0, col0, r0, x0, P);
}

// ---------------------------------------------------------------------------
// The direct body: non-negative 3x3 taps on the same packed words
// ---------------------------------------------------------------------------
//
// K1's `regs_direct` body runs the direct plans (direct_int: taps that do
// not factor into two passes, such as edge /28) whose taps are
// non-negative integers with 255 * sum(taps) < 2^16 and that need no
// clip: 255 * sum(taps) / divisor < 256, the divisor a power of two on a
// dyadic plan. The shared tile's int32 body ran them with 9 byte loads
// from shared memory a pixel, taps read at run time, a float32 divide, a
// second pass through an int32 intermediate and two barriers a rep. Here
// the layout, the load, the exchange, the shuffles and the store are the
// regs body's; only the step of a rep differs. Pair row q reads the three
// vertical words W(2q-1), W(2q) and W(2q+1) (the carry, the pair, the
// straddle, as the k = 3 regs body forms them); for each tap column j it
// forms y_j = sum_i taps[i][j] * W(2q-1+i) as multiply-adds on whole
// packed words, then out[v] = y_0[v-C] + y_1[v] + y_2[v+C], the edge words
// of y_0 and y_2 from the neighbour lanes by shuffle. Every tap is >= 0
// and 255 * sum(taps) < 2^16, so no field carries into the next. The taps
// are read from the launch's parameters. Integer work, not memory, bounds
// the body (as regs), so where the taps mirror across the middle column
// and the middle row (edge's do) the body forms y_0 = taps[0][0] * (W(2q-1)
// + W(2q+1)) + taps[1][0] * W(2q) and y_1 likewise, and takes y_2 as y_0:
// 5 integer operations a word for the 9 multiply-adds (17.0 against 21.3
// us a fused rep of edge at 1920x5040 RGB on an H100).
//
// The finish is the plan's, exact per 16-bit field: the quotient
// __umulhi(field, div_mul), where the host proved that multiplier equal to
// min(255, trunc(float32(s) / float32(divisor))) for every reachable sum s
// (cuda_stencil.direct_divide; on a dyadic plan it is the shift), else one
// correctly rounded __fdiv_rn per field. Both quotients are below 256, so
// one byte-permute packs them and applies the re-zero mask: its selector
// takes a quotient's low byte for a kept row and a zero byte (the low
// quotient's second) for any other. The channel count, the finish and
// the mirror (stencil_direct_mirrored; under the multiply-high alone, so
// the divide keeps one instance a channel count) pick the instance.

// Row pairs a thread holds in the direct body (mirrored by
// cuda_stencil.REGS_DIRECT_Q).
#define STENCIL_REGS_DIRECT_Q 8

// K1's body index of the direct body (cuda_stencil.K1_BODIES).
#define STENCIL_BODY_REGS_DIRECT 4

// Whether a direct 3x3 plan's taps mirror across the middle column and the
// middle row.
__host__ inline bool stencil_direct_mirrored(const StencilParams& p) {
  for (int i = 0; i < 3; ++i)
    if (p.taps[3 * i] != p.taps[3 * i + 2] || p.taps[i] != p.taps[6 + i])
      return false;
  return true;
}

// Whether the direct body runs this launch (cuda_stencil.regs_direct_ok
// and the regs geometry at STENCIL_REGS_DIRECT_Q row pairs).
__host__ inline bool stencil_regs_direct_runs(const StencilParams& p,
                                              const StencilGeometry& g,
                                              int fuse) {
  if (p.kind != 1 || p.k != 3 || (g.channels != 1 && g.channels != 3))
    return false;
  long long sum = 0;
  for (int i = 0; i < 9; ++i) {
    if (p.taps[i] < 0) return false;
    sum += p.taps[i];
  }
  return 255 * sum < 65536 && 255.0 * sum < 256.0 * (double)p.divisor &&
         stencil_regs_tile_fits(g, fuse, 1, STENCIL_REGS_DIRECT_Q);
}

// The byte-permute selector that packs two quotients (< 256) of pair row
// q and applies its re-zero mask `rowm` (0x00FF per kept field): the low
// quotient's byte 0 (selector 0) or its zero byte 1 (1) in byte 0, the
// high quotient's byte 0 (4) or zero in byte 2, zero in bytes 1 and 3.
__device__ __forceinline__ uint32_t stencil_direct_select(uint32_t rowm) {
  return 0x1010u | ((rowm & 0xFFu) ? 0u : 1u) |
         ((rowm & 0xFF0000u) ? 0x400u : 0x100u);
}

// The finish of one packed word of sums (each field < 2^16) under the
// pair row's stencil_direct_select selector `sel`: by the proven
// multiplier (MULHI) or by the float32 divide.
template <bool MULHI>
__device__ __forceinline__ uint32_t stencil_direct_finish(
    uint32_t acc, const StencilParams& p, uint32_t sel) {
  uint32_t lo = acc & 0xFFFFu, hi = acc >> 16;
  if constexpr (MULHI) {
    lo = __umulhi(lo, p.div_mul);
    hi = __umulhi(hi, p.div_mul);
  } else {
    // Exact converts (a field < 2^16); the clip binds nowhere on a plan
    // the body runs, but keeps a rounding up to 256 out of the packing.
    lo = (uint32_t)fminf(__fdiv_rn(__uint2float_rn(lo), p.divisor), 255.0f);
    hi = (uint32_t)fminf(__fdiv_rn(__uint2float_rn(hi), p.divisor), 255.0f);
  }
  return __byte_perm(lo, hi, sel);
}

// `fuse` reps of one block's tile of a direct 3x3 plan, as
// stencil_fused_regs_kernel<3, C> runs a binomial one (the same extent,
// ghost bands and launch); MIRRORED for stencil_direct_mirrored taps,
// MULHI where the plan has a proven multiplier (p.div_mul != 0).
template <int C, bool MIRRORED, bool MULHI>
__global__ void __launch_bounds__(STENCIL_REGS_WARPS * 32, 2)
    stencil_fused_regs_direct_kernel(const uint8_t* __restrict__ src,
                                     uint8_t* __restrict__ dst,
                                     StencilParams p, StencilGeometry g,
                                     int fuse, int load_vec, int store_vec) {
  constexpr int V = STENCIL_REGS_V, Q = STENCIL_REGS_DIRECT_Q;
  static_assert(C <= V, "one neighbour thread per side");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xch = reinterpret_cast<uint4*>(smem);
  const StencilImageBounds b{src, dst, g, load_vec, store_vec};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * g.tile_h, col0 = blockIdx.x * g.tile_w;
  const int r0 = row0 - fuse + warp * 2 * Q;
  const int x0 = col0 - stencil_regs_left(fuse * C) + lane * V;
  const int kept = stencil_regs_kept(g, x0);
  uint32_t P[Q][V], sel[Q];
  stencil_regs_load(b, g, load_vec, r0, x0, kept, P, sel);
#pragma unroll
  for (int q = 0; q < Q; ++q) sel[q] = stencil_direct_select(sel[q]);
  // tap(i, j) weighs W(2q - 1 + i) at lane v + (j - 1) * C.
  auto tap = [&](int i, int j) { return (uint32_t)p.taps[3 * i + j]; };

  for (int t = 0; t < fuse; ++t) {
    const uint4 *above, *below;
    stencil_regs_exchange(xch, t, warp, lane, P, &above, &below);
    // `c` carries W(2q - 1) from one pair row to the next.
    uint32_t c[V];
    stencil_regs_neighbour(above, c);
#pragma unroll
    for (int v = 0; v < V; ++v) c[v] = stencil_straddle(c[v], P[0][v]);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint32_t below_row[V];
      if (q + 1 == Q) stencil_regs_neighbour(below, below_row);
      uint32_t y[3][V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t cur = P[q][v];
        const uint32_t nxt = q + 1 < Q ? P[q + 1][v] : below_row[v];
        const uint32_t s1 = stencil_straddle(cur, nxt);
        if constexpr (MIRRORED) {
          const uint32_t outer = c[v] + s1;
          y[0][v] = tap(0, 0) * outer + tap(1, 0) * cur;
          y[1][v] = tap(0, 1) * outer + tap(1, 1) * cur;
        } else {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            y[j][v] = tap(0, j) * c[v] + tap(1, j) * cur + tap(2, j) * s1;
        }
        c[v] = s1;
      }
      // y_2 (y_0 for mirrored taps)
      auto right = [&](int v) -> uint32_t {
        if constexpr (MIRRORED) return y[0][v];
        else return y[2][v];
      };
      // y_0 of the C lanes left of the thread's first, y_2 of the C lanes
      // right of its last.
      uint32_t from_left[C], from_right[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        from_left[j] = __shfl_up_sync(0xFFFFFFFFu, y[0][V - C + j], 1);
        from_right[j] = __shfl_down_sync(0xFFFFFFFFu, right(j), 1);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const uint32_t acc =
            (v >= C ? y[0][v - C] : from_left[v]) + y[1][v] +
            (v + C < V ? right(v + C) : from_right[v + C - V]);
        P[q][v] = stencil_direct_finish<MULHI>(acc, p, sel[q]);
      }
    }
    stencil_regs_clear_ragged(kept, P);
  }
  stencil_regs_store(b, g, store_vec, row0, col0, r0, x0, P);
}
