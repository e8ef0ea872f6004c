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

// Whether the regs body runs this launch: binomial taps of size 3 or 5
// (gaussian, gaussian5: a swar plan that shifts by 2 * (k - 1)) in both
// passes, one or three channels, and a tile (tile_w a multiple of 8) that
// the ghost bands of `fuse` reps leave inside the block's extent.
__host__ inline bool stencil_regs_runs(const StencilParams& p,
                                       const StencilGeometry& g, int fuse) {
  if (p.kind != 0 || (p.k != 3 && p.k != 5) || p.shift != 2 * (p.k - 1) ||
      (g.channels != 1 && g.channels != 3))
    return false;
  for (int i = 0, b = 1; i < p.k; b = b * (p.k - 1 - i) / (i + 1), ++i)
    if (p.row_taps[i] != b || p.col_taps[i] != b) return false;
  const int gc = fuse * (p.k / 2) * g.channels;
  return g.tile_h >= 1 && g.tile_w >= STENCIL_REGS_ALIGN &&
         g.tile_w % STENCIL_REGS_ALIGN == 0 &&
         stencil_regs_left(gc) + g.tile_w + gc <= 32 * STENCIL_REGS_V &&
         g.tile_h + 2 * fuse * (p.k / 2) <=
             2 * stencil_regs_q(p.k) * STENCIL_REGS_WARPS;
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
  constexpr int H = KT / 2, HC = H * C, VQ = V / 4;
  static_assert(H >= 1 && H <= 2 && HC <= V, "one pair row and one "
                "neighbour thread per side");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xch = reinterpret_cast<uint4*>(smem);
  const StencilImageBounds b{src, dst, g, load_vec, store_vec};
  constexpr int nw = STENCIL_REGS_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * g.tile_h, col0 = blockIdx.x * g.tile_w;
  // The image row of the thread's first row and lane of its first lane.
  const int r0 = row0 - fuse * H + warp * 2 * Q;
  const int x0 = col0 - stencil_regs_left(fuse * HC) + lane * V;

  // The carry, and the re-zero mask of each pair: 0x00FF per kept row,
  // none where the thread's lanes all lie outside the image. A thread at a
  // ragged right edge (wc not a multiple of 8) keeps its first `kept` lanes
  // and zeroes the others after each rep.
  const int kept = x0 < 0 ? 0 : max(0, min(V, g.wc - x0));
  uint32_t P[Q][V], rowm[Q];
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

  for (int t = 0; t < fuse; ++t) {
    // The exchange: each warp's first and last pair row (the j-th 16 bytes
    // of every lane contiguous), then the rows next to this warp's.
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
    // The pair row above this warp's first and the one below its last
    // (zero past the block). Nothing writes this buffer again before every
    // warp has passed the barrier of rep t + 1, after its sweep.
    const uint4* above =
        warp > 0 ? buf + ((warp - 1) * 2 + 1) * VQ * 32 + lane : nullptr;
    const uint4* below =
        warp + 1 < nw ? buf + (warp + 1) * 2 * VQ * 32 + lane : nullptr;
    auto neighbour = [&](const uint4* row, uint32_t(&w)[V]) {
#pragma unroll
      for (int j = 0; j < VQ; ++j) {
        const uint4 a = row ? row[j * 32] : make_uint4(0, 0, 0, 0);
        w[4 * j] = a.x, w[4 * j + 1] = a.y, w[4 * j + 2] = a.z,
        w[4 * j + 3] = a.w;
      }
    };

    // One sweep down the pair rows: the rows pass of row q, then its cols
    // pass. W(r) is the pair (row r, row r+1): pair r/2 for even r, a
    // straddle for odd r; pair row q reads W(2q - h) .. W(2q + h), that is
    // the old pair rows q-1 .. q+1. `c` carries W(2q - 1) (k = 3) or the
    // old pair row q-1 (k = 5) from one row to the next.
    uint32_t c[V];
    neighbour(above, c);
    if constexpr (KT == 3) {
#pragma unroll
      for (int v = 0; v < V; ++v) c[v] = stencil_straddle(c[v], P[0][v]);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint32_t below_row[V];
      if (q + 1 == Q) neighbour(below, below_row);
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
    if (kept > 0 && kept < V) {
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (v >= kept) P[q][v] = 0;
    }
  }

  // Store the tile: the thread's lanes if they lie in it, each of its rows
  // that does.
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
