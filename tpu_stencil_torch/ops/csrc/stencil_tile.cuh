// One tile of the iterated zero-boundary stencil, shared by the fused
// kernel K1 (stencil_fused.cu), the resident kernel K2
// (stencil_resident.cu) and the valid-ghost kernel K3 (stencil_valid.cu);
// the kernel lab (stencil_lab.cu) keeps the byte-wise tile of the first
// port beside it and takes the common parts from here.
//
// The image is viewed flat as (rows, wc) uint8 with wc = W * C: a
// column-pass tap moves by C flat lanes, so channels never mix, and the
// column boundary is a flat lane range. A block computes one output tile
// of tile_h rows by tile_w lanes:
//   1. it loads the tile plus g = fuse*halo ghost rows and g*C ghost lanes
//      per side into shared memory;
//   2. it runs `fuse` reps in shared memory; the trusted band contracts by
//      halo rows and halo*C lanes each rep, so rep t only computes
//      [t*halo, R - t*halo) x [t*halo*C, L - t*halo*C);
//   3. each rep finishes as the plan says (>> shift then a clip where one
//      can bind, or one correctly rounded float32 divide then a clip) and
//      re-zeroes every pixel outside the image;
//   4. it stores only the tile_h x tile_w interior.
// What "outside the image" means, where the tile loads from and where it
// stores, is the kernel's bounds policy, in the tile's own row/lane
// coordinates: StencilImageBounds below for K1 (rows outside
// [0, rows_real), lanes outside [0, wc), and under frames the gap rows
// where row % frame_stride >= frame_h; K2 reads it through L2) and
// StencilValidBounds in stencil_valid.cu for K3 (the global padded extent).
// The kernel lab's band variant (stencil_lab.cu) keeps the same test and
// takes its rows from a band in shared memory or from edge rows in device
// memory.
//
// The rep body is a compile-time parameter, picked per plan by the host
// (cuda_stencil.tile_body); no branch on it is left in the inner loops:
//   int32  the uint8 carry `cur` (R x L) and an int32 rows-pass
//          intermediate `tmp` (R x L): 5 bytes per element. Every plan.
//   acc16  the same with an int16 intermediate: 3 bytes per element.
//          Separable plans with taps >= 0 and 255 * sum(row_taps) < 2^15.
//   swar   rows 2q and 2q+1 of a lane as the two 16-bit fields of one
//          32-bit word, carry and intermediate both packed for all `fuse`
//          reps: (R/2 + 2 pad pairs + R/2) words per lane, 4 bytes per
//          element, and each shared load, multiply-add, shift, mask and
//          store serves two pixels. Separable plans with taps >= 0 of total
//          weight 2^shift, shift <= 8, so every field stays below 2^16. Two
//          rows, not two lanes: the cols pass moves by C lanes (odd for RGB
//          and grey), which would split a lane pair, while a row pair stays
//          whole under it; the rows pass needs the pair (2q+1, 2q+2), one
//          byte-permute of two neighbouring words. The right shift drags
//          the high field's low bits into the low field, and the re-zero
//          mask (0x00FF per kept row, per field) ANDs them away.
// In every body a thread owns whole lanes of the tile and walks down its
// rows (pairs under swar), keeping the rows-pass window in registers, and
// decides each row's keep once per row while it walks.
//
// The load and the store move 16 lanes per thread: one 16-byte global load
// or store where the 16 lanes lie inside the row and their address is
// aligned (8, 4 or 1-byte accesses where rows are only that aligned, byte
// by byte at a ragged image edge), and the widest shared access the tile's
// own alignment allows. A row's keep is tested once per 16 lanes. Under
// swar the load packs rows 2q and 2q+1 into words with __byte_perm and the
// store unpacks them. Plain vector loads, not cp.async or TMA: the tile's
// first lane sits 8 bytes off a 16-byte boundary at the default geometry
// (the ghost band is g*C lanes wide), so a 16-byte copy into shared memory
// would need the tile re-laid out, and the swar body must repack every
// byte in registers anyway. Measured on an H100 80GB HBM3 (700 W) by the
// kernel lab's ablations at 1920x2520 RGB gaussian x40, load and store
// alone: 0.0041 ms/rep this way, 0.0077 byte by byte (the lab's swar),
// of a whole shipped rep of 0.018.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#define STENCIL_MAX_K 15
#define STENCIL_MAX_THREADS 512

// Tile bodies; the index is the one cuda_stencil.BODIES gives.
#define STENCIL_BODY_INT32 0
#define STENCIL_BODY_ACC16 1
#define STENCIL_BODY_SWAR 2
#define STENCIL_N_BODIES 3

// Mirrors the ctypes Structure in tpu_stencil_torch/ops/cuda_stencil.py.
struct StencilParams {
  int kind;        // 0 = sep_int, 1 = direct_int
  int k;           // filter size (odd, <= STENCIL_MAX_K)
  int shift;       // >= 0: finish with >> shift; < 0: float32 divide
  int clip;        // 1: clip the shifted value to [0, 255]
  float divisor;   // divide path only
  int row_taps[STENCIL_MAX_K];               // sep_int: pass along rows
  int col_taps[STENCIL_MAX_K];               // sep_int: pass along lanes
  int taps[STENCIL_MAX_K * STENCIL_MAX_K];   // direct_int, row-major
  // K1's register body for direct plans (stencil_regs.cuh) on the divide
  // path: a field's quotient is __umulhi(field, div_mul), which the host
  // proved equal to the float32 divide for every reachable field
  // (cuda_stencil.direct_divide); 0 where no multiplier passed.
  unsigned int div_mul;
  // Keeps the struct a multiple of 16 bytes, so that the kernel parameters
  // after it keep their alignment (and the kernels their code).
  unsigned int pad[3];
};

struct StencilGeometry {
  int rows;          // rows of the flat image
  int wc;            // flat lanes per row (W * C)
  int rows_real;     // rows [rows_real, rows) lie outside the image
  int channels;      // C
  int frame_stride;  // > 0: frames layout, gap rows re-zeroed every rep
  int frame_h;       // real rows per frame
  int tile_h;        // output rows per tile
  int tile_w;        // output lanes per tile
};

__host__ __device__ inline int stencil_ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// floor(a / 16) for any sign of a.
__host__ __device__ inline int stencil_floor16(int a) { return a >> 4; }

// Shared-memory bytes of one tile of `body` at this fuse depth (mirrored by
// cuda_stencil.tile_smem_bytes).
__host__ __device__ inline size_t stencil_tile_smem(const StencilParams& p,
                                                   const StencilGeometry& g,
                                                   int fuse, int body) {
  const int h = p.k / 2;
  const size_t rr = (size_t)g.tile_h + 2 * fuse * h;
  const size_t ll = (size_t)g.tile_w + 2 * fuse * h * g.channels;
  if (body == STENCIL_BODY_SWAR) return ((rr / 2 + 2) + rr / 2) * ll * 4;
  return rr * ll * (body == STENCIL_BODY_ACC16 ? 3 : 5);
}

// Whether `body` computes this plan exactly (the gates of cuda_stencil's
// acc16_ok and swar_ok), and swar's even tile height.
__host__ inline bool stencil_body_runs(const StencilParams& p,
                                       const StencilGeometry& g, int body) {
  if (body == STENCIL_BODY_INT32) return true;
  if (p.kind != 0 || (body != STENCIL_BODY_ACC16 && body != STENCIL_BODY_SWAR))
    return false;
  long long rsum = 0, csum = 0;
  for (int i = 0; i < p.k; ++i) {
    if (p.row_taps[i] < 0 || p.col_taps[i] < 0) return false;
    rsum += p.row_taps[i];
    csum += p.col_taps[i];
  }
  if (body == STENCIL_BODY_ACC16) return 255 * rsum < 32768;
  return p.shift >= 0 && p.shift <= 8 && rsum * csum == (1LL << p.shift) &&
         g.tile_h % 2 == 0;
}

// Threads per block: one per shared-memory lane of the tile (rounded up to
// whole warps), at most STENCIL_MAX_THREADS; more lanes loop.
__host__ __device__ inline int stencil_block_threads(const StencilParams& p,
                                                     const StencilGeometry& g,
                                                     int fuse) {
  const int lanes = g.tile_w + 2 * fuse * (p.k / 2) * g.channels;
  const int t = (lanes + 31) / 32 * 32;
  return t < STENCIL_MAX_THREADS ? t : STENCIL_MAX_THREADS;
}

// The widest access (16, 8, 4 or 1 bytes) that is aligned for every row
// base + row * stride.
__host__ __device__ inline int stencil_vec_width(const void* base,
                                                 long long stride) {
  const unsigned long long a = (unsigned long long)base | (unsigned long long)stride;
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
}

__device__ __forceinline__ bool stencil_row_kept(const StencilGeometry& g,
                                                 int row) {
  if ((unsigned)row >= (unsigned)g.rows_real) return false;
  return g.frame_stride <= 0 || row % g.frame_stride < g.frame_h;
}

// The finishing step of one rep, as the TPU kernel's _rep_val does it.
__device__ __forceinline__ int stencil_finish(int acc, const StencilParams& p) {
  if (p.shift >= 0) {
    int v = acc >> p.shift;  // arithmetic shift, as jnp's >> on int32
    if (p.clip) v = min(max(v, 0), 255);
    return v;
  }
  // acc < 2^24 (the plan's bound), so the convert is exact; __fdiv_rn is
  // the correctly rounded divide whatever the compiler flags.
  float f = __fdiv_rn(__int2float_rn(acc), p.divisor);
  f = fminf(fmaxf(f, 0.0f), 255.0f);
  return (int)f;  // truncation toward zero, as the uint8 cast
}

// Visit every (r, c) of [r0, r1) x [c0, c1) once, spread over the block's
// threads in row-major order (one division per region, not per element).
template <typename F>
__device__ __forceinline__ void stencil_for_region(int r0, int r1, int c0,
                                                   int c1, F f) {
  const int nc = c1 - c0;
  const int n = (r1 - r0) * nc;
  if (nc <= 0 || n <= 0) return;
  int r = threadIdx.x / nc;
  int c = threadIdx.x - r * nc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    f(r0 + r, c0 + c);
    c += blockDim.x;
    while (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// Visit every (r, j) of [0, nr) x [0, nc) once, in row-major order over the
// block's threads, for regions narrower than the block (the tile's 16-lane
// chunks): the step is split into whole rows and a remainder once.
template <typename F>
__device__ __forceinline__ void stencil_for_chunks(int nr, int nc, F f) {
  const int n = nr * nc;
  if (nc <= 0 || n <= 0) return;
  const int dr = blockDim.x / nc;
  const int dc = blockDim.x - dr * nc;
  int r = threadIdx.x / nc;
  int c = threadIdx.x - r * nc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

// Rows pass of one lane: out[r] = sum_i row_taps[i] * in[r - h + i] for r in
// [r0, r1), with `cur`/`tmp` pointing at the lane and rows L apart. With the
// filter size fixed at compile time the window lives in registers, so each
// carry byte is read from shared memory once. ACC is the intermediate's
// type (int, or int16_t under acc16).
template <int KT, typename ACC>
__device__ __forceinline__ void stencil_rows_pass(const uint8_t* cur,
                                                  ACC* tmp,
                                                  const StencilParams& p,
                                                  int L, int r0, int r1,
                                                  int k) {
  const uint8_t* in = cur + (r0 - k / 2) * L;
  ACC* out = tmp + r0 * L;
  if constexpr (KT > 0) {
    int win[KT];
#pragma unroll
    for (int i = 0; i + 1 < KT; ++i) win[i] = in[i * L];
    for (int r = r0; r < r1; ++r, in += L, out += L) {
      win[KT - 1] = in[(KT - 1) * L];
      int acc = 0;
#pragma unroll
      for (int i = 0; i < KT; ++i) acc += p.row_taps[i] * win[i];
      *out = (ACC)acc;
#pragma unroll
      for (int i = 0; i + 1 < KT; ++i) win[i] = win[i + 1];
    }
  } else {
    for (int r = r0; r < r1; ++r, in += L, out += L) {
      int acc = 0;
      for (int i = 0; i < k; ++i) acc += p.row_taps[i] * (int)in[i * L];
      *out = (ACC)acc;
    }
  }
}

// Byte-wise bounds of the kernel lab: tile coordinates are image
// coordinates; ghosts outside the image load as zero (one byte and one keep
// test each) and every rep re-zeroes them.
struct StencilByteBounds {
  const uint8_t* src;
  uint8_t* dst;
  const StencilGeometry& g;

  __device__ __forceinline__ uint8_t load(int row, int lane) const {
    return (unsigned)lane < (unsigned)g.wc && stencil_row_kept(g, row)
               ? src[(size_t)row * g.wc + lane]
               : (uint8_t)0;
  }
  __device__ __forceinline__ bool row_kept(int row) const {
    return stencil_row_kept(g, row);
  }
  __device__ __forceinline__ bool lane_kept(int lane) const {
    return (unsigned)lane < (unsigned)g.wc;
  }
  __device__ __forceinline__ void store(int row, int lane, uint8_t v) const {
    if (row < g.rows && lane < g.wc) dst[(size_t)row * g.wc + lane] = v;
  }
};

// ---------------------------------------------------------------------------
// K1 and K3's tile: row bounds, 16-lane load and store, the three bodies
// ---------------------------------------------------------------------------
//
// A bounds policy for stencil_run_bounded_tile provides, in its own
// row/lane coordinates:
//   load_row(row)    the source row, or nullptr for a row that loads as zero
//   load_wc()        lanes [0, load_wc) of a source row hold data
//   load_vec         the widest aligned source access (stencil_vec_width)
//   rows_kept(lo, hi)  whether every row of [lo, hi) is kept
//   keep_phase(row), keep_step(row, phase)
//                    the re-zero test of consecutive rows: keep_step says
//                    whether `row` is kept and moves `phase` to row + 1
//   lane_kept(lane)  the re-zero test of a lane
//   store_row(row)   the destination row, or nullptr for a row not stored
//   store_off()      destination lane = lane - store_off()
//   store_wc()       destination lanes [0, store_wc) exist
//   store_vec        the widest aligned destination access
//   coherent         (static) loads must see what other blocks stored
//                    earlier in this launch (K2, the lab's band): global
//                    rows load through L2 (ld.global.cg), never through the
//                    non-coherent path, and rows in shared memory load as
//                    they are

// K1's bounds: tile coordinates are image coordinates.
struct StencilImageBounds {
  const uint8_t* src;
  uint8_t* dst;
  StencilGeometry g;
  int load_vec, store_vec;
  static constexpr bool coherent = false;

  __device__ __forceinline__ const uint8_t* load_row(int row) const {
    return stencil_row_kept(g, row) ? src + (size_t)row * g.wc : nullptr;
  }
  __device__ __forceinline__ int load_wc() const { return g.wc; }
  __device__ __forceinline__ bool rows_kept(int lo, int hi) const {
    if (lo < 0 || hi > g.rows_real) return false;
    // under frames: inside the real rows of one frame
    return g.frame_stride <= 0 ||
           hi - lo / g.frame_stride * g.frame_stride <= g.frame_h;
  }
  __device__ __forceinline__ int keep_phase(int row) const {
    if (g.frame_stride <= 0) return 0;
    const int m = row % g.frame_stride;
    return m < 0 ? m + g.frame_stride : m;
  }
  __device__ __forceinline__ bool keep_step(int row, int& phase) const {
    bool kept = (unsigned)row < (unsigned)g.rows_real;
    if (g.frame_stride > 0) {
      kept = kept && phase < g.frame_h;
      if (++phase == g.frame_stride) phase = 0;
    }
    return kept;
  }
  __device__ __forceinline__ bool lane_kept(int lane) const {
    return (unsigned)lane < (unsigned)g.wc;
  }
  __device__ __forceinline__ uint8_t* store_row(int row) const {
    return (unsigned)row < (unsigned)g.rows ? dst + (size_t)row * g.wc
                                            : nullptr;
  }
  __device__ __forceinline__ int store_off() const { return 0; }
  __device__ __forceinline__ int store_wc() const { return g.wc; }
};

// One load of a source row: read-only data through the non-coherent path
// (__ldg); under COHERENT global data through L2 (__ldcg), and a row that
// lies in shared memory (`shared`: the lab's band) as it is.
template <bool COHERENT, typename T>
__device__ __forceinline__ T stencil_ldv(const T* p, bool shared) {
  if (!COHERENT) return __ldg(p);
  return shared ? *p : __ldcg(p);
}

// Lanes [g0, g0 + 16) of a source row whose lanes [0, n) hold data (zero
// elsewhere), as four little-endian words: 16/vec aligned loads where all
// 16 lie inside, bytes at a ragged edge or where rows are byte-aligned.
template <bool COHERENT>
__device__ __forceinline__ uint4 stencil_ld16(const uint8_t* row, int g0,
                                              int n, int vec) {
  const bool shared = COHERENT && __isShared(row);
  if (g0 >= 0 && g0 + 16 <= n && vec > 1) {
    const uint8_t* p = row + g0;
    if (vec == 16)
      return stencil_ldv<COHERENT>(reinterpret_cast<const uint4*>(p), shared);
    if (vec == 8) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 a = stencil_ldv<COHERENT>(q, shared);
      const uint2 b = stencil_ldv<COHERENT>(q + 1, shared);
      return make_uint4(a.x, a.y, b.x, b.y);
    }
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    return make_uint4(stencil_ldv<COHERENT>(q, shared),
                      stencil_ldv<COHERENT>(q + 1, shared),
                      stencil_ldv<COHERENT>(q + 2, shared),
                      stencil_ldv<COHERENT>(q + 3, shared));
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int l = g0 + i;
    uint32_t b = 0;
    if ((unsigned)l < (unsigned)n)
      b = COHERENT ? stencil_ldv<true>(row + l, shared) : row[l];
    w[i >> 2] |= b << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store 16 bytes to global lanes [e0, e0 + 16) of a row, only lanes in
// [lo, hi).
__device__ __forceinline__ void stencil_st16(uint8_t* row, int e0, int lo,
                                             int hi, int vec, uint4 v) {
  if (e0 >= lo && e0 + 16 <= hi && vec > 1) {
    uint8_t* p = row + e0;
    if (vec == 16) {
      *reinterpret_cast<uint4*>(p) = v;
    } else if (vec == 8) {
      reinterpret_cast<uint2*>(p)[0] = make_uint2(v.x, v.y);
      reinterpret_cast<uint2*>(p)[1] = make_uint2(v.z, v.w);
    } else {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
    }
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int l = e0 + i;
    if (l >= lo && l < hi) row[l] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
  }
}

// Shared bytes [c, c + 16) of a tile row of L bytes: store, only lanes
// inside [0, L), with the widest access the address allows.
__device__ __forceinline__ void stencil_sts16(uint8_t* row, int c, int L,
                                              uint4 v) {
  if (c >= 0 && c + 16 <= L) {
    uint8_t* p = row + c;
    const unsigned a = (unsigned)(size_t)p & 15;
    if (a == 0) {
      *reinterpret_cast<uint4*>(p) = v;
      return;
    }
    if ((a & 7) == 0) {
      reinterpret_cast<uint2*>(p)[0] = make_uint2(v.x, v.y);
      reinterpret_cast<uint2*>(p)[1] = make_uint2(v.z, v.w);
      return;
    }
    if ((a & 3) == 0) {
      uint32_t* q = reinterpret_cast<uint32_t*>(p);
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
      return;
    }
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((unsigned)(c + i) < (unsigned)L)
      row[c + i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

// ... and load (zero outside [0, L)).
__device__ __forceinline__ uint4 stencil_lds16(const uint8_t* row, int c,
                                               int L) {
  if (c >= 0 && c + 16 <= L) {
    const uint8_t* p = row + c;
    const unsigned a = (unsigned)(size_t)p & 15;
    if (a == 0) return *reinterpret_cast<const uint4*>(p);
    if ((a & 7) == 0) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[0];
      const uint2 y = reinterpret_cast<const uint2*>(p)[1];
      return make_uint4(x.x, x.y, y.x, y.y);
    }
    if ((a & 3) == 0) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((unsigned)(c + i) < (unsigned)L)
      w[i >> 2] |= (uint32_t)row[c + i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared words [c, c + 16) of a packed row of L words: store, only lanes
// inside [0, L).
__device__ __forceinline__ void stencil_sts16w(uint32_t* row, int c, int L,
                                               const uint32_t (&w)[16]) {
  uint32_t* p = row + c;
  if (c >= 0 && c + 16 <= L && ((unsigned)(size_t)p & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if ((unsigned)(c + i) < (unsigned)L) p[i] = w[i];
}

// ... and load (zero outside [0, L)).
__device__ __forceinline__ void stencil_lds16w(const uint32_t* row, int c,
                                               int L, uint32_t (&w)[16]) {
  const uint32_t* p = row + c;
  if (c >= 0 && c + 16 <= L && ((unsigned)(size_t)p & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = (unsigned)(c + i) < (unsigned)L ? p[i] : 0u;
}

// Four bytes a0..a3 of row 2q and b0..b3 of row 2q+1 -> the words
// a_i | b_i << 16 of lanes i.
__device__ __forceinline__ void stencil_pack4(uint32_t a, uint32_t b,
                                              uint32_t* w) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  w[0] = __byte_perm(t0, 0, 0x4140);              // a0 0 b0 0
  w[1] = __byte_perm(t0, 0, 0x4342);
  w[2] = __byte_perm(t1, 0, 0x4140);
  w[3] = __byte_perm(t1, 0, 0x4342);
}

// Sixteen words of lanes i -> the bytes of row 2q (low fields) and of row
// 2q+1 (high fields).
__device__ __forceinline__ void stencil_unpack16(const uint32_t (&w)[16],
                                                 uint4& lo, uint4& hi) {
  uint32_t l[4], u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = __byte_perm(w[4 * i], w[4 * i + 1], 0x6240);
    const uint32_t y = __byte_perm(w[4 * i + 2], w[4 * i + 3], 0x6240);
    l[i] = __byte_perm(x, y, 0x5410);
    u[i] = __byte_perm(x, y, 0x7632);
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(u[0], u[1], u[2], u[3]);
}

// The 16-lane chunks a tile row of L lanes starting at bounds lane cbase
// touches: chunk j covers bounds lanes [16 * (j0 + j), +16), j < *nc.
__device__ __forceinline__ int stencil_chunks(int lo, int hi, int* nc) {
  const int j0 = stencil_floor16(lo);
  *nc = hi > lo ? stencil_floor16(hi - 1) - j0 + 1 : 0;
  return j0;
}

// Load the R x L byte tile whose row 0, lane 0 is bounds (rbase, cbase).
template <class Bounds>
__device__ __forceinline__ void stencil_load_rows(const Bounds& b,
                                                  uint8_t* cur, int R, int L,
                                                  int rbase, int cbase) {
  int nc;
  const int j0 = stencil_chunks(cbase, cbase + L, &nc);
  const int n = b.load_wc();
  stencil_for_chunks(R, nc, [&](int r, int j) {
    const uint8_t* src = b.load_row(rbase + r);
    const int g0 = (j0 + j) * 16;
    const uint4 v = src ? stencil_ld16<Bounds::coherent>(src, g0, n,
                                                         b.load_vec)
                        : make_uint4(0, 0, 0, 0);
    stencil_sts16(cur + r * L, g0 - cbase, L, v);
  });
}

// Store tile rows [r_lo, r_lo + nrows) x lanes [gl, gl + tile_w).
template <class Bounds>
__device__ __forceinline__ void stencil_store_rows(
    const Bounds& b, const uint8_t* cur, int L, int rbase, int cbase,
    int r_lo, int nrows, int gl, int tile_w) {
  const int d0 = cbase + gl - b.store_off();  // destination lane of lane gl
  const int dhi = min(d0 + tile_w, b.store_wc());
  int nc;
  const int j0 = stencil_chunks(d0, dhi, &nc);
  const int shift = cbase - b.store_off();  // tile lane = dst lane - shift
  stencil_for_chunks(nrows, nc, [&](int i, int j) {
    uint8_t* dst = b.store_row(rbase + r_lo + i);
    if (!dst) return;
    const int e0 = (j0 + j) * 16;
    const uint4 v = stencil_lds16(cur + (r_lo + i) * L, e0 - shift, L);
    stencil_st16(dst, e0, d0, dhi, b.store_vec, v);
  });
}

// Load the tile's Q row pairs into packed words, and zero the pad pairs
// P[-1] and P[Q].
template <class Bounds>
__device__ __forceinline__ void stencil_load_pairs(const Bounds& b,
                                                   uint32_t* P, int Q, int L,
                                                   int rbase, int cbase) {
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    P[-L + c] = 0;
    P[Q * L + c] = 0;
  }
  int nc;
  const int j0 = stencil_chunks(cbase, cbase + L, &nc);
  const int n = b.load_wc();
  stencil_for_chunks(Q, nc, [&](int q, int j) {
    const uint8_t* ra = b.load_row(rbase + 2 * q);
    const uint8_t* rb = b.load_row(rbase + 2 * q + 1);
    const int g0 = (j0 + j) * 16;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4 lo =
        ra ? stencil_ld16<Bounds::coherent>(ra, g0, n, b.load_vec) : zero;
    const uint4 hi =
        rb ? stencil_ld16<Bounds::coherent>(rb, g0, n, b.load_vec) : zero;
    uint32_t w[16];
    stencil_pack4(lo.x, hi.x, w);
    stencil_pack4(lo.y, hi.y, w + 4);
    stencil_pack4(lo.z, hi.z, w + 8);
    stencil_pack4(lo.w, hi.w, w + 12);
    stencil_sts16w(P + q * L, g0 - cbase, L, w);
  });
}

// Store tile rows [r_lo, r_lo + nrows) x lanes [gl, gl + tile_w) from the
// packed pairs.
template <class Bounds>
__device__ __forceinline__ void stencil_store_pairs(
    const Bounds& b, const uint32_t* P, int L, int rbase, int cbase,
    int r_lo, int nrows, int gl, int tile_w) {
  const int d0 = cbase + gl - b.store_off();
  const int dhi = min(d0 + tile_w, b.store_wc());
  int nc;
  const int j0 = stencil_chunks(d0, dhi, &nc);
  const int shift = cbase - b.store_off();
  const int r_hi = r_lo + nrows;
  const int qa = r_lo / 2, qb = (r_hi + 1) / 2;
  stencil_for_chunks(qb - qa, nc, [&](int i, int j) {
    const int ra = 2 * (qa + i), rb = ra + 1;
    uint8_t* da = ra >= r_lo ? b.store_row(rbase + ra) : nullptr;
    uint8_t* db = rb < r_hi ? b.store_row(rbase + rb) : nullptr;
    if (!da && !db) return;
    const int e0 = (j0 + j) * 16;
    uint32_t w[16];
    stencil_lds16w(P + (qa + i) * L, e0 - shift, L, w);
    uint4 lo, hi;
    stencil_unpack16(w, lo, hi);
    if (da) stencil_st16(da, e0, d0, dhi, b.store_vec, lo);
    if (db) stencil_st16(db, e0, d0, dhi, b.store_vec, hi);
  });
}

// The pair (row 2j+1, row 2j+2) from the words of pairs j and j+1: the high
// field of `a` under the low field of `b`.
__device__ __forceinline__ uint32_t stencil_straddle(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

// swar rows pass of one lane on packed words: T[q] = sum_i row_taps[i] *
// W[2q-h+i] for q in [q0, q1), where W[r] is the pair (row r, row r+1): the
// word of pair r/2 for even r, a straddle for odd r. With KT fixed the
// windows of both live in registers, so each packed word is read from
// shared memory once.
template <int KT>
__device__ __forceinline__ void stencil_swar_rows(const uint32_t* P,
                                                  uint32_t* T,
                                                  const StencilParams& p,
                                                  int L, int q0, int q1,
                                                  int k) {
  uint32_t* out = T + q0 * L;
  if constexpr (KT > 0) {
    constexpr int h = KT / 2;
    constexpr int hp = (h + 1) / 2;  // pairs read on each side of pair q
    constexpr int M = 2 * hp + 1;
    const uint32_t* in = P + (q0 - hp) * L;
    uint32_t pw[M], sw[M];  // sw[M-1] is never set: only a dead read names it
#pragma unroll
    for (int i = 0; i + 1 < M; ++i) pw[i] = in[i * L];
#pragma unroll
    for (int i = 0; i + 2 < M; ++i) sw[i] = stencil_straddle(pw[i], pw[i + 1]);
    sw[M - 1] = 0;
    for (int q = q0; q < q1; ++q, in += L, out += L) {
      pw[M - 1] = in[(M - 1) * L];
      sw[M - 2] = stencil_straddle(pw[M - 2], pw[M - 1]);
      uint32_t acc = 0;
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        // Tap i reads W[2q + r], r = i - h: window slot hp + floor(r / 2),
        // a whole pair for even r and a straddle for odd r.
        const int j = hp + (i + h) / 2 - h;
        const uint32_t w = ((i + h) % 2 == 0) ? pw[j] : sw[j];
        acc += (uint32_t)p.row_taps[i] * w;
      }
      *out = acc;
#pragma unroll
      for (int i = 0; i + 1 < M; ++i) pw[i] = pw[i + 1];
#pragma unroll
      for (int i = 0; i + 2 < M; ++i) sw[i] = sw[i + 1];
    }
  } else {
    const int h = k / 2;
    for (int q = q0; q < q1; ++q, out += L) {
      uint32_t acc = 0;
      for (int i = 0; i < k; ++i) {
        const int r = 2 * q - h + i;  // >= -1: pair -1 is the zero pad
        const uint32_t* w = P + (r >> 1) * L;
        acc += (uint32_t)p.row_taps[i] *
               ((r & 1) ? stencil_straddle(w[0], w[L]) : w[0]);
      }
      *out = acc;
    }
  }
}

// Ablations of the swar body for the kernel lab (stencil_lab.cu, body
// `tile`), which times what each part of the shipped tile costs: no rows
// pass, no cols pass, no re-zero, or no rep at all. Each is WRONG OUTPUT;
// the kernels that ship build with all of them 0.
#ifndef STENCIL_ABL_NO_ROWS
#define STENCIL_ABL_NO_ROWS 0
#endif
#ifndef STENCIL_ABL_NO_COLS
#define STENCIL_ABL_NO_COLS 0
#endif
#ifndef STENCIL_ABL_NO_MASK
#define STENCIL_ABL_NO_MASK 0
#endif
#ifndef STENCIL_ABL_LOAD_STORE_ONLY
#define STENCIL_ABL_LOAD_STORE_ONLY 0
#endif

// Where a tile lies: its shared-memory extent and the bounds coordinates
// of its row 0 and lane 0, for output origin (row0, col0) at `fuse` reps.
struct StencilTileFrame {
  int gr, gl;        // ghost rows and lanes per side
  int R, L;          // tile rows and lanes in shared memory
  int rbase, cbase;  // bounds row of tile row 0, bounds lane of tile lane 0
};

__device__ __forceinline__ StencilTileFrame stencil_tile_frame(
    const StencilGeometry& g, int h, int row0, int col0, int fuse) {
  const int gr = fuse * h, gl = gr * g.channels;
  return {gr, gl, g.tile_h + 2 * gr, g.tile_w + 2 * gl, row0 - gr,
          col0 - gl};
}

// The tile's carry in shared memory: under swar the packed pairs P (P[-1]
// and P[Q] are zero pad pairs), else the uint8 rows after the intermediate.
template <int BODY>
__device__ __forceinline__ unsigned char* stencil_tile_carry(
    unsigned char* smem, const StencilTileFrame& f) {
  if constexpr (BODY == STENCIL_BODY_SWAR) {
    return smem + (size_t)f.L * sizeof(uint32_t);
  } else {
    using acc_t = typename std::conditional<BODY == STENCIL_BODY_ACC16,
                                            int16_t, int>::type;
    return smem + (size_t)f.R * f.L * sizeof(acc_t);
  }
}

struct StencilNoHook {
  __device__ __forceinline__ void operator()() const {}
};

// Load one tile whose output origin is (row0, col0) in the bounds'
// coordinates and run `fuse` reps on it in shared memory; g supplies
// tile_h, tile_w and channels. KT > 0 fixes the filter size at compile time
// (taps loops unroll); KT == 0 reads it from p.k. BODY is one of
// STENCIL_BODY_*, and the plan must pass stencil_body_runs for it. Every
// thread calls after_load() once the tile is loaded and before the first
// rep (the lab's band flushes the lanes it held back there); every rep
// ends in a barrier. The result stays in shared memory for
// stencil_tile_store.
template <int KT, int BODY, class Bounds, class Hook>
__device__ void stencil_tile_compute(const Bounds& b, const StencilParams& p,
                                     const StencilGeometry& g, int row0,
                                     int col0, int fuse, unsigned char* smem,
                                     Hook after_load) {
  const int k = KT > 0 ? KT : p.k;
  const int h = k / 2;
  const int C = g.channels;
  const int hc = h * C;
  const StencilTileFrame f = stencil_tile_frame(g, h, row0, col0, fuse);
  const int R = f.R, L = f.L, rbase = f.rbase, cbase = f.cbase;

  if constexpr (BODY == STENCIL_BODY_SWAR) {
    const int Q = R / 2;  // R is even: tile_h is (stencil_body_runs)
    // P[-1] and P[Q] are zero pad pairs: a pass over whole pairs reads one
    // pair past the band, into rows whose results nothing trusted reads.
    uint32_t* P =
        reinterpret_cast<uint32_t*>(stencil_tile_carry<BODY>(smem, f));
    uint32_t* T = P + (size_t)(Q + 1) * L;
    stencil_load_pairs(b, P, Q, L, rbase, cbase);
    __syncthreads();
    after_load();
    for (int t = 1; t <= fuse && !STENCIL_ABL_LOAD_STORE_ONLY; ++t) {
      const int r0 = t * h, r1 = R - t * h;
      const int q0 = r0 / 2, q1 = (r1 + 1) / 2;  // the pairs over the band
      const int c0 = t * hc, c1 = L - t * hc;
      for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x) {
        if (STENCIL_ABL_NO_ROWS) {
          for (int q = q0; q < q1; ++q) T[q * L + c] = P[q * L + c];
        } else {
          stencil_swar_rows<KT>(P + c, T + c, p, L, q0, q1, k);
        }
      }
      __syncthreads();
      // The cols pass of one packed word; `row` is lane c - h*C.
      auto cols = [&](const uint32_t* row) {
        uint32_t acc = 0;
        if (STENCIL_ABL_NO_COLS) return row[hc];
#pragma unroll
        for (int j = 0; j < (KT > 0 ? KT : STENCIL_MAX_K); ++j) {
          if (KT == 0 && j >= k) break;
          acc += (uint32_t)p.col_taps[j] * row[j * C];
        }
        return acc;
      };
      // A band whose rows all lie inside the image (most tiles) masks
      // lanes only; the others test each row as they walk.
      const bool rows_kept =
          STENCIL_ABL_NO_MASK || b.rows_kept(rbase + 2 * q0, rbase + 2 * q1);
      for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
        const bool lane_kept = STENCIL_ABL_NO_MASK || b.lane_kept(cbase + c);
        const uint32_t* row = T + q0 * L + c - hc;
        uint32_t* out = P + q0 * L + c;
        if (rows_kept) {
          const uint32_t m = lane_kept ? 0x00FF00FFu : 0u;
          for (int q = q0; q < q1; ++q, row += L, out += L)
            *out = (cols(row) >> p.shift) & m;
          continue;
        }
        int phase = b.keep_phase(rbase + 2 * q0);
        for (int q = q0; q < q1; ++q, row += L, out += L) {
          const bool lo = b.keep_step(rbase + 2 * q, phase);
          const bool hi = b.keep_step(rbase + 2 * q + 1, phase);
          const uint32_t m = lane_kept ? (lo ? 0x000000FFu : 0u) |
                                             (hi ? 0x00FF0000u : 0u)
                                       : 0u;
          *out = (cols(row) >> p.shift) & m;
        }
      }
      __syncthreads();
    }
  } else {
    using acc_t = typename std::conditional<BODY == STENCIL_BODY_ACC16,
                                            int16_t, int>::type;
    acc_t* tmp = reinterpret_cast<acc_t*>(smem);
    uint8_t* cur = stencil_tile_carry<BODY>(smem, f);
    stencil_load_rows(b, cur, R, L, rbase, cbase);
    __syncthreads();
    after_load();
    for (int t = 1; t <= fuse; ++t) {
      const int r0 = t * h, r1 = R - t * h;
      const int c0 = t * hc, c1 = L - t * hc;
      if (BODY == STENCIL_BODY_ACC16 || p.kind == 0) {
        // Each thread owns lanes (stride blockDim.x) and walks down the
        // rows: the rows pass over the lanes the cols pass will read, ...
        for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x)
          stencil_rows_pass<KT>(cur + c, tmp + c, p, L, r0, r1, k);
        __syncthreads();
        // ... then the cols pass, taps at flat offsets j*C, and the finish
        // (rows tested only where the band leaves the image).
        auto cols = [&](const acc_t* row) {
          int acc = 0;
#pragma unroll
          for (int j = 0; j < (KT > 0 ? KT : STENCIL_MAX_K); ++j) {
            if (KT == 0 && j >= k) break;
            acc += p.col_taps[j] * (int)row[j * C];
          }
          return (uint8_t)stencil_finish(acc, p);
        };
        const bool rows_kept = b.rows_kept(rbase + r0, rbase + r1);
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
          const bool lane_kept = b.lane_kept(cbase + c);
          const acc_t* row = tmp + r0 * L + c - hc;
          uint8_t* out = cur + r0 * L + c;
          if (rows_kept) {
            for (int r = r0; r < r1; ++r, row += L, out += L)
              *out = lane_kept ? cols(row) : (uint8_t)0;
            continue;
          }
          int phase = b.keep_phase(rbase + r0);
          for (int r = r0; r < r1; ++r, row += L, out += L) {
            const bool kept = b.keep_step(rbase + r, phase);
            *out = lane_kept && kept ? cols(row) : (uint8_t)0;
          }
        }
        __syncthreads();
      } else if constexpr (BODY == STENCIL_BODY_INT32) {
        // Direct k*k taps read `cur`, so results go through `tmp`.
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
          const bool lane_kept = b.lane_kept(cbase + c);
          int phase = b.keep_phase(rbase + r0);
          for (int r = r0; r < r1; ++r) {
            const uint8_t* win = cur + (r - h) * L + c - hc;
            int acc = 0;
#pragma unroll
            for (int i = 0; i < (KT > 0 ? KT : STENCIL_MAX_K); ++i) {
              if (KT == 0 && i >= k) break;
#pragma unroll
              for (int j = 0; j < (KT > 0 ? KT : STENCIL_MAX_K); ++j) {
                if (KT == 0 && j >= k) break;
                acc += p.taps[i * k + j] * (int)win[i * L + j * C];
              }
            }
            const bool kept = b.keep_step(rbase + r, phase);
            tmp[r * L + c] = lane_kept && kept ? stencil_finish(acc, p) : 0;
          }
        }
        __syncthreads();
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x)
          for (int r = r0; r < r1; ++r) cur[r * L + c] = (uint8_t)tmp[r * L + c];
        __syncthreads();
      }
    }
  }
}

// Store output lanes [first, first + count) of every output row of the
// tile stencil_tile_compute left in shared memory (same origin and fuse).
template <int BODY, class Bounds>
__device__ __forceinline__ void stencil_tile_store(
    const Bounds& b, const StencilParams& p, const StencilGeometry& g,
    int row0, int col0, int fuse, unsigned char* smem, int first,
    int count) {
  const StencilTileFrame f = stencil_tile_frame(g, p.k / 2, row0, col0, fuse);
  unsigned char* carry = stencil_tile_carry<BODY>(smem, f);
  if constexpr (BODY == STENCIL_BODY_SWAR)
    stencil_store_pairs(b, reinterpret_cast<const uint32_t*>(carry), f.L,
                        f.rbase, f.cbase, f.gr, g.tile_h, f.gl + first,
                        count);
  else
    stencil_store_rows(b, carry, f.L, f.rbase, f.cbase, f.gr, g.tile_h,
                       f.gl + first, count);
}

// One whole tile: load, `fuse` reps, store the tile_h x tile_w interior.
template <int KT, int BODY, class Bounds>
__device__ void stencil_run_bounded_tile(const Bounds& b,
                                         const StencilParams& p,
                                         const StencilGeometry& g, int row0,
                                         int col0, int fuse,
                                         unsigned char* smem) {
  stencil_tile_compute<KT, BODY>(b, p, g, row0, col0, fuse, smem,
                                 StencilNoHook{});
  stencil_tile_store<BODY>(b, p, g, row0, col0, fuse, smem, 0, g.tile_w);
  __syncthreads();  // the next tile of this block reuses shared memory
}
