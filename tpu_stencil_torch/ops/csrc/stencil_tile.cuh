// One tile of the iterated zero-boundary stencil, shared by the fused
// kernel (stencil_fused.cu), the resident kernel (stencil_resident.cu) and
// the valid-ghost kernel (stencil_valid.cu).
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
// stores, is the kernel's bounds policy (a struct with load, row_kept,
// lane_kept and store, in the tile's own row/lane coordinates):
// StencilImageBounds for K1 and K2 — zero ghosts at load, rows < 0 or
// >= rows_real, lanes outside [0, wc), and under frames the gap rows where
// row % frame_stride >= frame_h — and StencilValidBounds in
// stencil_valid.cu for K3.
// Shared memory holds the uint8 carry `cur` (R x L) and the int32
// rows-pass intermediate `tmp` (R x L): 5 * R * L bytes. For separable
// plans each thread owns whole lanes of the tile and walks down its rows,
// keeping the rows-pass window in registers: no per-element index
// arithmetic, and each carry byte is read once per rep.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define STENCIL_MAX_K 15
#define STENCIL_MAX_THREADS 512

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

// Shared-memory bytes of one tile at this fuse depth.
__host__ __device__ inline size_t stencil_tile_smem(const StencilParams& p,
                                                   const StencilGeometry& g,
                                                   int fuse) {
  const int h = p.k / 2;
  const size_t rr = (size_t)g.tile_h + 2 * fuse * h;
  const size_t ll = (size_t)g.tile_w + 2 * fuse * h * g.channels;
  return rr * ll * 5;
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

__device__ __forceinline__ bool stencil_row_kept(const StencilGeometry& g,
                                                 int row) {
  if ((unsigned)row >= (unsigned)g.rows_real) return false;
  return g.frame_stride <= 0 || row % g.frame_stride < g.frame_h;
}

__device__ __forceinline__ bool stencil_kept(const StencilGeometry& g,
                                             int row, int lane) {
  return (unsigned)lane < (unsigned)g.wc && stencil_row_kept(g, row);
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

// COHERENT loads bypass L1 (ld.global.cg): the resident kernel reads, in
// one launch, buffers that other blocks wrote before the last grid sync.
template <bool COHERENT>
__device__ __forceinline__ uint8_t stencil_load(const uint8_t* p) {
  if (COHERENT) return __ldcg(p);
  return *p;
}

// Rows pass of one lane: out[r] = sum_i row_taps[i] * in[r - h + i] for r in
// [r0, r1), with `cur`/`tmp` pointing at the lane and rows L apart. With the
// filter size fixed at compile time the window lives in registers, so each
// carry byte is read from shared memory once.
template <int KT>
__device__ __forceinline__ void stencil_rows_pass(const uint8_t* cur,
                                                  int* tmp,
                                                  const StencilParams& p,
                                                  int L, int r0, int r1,
                                                  int k) {
  const uint8_t* in = cur + (r0 - k / 2) * L;
  int* out = tmp + r0 * L;
  if constexpr (KT > 0) {
    int win[KT];
#pragma unroll
    for (int i = 0; i + 1 < KT; ++i) win[i] = in[i * L];
    for (int r = r0; r < r1; ++r, in += L, out += L) {
      win[KT - 1] = in[(KT - 1) * L];
      int acc = 0;
#pragma unroll
      for (int i = 0; i < KT; ++i) acc += p.row_taps[i] * win[i];
      *out = acc;
#pragma unroll
      for (int i = 0; i + 1 < KT; ++i) win[i] = win[i + 1];
    }
  } else {
    for (int r = r0; r < r1; ++r, in += L, out += L) {
      int acc = 0;
      for (int i = 0; i < k; ++i) acc += p.row_taps[i] * (int)in[i * L];
      *out = acc;
    }
  }
}

// The bounds of K1 and K2: tile coordinates are image coordinates; ghosts
// outside the image load as zero and every rep re-zeroes them.
template <bool COHERENT>
struct StencilImageBounds {
  const uint8_t* src;
  uint8_t* dst;
  const StencilGeometry& g;

  __device__ __forceinline__ uint8_t load(int row, int lane) const {
    return stencil_kept(g, row, lane)
               ? stencil_load<COHERENT>(src + (size_t)row * g.wc + lane)
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

// One tile whose output origin is (row0, col0) in the bounds' coordinates;
// g supplies tile_h, tile_w and channels. KT > 0 fixes the filter size at
// compile time (taps loops unroll); KT == 0 reads it from p.k.
template <int KT, class Bounds>
__device__ void stencil_run_bounded_tile(const Bounds& b,
                                         const StencilParams& p,
                                         const StencilGeometry& g, int row0,
                                         int col0, int fuse, uint8_t* cur,
                                         int* tmp) {
  const int k = KT > 0 ? KT : p.k;
  const int h = k / 2;
  const int C = g.channels;
  const int hc = h * C;
  const int gr = fuse * h;           // ghost rows per side
  const int gl = gr * C;             // ghost lanes per side
  const int R = g.tile_h + 2 * gr;   // tile rows in shared memory
  const int L = g.tile_w + 2 * gl;   // tile lanes in shared memory
  const int rbase = row0 - gr;       // bounds row of tile row 0
  const int cbase = col0 - gl;       // bounds lane of tile lane 0

  stencil_for_region(0, R, 0, L, [&](int r, int c) {
    cur[r * L + c] = b.load(rbase + r, cbase + c);
  });
  __syncthreads();

  for (int t = 1; t <= fuse; ++t) {
    const int r0 = t * h, r1 = R - t * h;
    const int c0 = t * hc, c1 = L - t * hc;
    if (p.kind == 0) {
      // Each thread owns lanes (stride blockDim.x) and walks down the rows:
      // the rows pass over the lanes the cols pass will read, ...
      for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x)
        stencil_rows_pass<KT>(cur + c, tmp + c, p, L, r0, r1, k);
      __syncthreads();
      // ... then the cols pass, taps at flat offsets j*C, and the finish.
      for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
        const bool lane_kept = b.lane_kept(cbase + c);
        const int* row = tmp + r0 * L + c - hc;
        uint8_t* out = cur + r0 * L + c;
        for (int r = r0; r < r1; ++r, row += L, out += L) {
          int acc = 0;
#pragma unroll
          for (int j = 0; j < (KT > 0 ? KT : STENCIL_MAX_K); ++j) {
            if (KT == 0 && j >= k) break;
            acc += p.col_taps[j] * row[j * C];
          }
          *out = lane_kept && b.row_kept(rbase + r)
                     ? (uint8_t)stencil_finish(acc, p)
                     : (uint8_t)0;
        }
      }
      __syncthreads();
    } else {
      // Direct k*k taps read `cur`, so results go through `tmp`.
      stencil_for_region(r0, r1, c0, c1, [&](int r, int c) {
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
        tmp[r * L + c] = b.lane_kept(cbase + c) && b.row_kept(rbase + r)
                             ? stencil_finish(acc, p)
                             : 0;
      });
      __syncthreads();
      stencil_for_region(r0, r1, c0, c1, [&](int r, int c) {
        cur[r * L + c] = (uint8_t)tmp[r * L + c];
      });
      __syncthreads();
    }
  }

  stencil_for_region(gr, gr + g.tile_h, gl, gl + g.tile_w, [&](int r, int c) {
    b.store(rbase + r, cbase + c, cur[r * L + c]);
  });
  __syncthreads();  // the next tile of this block reuses shared memory
}

// K1 and K2: one tile of the image itself (tile coordinates = image
// coordinates). COHERENT loads bypass L1 (see stencil_load).
template <int KT, bool COHERENT>
__device__ __forceinline__ void stencil_run_tile(const uint8_t* src,
                                                 uint8_t* dst,
                                                 const StencilParams& p,
                                                 const StencilGeometry& g,
                                                 int row0, int col0, int fuse,
                                                 uint8_t* cur, int* tmp) {
  const StencilImageBounds<COHERENT> b{src, dst, g};
  stencil_run_bounded_tile<KT>(b, p, g, row0, col0, fuse, cur, tmp);
}

// Shared-memory layout of a tile: int32 `tmp` first (4-byte aligned), then
// the uint8 carry.
__device__ __forceinline__ void stencil_smem_split(unsigned char* smem,
                                                   const StencilParams& p,
                                                   const StencilGeometry& g,
                                                   int fuse, uint8_t** cur,
                                                   int** tmp) {
  const int h = p.k / 2;
  const int R = g.tile_h + 2 * fuse * h;
  const int L = g.tile_w + 2 * fuse * h * g.channels;
  *tmp = reinterpret_cast<int*>(smem);
  *cur = smem + (size_t)R * L * sizeof(int);
}
