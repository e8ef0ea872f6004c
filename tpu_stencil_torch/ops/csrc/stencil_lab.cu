// L2 `stencil_lab`: the kernel lab's copy of K1, with the rep body chosen at
// compile time.
//
// Replaces the TPU kernel `_lab_kernel` (tools/kernel_lab.py, built by
// `build_variant`): K1's job, `fuse` reps of the zero-boundary stencil per
// tile and per trip through device memory, with the body of one rep picked
// per variant so that lowerings of the same integers can be timed against
// each other, and with ablations (wrong output, timing only) that drop one
// part of the rep to price it. What is carried over is the function and the
// idea of the variants; Mosaic's DMA double buffer, lane padding and sublane
// alignment are not. The tile is K1's (stencil_tile.cuh): load with ghosts,
// `fuse` reps in shared memory on a contracting band, store the interior;
// image bounds, geometry structs and the load/store policy are K1's own
// code.
//
// What bounds it on an H100: like K1, not the ~1 byte per element per
// `fuse` reps of device memory but the work inside the block: per element
// and rep the shared-memory loads and stores, tap multiply-adds, shift and
// mask; per tile the byte-wide load with its ghosts and the store of the
// interior; and how many blocks an SM holds to hide each other's barriers
// and latency. Every variant attacks one of those (instructions per element,
// bytes of shared memory per element), and a variant's body is fixed by -D
// macros at build time (one library per variant): a runtime switch would
// leave its branch in the inner loop and the lab would time a kernel nobody
// would ship. Geometry (tile height, fuse) stays a runtime argument as in
// K1.
//
//   -DLAB_BODY=0  current  K1's body: int32 rows-pass intermediate, taps as
//                          multiply-adds by runtime tap values.
//   -DLAB_BODY=1  pair     binomial taps as chains of pair adds, no
//                          multiplies (rows: a running chain down the lane;
//                          cols: a triangular chain in registers).
//   -DLAB_BODY=2  acc16    current with the rows-pass intermediate kept as
//                          int16 in shared memory: 3 bytes per element in
//                          place of 5, so more blocks per SM.
//   -DLAB_BODY=3  swar     two pixels per 32-bit word as two 16-bit fields:
//                          the rows 2q and 2q+1 of one lane. The carry and the
//                          intermediate both stay packed in shared memory for
//                          all `fuse` reps (4 bytes per element), so each
//                          shared load, multiply-add, shift, mask and store
//                          serves two pixels. Two adjacent rows, not two
//                          lanes: the cols pass moves by C lanes (odd for RGB
//                          and grey), which would split a lane pair across
//                          words, while a row pair stays whole under it; the
//                          rows pass needs the pair (2q+1, 2q+2), one
//                          byte-permute of two neighbouring words. Every field
//                          stays below 2^16 (non-negative taps of total
//                          weight 2^shift, shift <= 8); the right shift
//                          drags the high field's low bits into the low field
//                          and the boundary mask (0x00FF per kept row) ANDs
//                          them away.
//   -DLAB_NO_ROWS / -DLAB_NO_COLS   skip that pass's taps (centre tap only)
//   -DLAB_NO_MASK                   never re-zero outside the image
//   -DLAB_LOAD_STORE_ONLY           no rep at all: load the tile, store it
//
// Separable integer plans only, filter sizes 3, 5 and 7. Built with nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 into a shared library with a
// plain C interface (loaded with ctypes).

#include "stencil_tile.cuh"

#define LAB_CURRENT 0
#define LAB_PAIR 1
#define LAB_ACC16 2
#define LAB_SWAR 3

#ifndef LAB_BODY
#define LAB_BODY LAB_CURRENT
#endif
#ifndef LAB_NO_ROWS
#define LAB_NO_ROWS 0
#endif
#ifndef LAB_NO_COLS
#define LAB_NO_COLS 0
#endif
#ifndef LAB_NO_MASK
#define LAB_NO_MASK 0
#endif
#ifndef LAB_LOAD_STORE_ONLY
#define LAB_LOAD_STORE_ONLY 0
#endif

#if LAB_BODY == LAB_ACC16
typedef int16_t lab_acc_t;
#else
typedef int lab_acc_t;
#endif

// Shared-memory bytes of one tile (mirrored by ops/lab.py lab_smem_bytes).
__host__ __device__ inline size_t lab_tile_smem(const StencilParams& p,
                                               const StencilGeometry& g,
                                               int fuse) {
  const int h = p.k / 2;
  const size_t rr = (size_t)g.tile_h + 2 * fuse * h;
  const size_t ll = (size_t)g.tile_w + 2 * fuse * h * g.channels;
#if LAB_BODY == LAB_SWAR
  // Packed carry (row pairs plus one pad pair per end) and packed
  // intermediate, one 32-bit word per row pair and lane.
  return ((rr / 2 + 2) + rr / 2) * ll * sizeof(uint32_t);
#else
  return rr * ll * (sizeof(lab_acc_t) + 1);
#endif
}

#if LAB_BODY != LAB_SWAR

// Rows pass of one lane (see stencil_rows_pass): out[r] for r in [r0, r1).
template <int KT>
__device__ __forceinline__ void lab_rows_pass(const uint8_t* cur,
                                              lab_acc_t* tmp,
                                              const StencilParams& p, int L,
                                              int r0, int r1) {
  [[maybe_unused]] constexpr int h = KT / 2;
  lab_acc_t* out = tmp + r0 * L;
#if LAB_NO_ROWS
  const uint8_t* in = cur + r0 * L;
  for (int r = r0; r < r1; ++r, in += L, out += L) *out = (lab_acc_t)*in;
#elif LAB_BODY == LAB_PAIR
  // Binomial taps as a chain of KT-1 pair adds: level d holds the last
  // value of the d-fold pair sum; pushing row r+h yields out[r].
  const uint8_t* in = cur + (r0 - h) * L;
  int lv[KT - 1];
#pragma unroll
  for (int d = 0; d + 1 < KT; ++d) lv[d] = 0;
  for (int r = r0 - (KT - 1); r < r1; ++r, in += L) {
    int x = *in;
#pragma unroll
    for (int d = 0; d + 1 < KT; ++d) {
      const int nx = lv[d] + x;
      lv[d] = x;
      x = nx;
    }
    if (r >= r0) {
      *out = x;
      out += L;
    }
  }
#else
  const uint8_t* in = cur + (r0 - h) * L;
  int win[KT];
#pragma unroll
  for (int i = 0; i + 1 < KT; ++i) win[i] = in[i * L];
  for (int r = r0; r < r1; ++r, in += L, out += L) {
    win[KT - 1] = in[(KT - 1) * L];
    int acc = 0;
#pragma unroll
    for (int i = 0; i < KT; ++i) acc += p.row_taps[i] * win[i];
    *out = (lab_acc_t)acc;
#pragma unroll
    for (int i = 0; i + 1 < KT; ++i) win[i] = win[i + 1];
  }
#endif
}

// Cols pass of one output element: `row` points at the intermediate of
// lane c - h*C in the element's row.
template <int KT>
__device__ __forceinline__ int lab_cols_acc(const lab_acc_t* row,
                                            const StencilParams& p, int C) {
#if LAB_NO_COLS
  return (int)row[(KT / 2) * C];
#elif LAB_BODY == LAB_PAIR
  int v[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) v[j] = row[j * C];
#pragma unroll
  for (int d = 1; d < KT; ++d) {
#pragma unroll
    for (int j = 0; j + d < KT; ++j) v[j] += v[j + 1];
  }
  return v[0];
#else
  int acc = 0;
#pragma unroll
  for (int j = 0; j < KT; ++j) acc += p.col_taps[j] * (int)row[j * C];
  return acc;
#endif
}

template <int KT>
__device__ void lab_run_tile(const StencilImageBounds<false>& b,
                             const StencilParams& p, const StencilGeometry& g,
                             int row0, int col0, int fuse,
                             unsigned char* smem) {
  constexpr int h = KT / 2;
  const int C = g.channels;
  [[maybe_unused]] const int hc = h * C;
  const int gr = fuse * h;
  const int gl = gr * C;
  const int R = g.tile_h + 2 * gr;
  const int L = g.tile_w + 2 * gl;
  const int rbase = row0 - gr;
  const int cbase = col0 - gl;
  [[maybe_unused]] lab_acc_t* tmp = reinterpret_cast<lab_acc_t*>(smem);
  uint8_t* cur = smem + (size_t)R * L * sizeof(lab_acc_t);

  stencil_for_region(0, R, 0, L, [&](int r, int c) {
    cur[r * L + c] = b.load(rbase + r, cbase + c);
  });
  __syncthreads();

#if !LAB_LOAD_STORE_ONLY
  for (int t = 1; t <= fuse; ++t) {
    const int r0 = t * h, r1 = R - t * h;
    const int c0 = t * hc, c1 = L - t * hc;
    for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x)
      lab_rows_pass<KT>(cur + c, tmp + c, p, L, r0, r1);
    __syncthreads();
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
#if !LAB_NO_MASK
      const bool lane_kept = b.lane_kept(cbase + c);
#endif
      const lab_acc_t* row = tmp + r0 * L + c - hc;
      uint8_t* out = cur + r0 * L + c;
      for (int r = r0; r < r1; ++r, row += L, out += L) {
        const int v = stencil_finish(lab_cols_acc<KT>(row, p, C), p);
#if LAB_NO_MASK
        *out = (uint8_t)v;
#else
        *out = lane_kept && b.row_kept(rbase + r) ? (uint8_t)v : (uint8_t)0;
#endif
      }
    }
    __syncthreads();
  }
#endif

  stencil_for_region(gr, gr + g.tile_h, gl, gl + g.tile_w, [&](int r, int c) {
    b.store(rbase + r, cbase + c, cur[r * L + c]);
  });
}

#else  // LAB_BODY == LAB_SWAR

// The pair (row 2j+1, row 2j+2) from the words of pairs j and j+1: the high
// field of `a` under the low field of `b`.
__device__ __forceinline__ uint32_t lab_straddle(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

// Rows pass of one lane on packed words: T[q] = sum_i row_taps[i] * W[2q-h+i]
// for q in [q0, q1), where W[r] is the pair (row r, row r+1): the word of
// pair r/2 for even r, a straddle for odd r. Windows of both live in
// registers, so each packed word is read from shared memory once.
template <int KT>
__device__ __forceinline__ void lab_swar_rows(const uint32_t* P, uint32_t* T,
                                              const StencilParams& p, int L,
                                              int q0, int q1) {
  uint32_t* out = T + q0 * L;
#if LAB_NO_ROWS
  const uint32_t* in = P + q0 * L;
  for (int q = q0; q < q1; ++q, in += L, out += L) *out = *in;
#else
  constexpr int h = KT / 2;
  constexpr int hp = (h + 1) / 2;  // pairs read on each side of pair q
  constexpr int M = 2 * hp + 1;
  const uint32_t* in = P + (q0 - hp) * L;
  uint32_t pw[M], sw[M];  // sw[M-1] is never set: only a dead read names it
#pragma unroll
  for (int i = 0; i + 1 < M; ++i) pw[i] = in[i * L];
#pragma unroll
  for (int i = 0; i + 2 < M; ++i) sw[i] = lab_straddle(pw[i], pw[i + 1]);
  sw[M - 1] = 0;
  for (int q = q0; q < q1; ++q, in += L, out += L) {
    pw[M - 1] = in[(M - 1) * L];
    sw[M - 2] = lab_straddle(pw[M - 2], pw[M - 1]);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      // Tap i reads W[2q + r], r = i - h: window slot hp + floor(r / 2),
      // a whole pair for even r and a straddle for odd r (all known once
      // the loop is unrolled).
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
#endif
}

template <int KT>
__device__ void lab_run_tile(const StencilImageBounds<false>& b,
                             const StencilParams& p, const StencilGeometry& g,
                             int row0, int col0, int fuse,
                             unsigned char* smem) {
  constexpr int h = KT / 2;
  const int C = g.channels;
  [[maybe_unused]] const int hc = h * C;
  const int gr = fuse * h;
  const int gl = gr * C;
  const int R = g.tile_h + 2 * gr;  // even: the launch checks tile_h
  const int L = g.tile_w + 2 * gl;
  const int Q = R / 2;
  const int rbase = row0 - gr;
  const int cbase = col0 - gl;
  // P[-1] and P[Q] are zero pad pairs: a pass over whole pairs reads one
  // pair past the band, into rows whose results nothing trusted reads.
  uint32_t* P = reinterpret_cast<uint32_t*>(smem) + L;
  [[maybe_unused]] uint32_t* T = P + (size_t)(Q + 1) * L;

  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    P[-L + c] = 0;
    P[Q * L + c] = 0;
  }
  stencil_for_region(0, Q, 0, L, [&](int q, int c) {
    const uint32_t lo = b.load(rbase + 2 * q, cbase + c);
    const uint32_t hi = b.load(rbase + 2 * q + 1, cbase + c);
    P[q * L + c] = lo | (hi << 16);
  });
  __syncthreads();

#if !LAB_LOAD_STORE_ONLY
  for (int t = 1; t <= fuse; ++t) {
    const int r0 = t * h, r1 = R - t * h;
    const int q0 = r0 / 2, q1 = (r1 + 1) / 2;  // the pairs covering the band
    const int c0 = t * hc, c1 = L - t * hc;
    for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x)
      lab_swar_rows<KT>(P + c, T + c, p, L, q0, q1);
    __syncthreads();
    for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
#if !LAB_NO_MASK
      const bool lane_kept = b.lane_kept(cbase + c);
#endif
      const uint32_t* row = T + q0 * L + c - hc;
      uint32_t* out = P + q0 * L + c;
      for (int q = q0; q < q1; ++q, row += L, out += L) {
#if LAB_NO_COLS
        uint32_t acc = row[hc];
#else
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < KT; ++j)
          acc += (uint32_t)p.col_taps[j] * row[j * C];
#endif
#if LAB_NO_MASK
        const uint32_t m = 0x00FF00FFu;
#else
        uint32_t m = 0;
        if (lane_kept) {
          m = (b.row_kept(rbase + 2 * q) ? 0x000000FFu : 0u) |
              (b.row_kept(rbase + 2 * q + 1) ? 0x00FF0000u : 0u);
        }
#endif
        *out = (acc >> p.shift) & m;
      }
    }
    __syncthreads();
  }
#endif

  stencil_for_region(gr, gr + g.tile_h, gl, gl + g.tile_w, [&](int r, int c) {
    const uint32_t w = P[(r >> 1) * L + c];
    b.store(rbase + r, cbase + c, (uint8_t)((r & 1) ? (w >> 16) : w));
  });
}

#endif  // LAB_BODY

template <int KT>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_lab_kernel(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, StencilParams p,
                       StencilGeometry g, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StencilImageBounds<false> b{src, dst, g};
  lab_run_tile<KT>(b, p, g, blockIdx.y * g.tile_h, blockIdx.x * g.tile_w,
                   fuse, smem);
}

template <int KT>
static int launch(const uint8_t* src, uint8_t* dst, const StencilParams& p,
                  const StencilGeometry& g, int fuse, cudaStream_t stream) {
  const size_t smem = lab_tile_smem(p, g, fuse);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)stencil_lab_kernel<KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(stencil_ceil_div(g.wc, g.tile_w),
                  stencil_ceil_div(g.rows, g.tile_h));
  stencil_lab_kernel<KT><<<grid, stencil_block_threads(p, g, fuse), smem,
                           stream>>>(src, dst, p, g, fuse);
  return (int)cudaGetLastError();
}

extern "C" {

// One launch of this library's variant: `fuse` reps from src to dst
// (distinct buffers). Returns the cudaError_t of the launch (0 = launched).
int stencil_lab_launch(const void* src, void* dst, const StencilParams* p,
                       const StencilGeometry* g, int fuse, void* stream) {
  if (fuse < 1 || p->kind != 0 || g->tile_h < 2 || g->tile_h % 2 ||
      g->tile_w < 1)
    return (int)cudaErrorInvalidValue;
#if LAB_BODY == LAB_SWAR
  if (p->shift < 0 || p->shift > 8 || p->clip)
    return (int)cudaErrorInvalidValue;
#endif
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->k) {
    case 3: return launch<3>(s, d, *p, *g, fuse, st);
    case 5: return launch<5>(s, d, *p, *g, fuse, st);
    case 7: return launch<7>(s, d, *p, *g, fuse, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes a launch asks for (so the host model can be held
// against the kernel's own).
long long stencil_lab_smem(const StencilParams* p, const StencilGeometry* g,
                           int fuse) {
  return (long long)lab_tile_smem(*p, *g, fuse);
}

const char* stencil_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
