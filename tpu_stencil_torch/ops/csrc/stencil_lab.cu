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
// alignment are not. The tile is the first port's K1 tile: load with ghosts
// byte by byte, `fuse` reps in shared memory on a contracting band, store
// the interior byte by byte, with the byte-wise image bounds and the
// geometry structs of stencil_tile.cuh. So `current` is K1 as it was before
// its tile was redesigned (the baseline of that redesign) and `swar` is the
// redesign's packed body without its 16-lane load and store.
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
//   -DLAB_BODY=4  tile     the shipped K1 itself (stencil_run_bounded_tile in
//                          its swar body, 16-lane load and store): exact, it
//                          is `shipped` in this harness; its ablations split
//                          the shipped tile's time.
//   -DLAB_BODY=5  band     not K1's harness: K2's job (the whole rep loop in
//                          one cooperative launch) with the image held in
//                          the blocks' shared memory across the rep loop,
//                          the counterpart of the TPU kernel's VMEM-resident
//                          image. One block per SM owns a band of whole rows
//                          (an even count, for swar's row pairs) that stays
//                          in its shared memory as uint8 from the first load
//                          to the last store, so the job reads the image once
//                          and writes it once. Each step the block walks its
//                          band in tiles of tile_w lanes (K1's tile in the
//                          plan's body, `fuse` reps as a trapezoid), each
//                          tile's result written back into the band; then it
//                          publishes its first and last fuse*halo rows to an
//                          edge buffer in device memory (double-buffered by
//                          sync parity) and, after the grid sync, reads its
//                          neighbours' edges as its ghost rows; bands are
//                          full width, so no ghost lanes cross blocks.
//                          Writing a tile back in place would overwrite the
//                          G = fuse*halo*C lanes the next tile to its right
//                          still reads as its left ghost lanes: those output
//                          lanes are held back in shared memory and written
//                          into the band once the next tile has loaded. It
//                          measured slower than K2 as shipped (the tile's
//                          load, packing and store recur every step from the
//                          band as from device memory, and one block per SM
//                          hides none of its barriers); it stays here to be
//                          timed against it. Every plan K2 takes, exact.
//   -DLAB_NO_ROWS / -DLAB_NO_COLS   skip that pass's taps (centre tap only)
//   -DLAB_NO_MASK                   never re-zero outside the image
//   -DLAB_LOAD_STORE_ONLY           no rep at all: load the tile, store it
//
// Bodies 0-4: separable integer plans only, filter sizes 3, 5 and 7.
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes).

#define LAB_CURRENT 0
#define LAB_PAIR 1
#define LAB_ACC16 2
#define LAB_SWAR 3
#define LAB_TILE 4
#define LAB_BAND 5

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

#if LAB_BODY == LAB_TILE
// The shipped tile's own ablation hooks (stencil_tile.cuh).
#define STENCIL_ABL_NO_ROWS LAB_NO_ROWS
#define STENCIL_ABL_NO_COLS LAB_NO_COLS
#define STENCIL_ABL_NO_MASK LAB_NO_MASK
#define STENCIL_ABL_LOAD_STORE_ONLY LAB_LOAD_STORE_ONLY
#endif

#include "stencil_tile.cuh"

#if LAB_BODY == LAB_BAND

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// Threads per block at most (one block per SM).
#define LAB_BAND_THREADS 1024

__host__ __device__ inline size_t lab_round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of the band form: the working tile (g.tile_h = band rows,
// g.tile_w = tile lanes), the band (band rows x wc rounded up to 16), the
// held-back lanes (band rows x fuse*halo*C). Mirrored by
// lab.band_smem_bytes.
__host__ __device__ inline size_t lab_band_tile_bytes(
    const StencilParams& p, const StencilGeometry& g, int fuse, int body) {
  return lab_round16(stencil_tile_smem(p, g, fuse, body));
}

__host__ __device__ inline size_t lab_band_smem(const StencilParams& p,
                                                const StencilGeometry& g,
                                                int fuse, int body) {
  const size_t br = g.tile_h;
  return lab_band_tile_bytes(p, g, fuse, body) + br * lab_round16(g.wc) +
         lab_round16(br * fuse * (p.k / 2) * g.channels);
}

// Rows of a band's tile: its own rows from the band in shared memory, the
// rows above and below from `up` and `down` (the source image on the first
// step, the neighbours' published edges after), zero outside the image;
// stores go to the rows at `st` (the band, or the held-back lanes).
struct LabBandBounds : StencilImageBounds {
  const uint8_t* band;  // shared: rows [r_lo, r_hi), stride bs
  const uint8_t* up;    // global: rows [r_lo - e, r_lo), stride wc
  const uint8_t* down;  // global: rows [r_hi, r_hi + e), stride wc
  uint8_t* st;          // store rows [r_lo, r_hi), stride st_stride
  int bs, r_lo, r_hi, e;
  int st_stride, st_off, st_wc;
  static constexpr bool coherent = true;

  __device__ __forceinline__ const uint8_t* load_row(int row) const {
    if (!stencil_row_kept(g, row)) return nullptr;
    if (row < r_lo) return up + (size_t)(row - (r_lo - e)) * g.wc;
    if (row >= r_hi) return down + (size_t)(row - r_hi) * g.wc;
    return band + (size_t)(row - r_lo) * bs;
  }
  __device__ __forceinline__ uint8_t* store_row(int row) const {
    return row >= r_lo && row < r_hi && row < g.rows
               ? st + (size_t)(row - r_lo) * st_stride
               : nullptr;
  }
  __device__ __forceinline__ int store_off() const { return st_off; }
  __device__ __forceinline__ int store_wc() const { return st_wc; }
};

// Rows [0, nrows) x lanes [0, wc) from a device buffer of stride wc into the
// band (shared, stride bs).
__device__ __forceinline__ void lab_rows_in(uint8_t* band, int bs,
                                            const uint8_t* src, int nrows,
                                            int wc, int vec) {
  stencil_for_chunks(nrows, stencil_ceil_div(wc, 16), [&](int r, int j) {
    const uint4 v = stencil_ld16<false>(src + (size_t)r * wc, 16 * j, wc, vec);
    stencil_sts16(band + (size_t)r * bs, 16 * j, wc, v);
  });
}

// ... and from the band out to a device buffer.
__device__ __forceinline__ void lab_rows_out(uint8_t* dst,
                                             const uint8_t* band, int bs,
                                             int nrows, int wc, int vec) {
  stencil_for_chunks(nrows, stencil_ceil_div(wc, 16), [&](int r, int j) {
    const uint4 v = stencil_lds16(band + (size_t)r * bs, 16 * j, wc);
    stencil_st16(dst + (size_t)r * wc, 16 * j, 0, wc, vec, v);
  });
}

template <int KT, int BODY>
__global__ void __launch_bounds__(LAB_BAND_THREADS, 1)
    lab_band_kernel(const uint8_t* src, uint8_t* out, uint8_t* edges,
                    StencilParams p, StencilGeometry g, int reps, int fuse,
                    int src_vec, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int h = p.k / 2, wc = g.wc;
  const int br = g.tile_h;                   // rows per band
  const int e = fuse * h;                    // edge rows per side
  const int n_bands = stencil_ceil_div(g.rows, br);
  const int band = blockIdx.x;               // the grid is one block per band
  const int r_lo = band * br, r_hi = r_lo + br;
  const int n_own = min(br, g.rows - r_lo);  // band rows inside the image
  const int bs = (int)lab_round16(wc);
  uint8_t* bandm = smem + lab_band_tile_bytes(p, g, fuse, BODY);
  uint8_t* held = bandm + (size_t)br * bs;
  const size_t edge_band = 2 * (size_t)e * wc;  // first e rows, last e rows
  const size_t edge_parity = n_bands * edge_band;
  const int tiles_x = stencil_ceil_div(wc, g.tile_w);
  const int steps = reps / fuse + reps % fuse;

  lab_rows_in(bandm, bs, src + (size_t)r_lo * wc, n_own, wc, src_vec);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int depth = s < reps / fuse ? fuse : 1;
    const int G = depth * h * g.channels;  // lanes held back per tile
    const uint8_t* up = nullptr;
    const uint8_t* down = nullptr;
    if (s == 0) {
      if (band > 0) up = src + (size_t)(r_lo - e) * wc;
      if (band + 1 < n_bands) down = src + (size_t)r_hi * wc;
    } else {
      const uint8_t* ed = edges + (s & 1) * edge_parity;
      if (band > 0) up = ed + (band - 1) * edge_band + (size_t)e * wc;
      if (band + 1 < n_bands) down = ed + (band + 1) * edge_band;
    }
    for (int j = 0; j < tiles_x; ++j) {
      const int col0 = j * g.tile_w;
      const bool last = j + 1 == tiles_x;
      const LabBandBounds b{{nullptr, nullptr, g, s ? vec : src_vec, 16},
                            bandm, up, down, bandm, bs, r_lo, r_hi, e,
                            bs, 0, last ? wc : col0 + g.tile_w - G};
      // Once this tile has loaded, the lanes the last tile held back go
      // into the band.
      auto flush = [&] {
        if (j == 0) return;
        const int n = br * G;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
          const int r = i / G, c = i - r * G;
          bandm[(size_t)r * bs + col0 - G + c] = held[i];
        }
      };
      stencil_tile_compute<KT, BODY>(b, p, g, r_lo, col0, depth, smem, flush);
      stencil_tile_store<BODY>(b, p, g, r_lo, col0, depth, smem, 0,
                               g.tile_w);
      if (!last && G > 0) {
        LabBandBounds hb = b;
        hb.st = held;
        hb.st_stride = G;
        hb.st_off = col0 + g.tile_w - G;
        hb.st_wc = G;
        hb.store_vec = 1;
        stencil_tile_store<BODY>(hb, p, g, r_lo, col0, depth, smem,
                                 g.tile_w - G, G);
      }
      __syncthreads();
    }
    if (s + 1 < steps) {
      if (e > 0) {
        uint8_t* ed = edges + ((s + 1) & 1) * edge_parity + band * edge_band;
        lab_rows_out(ed, bandm, bs, e, wc, vec);
        lab_rows_out(ed + (size_t)e * wc, bandm + (size_t)(br - e) * bs, bs,
                     e, wc, vec);
      }
      grid.sync();
    }
  }
  lab_rows_out(out + (size_t)r_lo * wc, bandm, bs, n_own, wc, vec);
}

template <int BODY>
static const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return (const void*)lab_band_kernel<3, BODY>;
    case 5: return (const void*)lab_band_kernel<5, BODY>;
    case 7: return (const void*)lab_band_kernel<7, BODY>;
    default: return (const void*)lab_band_kernel<0, BODY>;
  }
}

static const void* kernel_for(int k, int body) {
  switch (body) {
    case STENCIL_BODY_INT32: return kernel_for_k<STENCIL_BODY_INT32>(k);
    case STENCIL_BODY_ACC16: return kernel_for_k<STENCIL_BODY_ACC16>(k);
    case STENCIL_BODY_SWAR: return kernel_for_k<STENCIL_BODY_SWAR>(k);
    default: return nullptr;
  }
}

static int band_threads(const StencilParams& p, const StencilGeometry& g,
                        int fuse) {
  const int lanes = g.tile_w + 2 * fuse * (p.k / 2) * g.channels;
  const int t = (lanes + 31) / 32 * 32;
  return t < LAB_BAND_THREADS ? t : LAB_BAND_THREADS;
}

// The instance for (p, g, fuse, body) with its shared memory set, and the
// grid (one block per band), which must fit co-resident; nullptr (and
// *err) otherwise or when the arguments are out of range.
static const void* prepare(const StencilParams* p, const StencilGeometry* g,
                           int fuse, int body, size_t* smem, int* per_sm,
                           int* grid, int* err) {
  *err = (int)cudaErrorInvalidValue;
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || g->tile_h < 1 ||
      g->tile_w < 1 || body < 0 || body >= STENCIL_N_BODIES ||
      !stencil_body_runs(*p, *g, body))
    return nullptr;
  // a neighbour's edge rows lie in one band; a held-back strip in one tile
  if (fuse * (p->k / 2) > g->tile_h ||
      (g->tile_w < g->wc && fuse * (p->k / 2) * g->channels > g->tile_w))
    return nullptr;
  const void* fn = kernel_for(p->k, body);
  *smem = lab_band_smem(*p, *g, fuse, body);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fn, band_threads(*p, *g, fuse), *smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *err = (int)e;
  if (e != cudaSuccess) return nullptr;
  *grid = stencil_ceil_div(g->rows, g->tile_h);
  if (*grid > *per_sm * sms) {
    *err = (int)cudaErrorCooperativeLaunchTooLarge;
    return nullptr;
  }
  return fn;
}

extern "C" {

// One cooperative launch runs all `reps` (>= 1) from src into `out`
// (distinct), `fuse` reps per grid sync, in the tile body `body`; `edges`
// holds 4 * fuse * halo * wc bytes per band. Returns the cudaError_t of
// the launch (0 = launched).
int stencil_lab_band_launch(const void* src, void* out, void* edges,
                            const StencilParams* p, const StencilGeometry* g,
                            int reps, int fuse, int body, void* stream) {
  if (reps < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  int per_sm = 0, grid = 0, err = 0;
  const void* fn = prepare(p, g, fuse, body, &smem, &per_sm, &grid, &err);
  if (!fn) return err;
  StencilParams pv = *p;
  StencilGeometry gv = *g;
  int rv = reps, fz = fuse;
  int src_vec = stencil_vec_width(src, g->wc);
  int vec = stencil_vec_width(out, g->wc);
  const int ev = stencil_vec_width(edges, g->wc);
  if (ev < vec) vec = ev;
  void* args[] = {&src, &out, &edges, &pv, &gv, &rv, &fz, &src_vec, &vec};
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(band_threads(*p, *g, fuse)), args, smem,
      (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// Shared-memory bytes a launch asks for.
long long stencil_lab_band_smem(const StencilParams* p,
                                const StencilGeometry* g, int fuse,
                                int body) {
  return (long long)lab_band_smem(*p, *g, fuse, body);
}

// Resident blocks per SM, the grid and the threads per block of the launch
// (p, g, fuse, body) would make, into out[0..2]. Returns its cudaError_t.
int stencil_lab_band_shape(const StencilParams* p, const StencilGeometry* g,
                           int fuse, int body, int* out) {
  size_t smem = 0;
  int err = 0;
  if (!prepare(p, g, fuse, body, &smem, &out[0], &out[1], &err)) return err;
  out[2] = band_threads(*p, *g, fuse);
  return 0;
}

const char* stencil_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#else  // the K1-harness variants

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
#if LAB_BODY == LAB_SWAR || LAB_BODY == LAB_TILE
  // Packed carry (row pairs plus one pad pair per end) and packed
  // intermediate, one 32-bit word per row pair and lane.
  return ((rr / 2 + 2) + rr / 2) * ll * sizeof(uint32_t);
#else
  return rr * ll * (sizeof(lab_acc_t) + 1);
#endif
}

#if LAB_BODY != LAB_SWAR && LAB_BODY != LAB_TILE

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
__device__ void lab_run_tile(const StencilByteBounds& b,
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

#elif LAB_BODY == LAB_SWAR

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
__device__ void lab_run_tile(const StencilByteBounds& b,
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
#if LAB_BODY == LAB_TILE
  const StencilImageBounds b{src, dst, g, stencil_vec_width(src, g.wc),
                             stencil_vec_width(dst, g.wc)};
  stencil_run_bounded_tile<KT, STENCIL_BODY_SWAR>(
      b, p, g, blockIdx.y * g.tile_h, blockIdx.x * g.tile_w, fuse, smem);
#else
  const StencilByteBounds b{src, dst, g};
  lab_run_tile<KT>(b, p, g, blockIdx.y * g.tile_h, blockIdx.x * g.tile_w,
                   fuse, smem);
#endif
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
#elif LAB_BODY == LAB_TILE
  if (!stencil_body_runs(*p, *g, STENCIL_BODY_SWAR))
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

#endif  // LAB_BODY == LAB_BAND
