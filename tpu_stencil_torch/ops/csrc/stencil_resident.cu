// K2 `stencil_resident`: the whole rep loop in one launch.
//
// Replaces the TPU kernel `_resident_kernel` (tpu_stencil/ops/
// pallas_stencil.py, built by `_build_resident_call`): a grid of one
// program holds the whole image in VMEM across a runtime rep count, with
// one load and one store. An H100 SM has 227 KB of shared memory, so the
// image cannot stay in one block; instead a persistent cooperative grid
// (at most the co-resident block count, launched with
// cudaLaunchCooperativeKernel) strides over the tiles of one rep, reading
// `src` and writing `dst` with the per-rep re-zeroing of the fused kernel,
// then syncs the whole grid and swaps the two buffers. The runtime rep
// count is a kernel argument.
//
// What bounds it on an H100: with both uint8 buffers (2 * rows * W*C
// bytes) inside the 50 MB L2 — the feasibility test the caller applies —
// device memory is touched about once for the input and once for the
// result, and every rep's traffic stays in L2. What remains is the integer
// work of each rep, the per-rep halo reload from L2, and one grid-wide
// barrier per rep. Loads go through ld.global.cg (L2, not the per-SM L1),
// since other blocks wrote them within this launch.

#include <cooperative_groups.h>

#include "stencil_tile.cuh"

namespace cg = cooperative_groups;

// K2 keeps the first port's tile at fuse 1: the uint8 carry `cur` and the
// int32 rows-pass intermediate `tmp` (the int32 body), loaded and stored
// byte by byte through StencilByteBounds<true>. K1 and K3's redesigned tile
// (stencil_run_bounded_tile) is not used here.
template <int KT>
__device__ void resident_run_tile(const StencilByteBounds<true>& b,
                                  const StencilParams& p,
                                  const StencilGeometry& g, int row0,
                                  int col0, uint8_t* cur, int* tmp) {
  const int k = KT > 0 ? KT : p.k;
  const int h = k / 2;
  const int C = g.channels;
  const int hc = h * C;
  const int R = g.tile_h + 2 * h;   // tile rows in shared memory
  const int L = g.tile_w + 2 * hc;  // tile lanes in shared memory
  const int rbase = row0 - h;       // image row of tile row 0
  const int cbase = col0 - hc;      // image lane of tile lane 0

  stencil_for_region(0, R, 0, L, [&](int r, int c) {
    cur[r * L + c] = b.load(rbase + r, cbase + c);
  });
  __syncthreads();

  const int r0 = h, r1 = R - h;
  const int c0 = hc, c1 = L - hc;
  if (p.kind == 0) {
    for (int c = c0 - hc + threadIdx.x; c < c1 + hc; c += blockDim.x)
      stencil_rows_pass<KT>(cur + c, tmp + c, p, L, r0, r1, k);
    __syncthreads();
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

  stencil_for_region(h, h + g.tile_h, hc, hc + g.tile_w, [&](int r, int c) {
    b.store(rbase + r, cbase + c, cur[r * L + c]);
  });
  __syncthreads();  // the next tile of this block reuses shared memory
}

template <int KT>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_resident_kernel(const uint8_t* src, uint8_t* buf0, uint8_t* buf1,
                            StencilParams p, StencilGeometry g, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  // int32 `tmp` first (4-byte aligned), then the uint8 carry.
  int* tmp = reinterpret_cast<int*>(smem);
  uint8_t* cur = smem + (size_t)(g.tile_h + 2 * (p.k / 2)) *
                            (g.tile_w + 2 * (p.k / 2) * g.channels) *
                            sizeof(int);
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = stencil_ceil_div(g.wc, g.tile_w);
  const int n_tiles = tiles_x * stencil_ceil_div(g.rows, g.tile_h);
  const uint8_t* in = src;
  for (int rep = 0; rep < reps; ++rep) {
    uint8_t* out = (rep & 1) ? buf1 : buf0;
    const StencilByteBounds<true> b{in, out, g};
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      resident_run_tile<KT>(b, p, g, (t / tiles_x) * g.tile_h,
                            (t % tiles_x) * g.tile_w, cur, tmp);
    }
    grid.sync();
    in = out;
  }
}

template <int KT>
static int co_resident_blocks(const StencilParams& p, const StencilGeometry& g,
                              int* blocks) {
  const size_t smem = stencil_tile_smem(p, g, 1, STENCIL_BODY_INT32);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)stencil_resident_kernel<KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)stencil_resident_kernel<KT>,
      stencil_block_threads(p, g, 1), smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return 0;
}

template <int KT>
static int launch(const uint8_t* src, uint8_t* buf0, uint8_t* buf1,
                  const StencilParams& p, const StencilGeometry& g, int reps,
                  cudaStream_t stream) {
  int co_resident = 0;
  int rc = co_resident_blocks<KT>(p, g, &co_resident);
  if (rc != 0) return rc;
  const int n_tiles = stencil_ceil_div(g.wc, g.tile_w) *
                      stencil_ceil_div(g.rows, g.tile_h);
  const int grid = n_tiles < co_resident ? n_tiles : co_resident;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  StencilParams pv = p;
  StencilGeometry gv = g;
  int rv = reps;
  void* args[] = {(void*)&src, (void*)&buf0, (void*)&buf1,
                  (void*)&pv, (void*)&gv, (void*)&rv};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)stencil_resident_kernel<KT>, dim3(grid),
      dim3(stencil_block_threads(p, g, 1)), args, stencil_tile_smem(p, g, 1, STENCIL_BODY_INT32),
      stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" {

// One launch runs all `reps` (>= 1): rep r reads src (r == 0) or the
// buffer rep r-1 wrote, and writes buf0 (r even) or buf1 (r odd); the
// result is in buf0 when reps is odd, else buf1. Returns the cudaError_t
// of the launch (0 = launched).
int stencil_resident_launch(const void* src, void* buf0, void* buf1,
                            const StencilParams* p, const StencilGeometry* g,
                            int reps, void* stream) {
  if (reps < 1 || p->k < 1 || p->k > STENCIL_MAX_K || g->tile_h < 1 ||
      g->tile_w < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* b0 = static_cast<uint8_t*>(buf0);
  uint8_t* b1 = static_cast<uint8_t*>(buf1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->k) {
    case 3: return launch<3>(s, b0, b1, *p, *g, reps, st);
    case 5: return launch<5>(s, b0, b1, *p, *g, reps, st);
    case 7: return launch<7>(s, b0, b1, *p, *g, reps, st);
    default: return launch<0>(s, b0, b1, *p, *g, reps, st);
  }
}

// 1 when the current device supports cooperative launch, else 0; < 0 is
// the negated cudaError_t of the query.
int stencil_resident_cooperative(void) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  return err == cudaSuccess ? (coop != 0) : -(int)err;
}

const char* stencil_resident_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
