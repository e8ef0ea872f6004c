// K3 `stencil_valid`: `fuse` reps of one ghost-extended shard tile.
//
// Replaces the TPU kernel `_valid_kernel` (tpu_stencil/ops/
// pallas_stencil.py, behind `valid_fused`): the input is a shard's tile
// plus g = fuse*halo ghost rows and g*C ghost lanes per side, delivered by
// the halo exchange (real neighbour data, zeros past the global image);
// the kernel runs `fuse` reps on it and returns the (th, tw*C) interior.
// Each rep re-zeroes only the pixels outside the *global* padded extent,
// found from the shard's global origin (row0, col0) by one unsigned
// compare per axis; the tile's own edges are not a boundary — their
// ghosts are neighbour data, and the garbage that the missing ghosts
// beyond them make contracts by halo per rep into the g-wide band that
// is never stored.
//
// On Hopper the grid is 2-D over the interior and each block owns a
// tile_h x tile_w output tile (stencil_tile.cuh): it loads that tile plus
// its g-wide ghost band from the ext tile (zeros past the ext tile's
// bottom or right edge on a partial last tile — those positions are at
// least g away from any stored pixel), runs the `fuse` reps in shared
// memory over a band that shrinks by halo rows and halo*C lanes per rep,
// and stores its interior straight into the contiguous output.
//
// What bounds it on an H100: as K1, the integer work (~5 int32 ops per
// flat element per rep for the 3x3 gaussian against ~2 bytes of device
// memory per element per `fuse` reps). The design is K1's: every rep's
// intermediate stays in shared memory, and the ghost recompute
// (2*fuse*halo rows and lanes per tile) is paid for the cut in traffic.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes); never with
// --use_fast_math, and the divide is __fdiv_rn regardless.

#include "stencil_tile.cuh"

// Mirrors the ctypes Structure in tpu_stencil_torch/ops/cuda_stencil.py.
struct StencilValidGeometry {
  int rows_ext;      // rows of the ghost-extended input (th + 2g)
  int wc_ext;        // flat lanes of the input ((tw + 2g) * C)
  int rows_out;      // rows of the interior written (th)
  int wc_out;        // flat lanes of the interior written (tw * C)
  int channels;      // C
  int row0;          // global row of the interior's first row
  int col0;          // global flat lane of the interior's first lane
  int rows_glob;     // rows of the padded global image
  int cols_glob_c;   // flat lanes of the padded global image
  int tile_h;        // output rows per block
  int tile_w;        // output lanes per block
};

// Tile coordinates are ext-tile coordinates; the global position of ext
// (row, lane) is (row + row_off, lane + col_off).
struct StencilValidBounds {
  const uint8_t* src;
  uint8_t* dst;
  int rows_ext, wc_ext;
  int rows_out, wc_out;
  int ghost_rows, ghost_lanes;
  int row_off, col_off;
  int rows_glob, cols_glob_c;

  __device__ __forceinline__ uint8_t load(int row, int lane) const {
    return row < rows_ext && lane < wc_ext
               ? src[(size_t)row * wc_ext + lane]
               : (uint8_t)0;
  }
  __device__ __forceinline__ bool row_kept(int row) const {
    return (unsigned)(row + row_off) < (unsigned)rows_glob;
  }
  __device__ __forceinline__ bool lane_kept(int lane) const {
    return (unsigned)(lane + col_off) < (unsigned)cols_glob_c;
  }
  __device__ __forceinline__ void store(int row, int lane, uint8_t v) const {
    row -= ghost_rows;
    lane -= ghost_lanes;
    if (row < rows_out && lane < wc_out)
      dst[(size_t)row * wc_out + lane] = v;
  }
};

template <int KT>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_valid_kernel(StencilValidBounds b, StencilParams p,
                         StencilGeometry g, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* cur;
  int* tmp;
  stencil_smem_split(smem, p, g, fuse, &cur, &tmp);
  stencil_run_bounded_tile<KT>(
      b, p, g, blockIdx.y * g.tile_h + b.ghost_rows,
      blockIdx.x * g.tile_w + b.ghost_lanes, fuse, cur, tmp);
}

template <int KT>
static int launch(const StencilValidBounds& b, const StencilParams& p,
                  const StencilGeometry& g, int fuse, cudaStream_t stream) {
  const size_t smem = stencil_tile_smem(p, g, fuse);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)stencil_valid_kernel<KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(stencil_ceil_div(b.wc_out, g.tile_w),
                  stencil_ceil_div(b.rows_out, g.tile_h));
  stencil_valid_kernel<KT><<<grid, stencil_block_threads(p, g, fuse), smem,
                             stream>>>(b, p, g, fuse);
  return (int)cudaGetLastError();
}

extern "C" {

// One launch: `fuse` reps of the ext tile src into the interior dst
// (distinct buffers). Returns the cudaError_t of the launch (0 =
// launched).
int stencil_valid_launch(const void* src, void* dst, const StencilParams* p,
                         const StencilValidGeometry* v, int fuse,
                         void* stream) {
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || v->tile_h < 1 ||
      v->tile_w < 1 || v->channels < 1 || v->rows_out < 1 || v->wc_out < 1)
    return (int)cudaErrorInvalidValue;
  const int ghost = fuse * (p->k / 2);
  if (v->rows_ext != v->rows_out + 2 * ghost ||
      v->wc_ext != v->wc_out + 2 * ghost * v->channels)
    return (int)cudaErrorInvalidValue;
  const StencilValidBounds b{
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      v->rows_ext, v->wc_ext, v->rows_out, v->wc_out,
      ghost, ghost * v->channels,
      v->row0 - ghost, v->col0 - ghost * v->channels,
      v->rows_glob, v->cols_glob_c};
  StencilGeometry g{};
  g.rows = v->rows_ext;
  g.wc = v->wc_ext;
  g.rows_real = v->rows_ext;
  g.channels = v->channels;
  g.tile_h = v->tile_h;
  g.tile_w = v->tile_w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->k) {
    case 3: return launch<3>(b, *p, g, fuse, st);
    case 5: return launch<5>(b, *p, g, fuse, st);
    case 7: return launch<7>(b, *p, g, fuse, st);
    default: return launch<0>(b, *p, g, fuse, st);
  }
}

const char* stencil_valid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
