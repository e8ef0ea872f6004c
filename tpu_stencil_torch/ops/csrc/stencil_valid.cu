// K3 `stencil_valid`: `fuse` reps of one ghost-extended shard tile.
//
// Replaces the TPU kernel `_valid_kernel` (tpu_stencil/ops/
// pallas_stencil.py, behind `valid_fused`): the input is a shard's tile
// plus g = fuse*halo ghost rows and g*C ghost lanes per side, delivered by
// the halo exchange (real neighbour data, zeros past the global image);
// the kernel runs `fuse` reps on it and returns the (th, tw*C) interior.
// The ext tile may be a window of a larger array and the interior a
// rectangle of another: each comes with its own row pitch (lanes are unit
// stride), so the interior/border overlap schedules run K3 on a thin
// border band in place, with no copy in and no stitch out.
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
// and stores its interior straight into the output rows.
//
// What bounds it on an H100: as K1, the work inside the block (~5 int32
// ops per flat element per rep for the 3x3 gaussian against ~2 bytes of
// device memory per element per `fuse` reps). The design is K1's, tile
// body and 16-lane load and store included: every rep's intermediate stays
// in shared memory, and the ghost recompute (2*fuse*halo rows and lanes
// per tile) is paid for the cut in traffic.
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
  long long src_pitch;  // bytes between input rows (>= wc_ext)
  long long dst_pitch;  // bytes between output rows (>= wc_out)
};

// Tile coordinates are ext-tile coordinates; the global position of ext
// (row, lane) is (row + row_off, lane + col_off). The re-zero test is one
// unsigned compare per axis, once per row and once per lane; the ext tile
// loads as it is (zeros only past its own bottom and right edges).
struct StencilValidBounds {
  const uint8_t* src;
  uint8_t* dst;
  int rows_ext, wc_ext;
  int rows_out, wc_out;
  long long src_pitch, dst_pitch;
  int ghost_rows, ghost_lanes;
  int row_off, col_off;
  int rows_glob, cols_glob_c;
  int load_vec, store_vec;
  static constexpr bool coherent = false;

  __device__ __forceinline__ const uint8_t* load_row(int row) const {
    return (unsigned)row < (unsigned)rows_ext ? src + row * src_pitch
                                              : nullptr;
  }
  __device__ __forceinline__ int load_wc() const { return wc_ext; }
  __device__ __forceinline__ bool rows_kept(int lo, int hi) const {
    return lo + row_off >= 0 && hi + row_off <= rows_glob;
  }
  __device__ __forceinline__ int keep_phase(int) const { return 0; }
  __device__ __forceinline__ bool keep_step(int row, int&) const {
    return (unsigned)(row + row_off) < (unsigned)rows_glob;
  }
  __device__ __forceinline__ bool lane_kept(int lane) const {
    return (unsigned)(lane + col_off) < (unsigned)cols_glob_c;
  }
  __device__ __forceinline__ uint8_t* store_row(int row) const {
    row -= ghost_rows;
    return (unsigned)row < (unsigned)rows_out ? dst + row * dst_pitch
                                              : nullptr;
  }
  __device__ __forceinline__ int store_off() const { return ghost_lanes; }
  __device__ __forceinline__ int store_wc() const { return wc_out; }
};

template <int KT, int BODY>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_valid_kernel(StencilValidBounds b, StencilParams p,
                         StencilGeometry g, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  stencil_run_bounded_tile<KT, BODY>(
      b, p, g, blockIdx.y * g.tile_h + b.ghost_rows,
      blockIdx.x * g.tile_w + b.ghost_lanes, fuse, smem);
}

template <int BODY>
static const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return (const void*)stencil_valid_kernel<3, BODY>;
    case 5: return (const void*)stencil_valid_kernel<5, BODY>;
    case 7: return (const void*)stencil_valid_kernel<7, BODY>;
    default: return (const void*)stencil_valid_kernel<0, BODY>;
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

// K3's tile geometry in the shared StencilGeometry: the ext tile is the
// image the tile code sees (its bounds policy is StencilValidBounds).
static StencilGeometry ext_geometry(const StencilValidGeometry* v) {
  StencilGeometry g{};
  g.rows = v->rows_ext;
  g.wc = v->wc_ext;
  g.rows_real = v->rows_ext;
  g.channels = v->channels;
  g.tile_h = v->tile_h;
  g.tile_w = v->tile_w;
  return g;
}

// The instance for (p, v, body), with its shared memory set; nullptr when
// the body does not run the plan or the arguments are out of range.
static const void* prepare(const StencilParams* p,
                           const StencilValidGeometry* v, int fuse, int body,
                           size_t* smem, int* err) {
  *err = (int)cudaErrorInvalidValue;
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || v->tile_h < 1 ||
      v->tile_w < 1 || v->channels < 1 || v->rows_out < 1 || v->wc_out < 1 ||
      body < 0 || body >= STENCIL_N_BODIES)
    return nullptr;
  const int ghost = fuse * (p->k / 2);
  if (v->rows_ext != v->rows_out + 2 * ghost ||
      v->wc_ext != v->wc_out + 2 * ghost * v->channels ||
      v->src_pitch < v->wc_ext || v->dst_pitch < v->wc_out)
    return nullptr;
  const StencilGeometry g = ext_geometry(v);
  if (!stencil_body_runs(*p, g, body)) return nullptr;
  const void* fn = kernel_for(p->k, body);
  *smem = stencil_tile_smem(*p, g, fuse, body);
  *err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return *err == 0 ? fn : nullptr;
}

static int g_last_body = -1;

extern "C" {

// One launch: `fuse` reps of the ext tile src into the interior dst
// (distinct buffers, rows v->src_pitch and v->dst_pitch bytes apart) with
// the tile body `body` (STENCIL_BODY_*). The widest access of each side is
// picked from its base and its pitch together, so a window whose origin
// or pitch is not 16-byte aligned loads and stores narrower. Returns the
// cudaError_t of the launch (0 = launched); a body that does not run the
// plan is cudaErrorInvalidValue.
int stencil_valid_launch(const void* src, void* dst, const StencilParams* p,
                         const StencilValidGeometry* v, int fuse, int body,
                         void* stream) {
  size_t smem = 0;
  int err = 0;
  const void* fn = prepare(p, v, fuse, body, &smem, &err);
  if (!fn) return err;
  const int ghost = fuse * (p->k / 2);
  StencilValidBounds b{
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      v->rows_ext, v->wc_ext, v->rows_out, v->wc_out,
      v->src_pitch, v->dst_pitch,
      ghost, ghost * v->channels,
      v->row0 - ghost, v->col0 - ghost * v->channels,
      v->rows_glob, v->cols_glob_c,
      stencil_vec_width(src, v->src_pitch),
      stencil_vec_width(dst, v->dst_pitch)};
  StencilParams pv = *p;
  StencilGeometry gv = ext_geometry(v);
  int fz = fuse;
  void* args[] = {&b, &pv, &gv, &fz};
  const dim3 grid(stencil_ceil_div(v->wc_out, v->tile_w),
                  stencil_ceil_div(v->rows_out, v->tile_h));
  cudaError_t e = cudaLaunchKernel(fn, grid,
                                   dim3(stencil_block_threads(*p, gv, fuse)),
                                   args, smem, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) g_last_body = body;
  return (int)e;
}

// The body of the last launch this library made (-1: none yet).
int stencil_valid_last_body(void) { return g_last_body; }

// Shared-memory bytes a launch with `body` asks for.
long long stencil_valid_smem(const StencilParams* p,
                             const StencilValidGeometry* v, int fuse,
                             int body) {
  return (long long)stencil_tile_smem(*p, ext_geometry(v), fuse, body);
}

// Resident blocks per SM of the instance a launch would use, into *blocks.
// Returns the cudaError_t of the query.
int stencil_valid_occupancy(const StencilParams* p,
                            const StencilValidGeometry* v, int fuse, int body,
                            int* blocks) {
  size_t smem = 0;
  int err = 0;
  const void* fn = prepare(p, v, fuse, body, &smem, &err);
  if (!fn) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, stencil_block_threads(*p, ext_geometry(v), fuse), smem);
}

const char* stencil_valid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
