// K2 `stencil_resident`: the whole rep loop in one cooperative launch.
//
// Replaces the TPU kernel `_resident_kernel` (tpu_stencil/ops/
// pallas_stencil.py, built by `_build_resident_call`): a grid of one
// program holds the whole lane-padded image in VMEM across a runtime rep
// count, with one load and one store of the image per job. No block of an
// H100 holds an image (227 KB of shared memory each), so K2 spreads the
// rep loop over a persistent cooperative grid (at most the co-resident
// block count, cudaLaunchCooperativeKernel) whose blocks stride over K1's
// tiles of the image (stencil_tile.cuh, in the body the host's
// cuda_stencil.tile_body picks for the plan: 16-lane loads and stores, each
// row's keep decided once per row). Each step between two grid-wide syncs
// runs `fuse` reps of every tile as a trapezoid over fuse*halo ghost rows
// and lanes, reading one device buffer and writing the other; reps % fuse
// single-rep steps end the loop. The two buffers swap once per sync, and
// the last step writes `out`. Every rep re-zeroes rows outside
// [0, rows_real), the frame-gap rows and lanes past wc, and finishes as the
// plan says, as K1 does. The runtime rep count is a kernel argument.
//
// What bounds it on an H100: what bounds K1, the work inside the block
// (~5 int32 operations per element per rep for the 3x3 gaussian against
// one round trip of the image through L2 per `fuse` reps); K2 does K1's
// work with a grid sync where K1 launches again. So K2 takes `fuse` reps
// per sync, and a sync waits for its last, partly filled round of tiles:
// the host picks the tile height whose rounds come out fullest
// (cuda_stencil.resident_geometry). The image stays in device memory
// between syncs: holding it in the blocks' shared memory instead (one band
// of rows per SM, edges exchanged through device memory) measured slower,
// since the tile's load, packing and store recur every step whatever the
// source, and one block per SM hides none of its barriers; that form is
// the kernel lab's `band` variant (stencil_lab.cu). Loads go through L2
// (ld.global.cg, the bounds' `coherent`), since other blocks wrote them
// within this launch.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes); never with
// --use_fast_math, and the divide is __fdiv_rn regardless.

#include <cooperative_groups.h>

#include "stencil_tile.cuh"

namespace cg = cooperative_groups;

// K1's image bounds, every load through L2.
struct ResidentImageBounds : StencilImageBounds {
  static constexpr bool coherent = true;
};

template <int KT, int BODY>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_resident_kernel(const uint8_t* src, uint8_t* out, uint8_t* work,
                            StencilParams p, StencilGeometry g, int reps,
                            int fuse, int src_vec, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = stencil_ceil_div(g.wc, g.tile_w);
  const int n_tiles = tiles_x * stencil_ceil_div(g.rows, g.tile_h);
  const int full = reps / fuse;               // steps of `fuse` reps
  const int steps = full + reps % fuse;       // then single-rep steps
  const uint8_t* in = src;
  for (int s = 0; s < steps; ++s) {
    uint8_t* dst = ((steps - 1 - s) & 1) ? work : out;
    const ResidentImageBounds b{{in, dst, g, s ? vec : src_vec, vec}};
    const int depth = s < full ? fuse : 1;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
      stencil_run_bounded_tile<KT, BODY>(b, p, g, (t / tiles_x) * g.tile_h,
                                         (t % tiles_x) * g.tile_w, depth,
                                         smem);
    if (s + 1 < steps) grid.sync();
    in = dst;
  }
}

template <int BODY>
static const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return (const void*)stencil_resident_kernel<3, BODY>;
    case 5: return (const void*)stencil_resident_kernel<5, BODY>;
    case 7: return (const void*)stencil_resident_kernel<7, BODY>;
    default: return (const void*)stencil_resident_kernel<0, BODY>;
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

// The instance for (p, g, fuse, body) with its shared memory set, and the
// grid a launch uses: every tile, at most the co-resident blocks of this
// instance at this shared memory. nullptr (and *err) when the body does not
// run the plan or the arguments are out of range.
static const void* prepare(const StencilParams* p, const StencilGeometry* g,
                           int fuse, int body, size_t* smem, int* per_sm,
                           int* grid, int* err) {
  *err = (int)cudaErrorInvalidValue;
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || g->tile_h < 1 ||
      g->tile_w < 1 || body < 0 || body >= STENCIL_N_BODIES ||
      !stencil_body_runs(*p, *g, body))
    return nullptr;
  const void* fn = kernel_for(p->k, body);
  *smem = stencil_tile_smem(*p, *g, fuse, body);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fn, stencil_block_threads(*p, *g, fuse), *smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *err = (int)e;
  if (e != cudaSuccess) return nullptr;
  const int n_tiles = stencil_ceil_div(g->wc, g->tile_w) *
                      stencil_ceil_div(g->rows, g->tile_h);
  const int co_resident = *per_sm * sms;
  *grid = n_tiles < co_resident ? n_tiles : co_resident;
  if (*grid < 1) {
    *err = (int)cudaErrorCooperativeLaunchTooLarge;
    return nullptr;
  }
  return fn;
}

static int g_last_body = -1;

extern "C" {

// One launch runs all `reps` (>= 1) from src into `out`, `fuse` reps per
// grid sync, in the tile body `body` (STENCIL_BODY_*); `work` is a second
// buffer of the image's size. src, out and work are distinct. Returns the
// cudaError_t of the launch (0 = launched); a body that does not run the
// plan is cudaErrorInvalidValue.
int stencil_resident_launch(const void* src, void* out, void* work,
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
  const int wv = stencil_vec_width(work, g->wc);
  if (wv < vec) vec = wv;
  void* args[] = {&src, &out, &work, &pv, &gv, &rv, &fz, &src_vec, &vec};
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(stencil_block_threads(*p, *g, fuse)), args, smem,
      (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) g_last_body = body;
  return (int)e;
}

// The body of the last launch this library made (-1: none yet).
int stencil_resident_last_body(void) { return g_last_body; }

// Shared-memory bytes a launch asks for.
long long stencil_resident_smem(const StencilParams* p,
                                const StencilGeometry* g, int fuse,
                                int body) {
  return (long long)stencil_tile_smem(*p, *g, fuse, body);
}

// Resident blocks per SM, the grid and the threads per block of the launch
// (p, g, fuse, body) would make, into out[0..2]. Returns its cudaError_t.
int stencil_resident_shape(const StencilParams* p, const StencilGeometry* g,
                           int fuse, int body, int* out) {
  size_t smem = 0;
  int err = 0;
  if (!prepare(p, g, fuse, body, &smem, &out[0], &out[1], &err)) return err;
  out[2] = stencil_block_threads(*p, *g, fuse);
  return 0;
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
