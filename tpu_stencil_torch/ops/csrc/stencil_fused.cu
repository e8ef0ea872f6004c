// K1 `stencil_fused`: `fuse` reps of the zero-boundary stencil per trip
// through device memory.
//
// Replaces the TPU kernel `_sep_kernel` (tpu_stencil/ops/pallas_stencil.py,
// built by `_build_call`, driven by `_run_rep_loop`): a row block plus
// fuse*halo ghost rows per side DMA'd into VMEM, `fuse` reps run there, one
// uint8 block stored. On Hopper the grid is 2-D over the flat (rows, W*C)
// image and each block owns a tile_h x tile_w tile (see stencil_tile.cuh);
// blocks run in parallel with no order, so each loads its own ghost band
// and nothing carries between blocks.
//
// What bounds it on an H100: the work inside the block, not device memory
// (~1 byte per element per `fuse` reps against ~5 int32 operations per
// element per rep). The first port spent it on instructions per element
// (shared-memory loads and stores, taps, mask), on a byte-wide tile load
// and store (a third of a rep), and on occupancy (5 bytes of shared memory
// per element: 3 blocks of 320 threads per SM at 32x8). So the tile's body
// is chosen per plan (stencil_tile.cuh): two rows per 32-bit word (`swar`)
// halves the per-element work of both passes where the plan allows it, an
// int16 intermediate (`acc16`) cuts shared memory where it does not, the
// int32 body takes the rest; and the tile moves 16 lanes per thread with
// 16-byte global loads and stores. Those bodies still paid six shared-memory
// accesses a packed word a rep and two block barriers, which set K1's pace;
// so K1 has a fourth body of its own, `regs` (stencil_regs.cuh): the carry
// and both passes in registers, neighbour lanes by warp shuffle, one
// exchange of pair rows between warps and one barrier a rep; and a fifth,
// `regs_direct`, the same layout for non-negative 3x3 direct plans (edge).
// The host runs them for the plans and launches they take
// (cuda_stencil.k1_launch), the shared tile's body otherwise; K2 and K3
// keep the shared tile.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes); never with
// --use_fast_math, and the divide is __fdiv_rn regardless. Every body and
// every compile-time filter size is one instance (under `regs`, every filter
// size and channel count; under `regs_direct`, every channel count, finish
// and mirror); the launch picks it from the body and the plan's
// parameters, so no branch on the body is left inside the kernel.

#include "stencil_regs.cuh"

template <int KT, int BODY>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_fused_kernel(const uint8_t* __restrict__ src,
                         uint8_t* __restrict__ dst, StencilParams p,
                         StencilGeometry g, int fuse, int load_vec,
                         int store_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const StencilImageBounds b{src, dst, g, load_vec, store_vec};
  stencil_run_bounded_tile<KT, BODY>(b, p, g, blockIdx.y * g.tile_h,
                                     blockIdx.x * g.tile_w, fuse, smem);
}

template <int BODY>
static const void* kernel_for_k(int k) {
  switch (k) {
    case 3: return (const void*)stencil_fused_kernel<3, BODY>;
    case 5: return (const void*)stencil_fused_kernel<5, BODY>;
    case 7: return (const void*)stencil_fused_kernel<7, BODY>;
    default: return (const void*)stencil_fused_kernel<0, BODY>;
  }
}

template <int C>
static const void* regs_kernel_for_k(int k) {
  switch (k) {
    case 3: return (const void*)stencil_fused_regs_kernel<3, C>;
    case 5: return (const void*)stencil_fused_regs_kernel<5, C>;
    default: return nullptr;
  }
}

// The direct body's instance for a plan of `C` channels: the proven
// multiply-high where the host passed a multiplier, for mirrored taps or
// any, else the divide.
template <int C>
static const void* direct_kernel_for(const StencilParams& p) {
  if (!p.div_mul)
    return (const void*)stencil_fused_regs_direct_kernel<C, false, false>;
  if (stencil_direct_mirrored(p))
    return (const void*)stencil_fused_regs_direct_kernel<C, true, true>;
  return (const void*)stencil_fused_regs_direct_kernel<C, false, true>;
}

static const void* kernel_for(const StencilParams& p, int body,
                              int channels) {
  const int k = p.k;
  if (body == STENCIL_BODY_REGS)
    return channels == 3 ? regs_kernel_for_k<3>(k) : regs_kernel_for_k<1>(k);
  if (body == STENCIL_BODY_REGS_DIRECT)
    return channels == 3 ? direct_kernel_for<3>(p) : direct_kernel_for<1>(p);
  switch (body) {
    case STENCIL_BODY_INT32: return kernel_for_k<STENCIL_BODY_INT32>(k);
    case STENCIL_BODY_ACC16: return kernel_for_k<STENCIL_BODY_ACC16>(k);
    case STENCIL_BODY_SWAR: return kernel_for_k<STENCIL_BODY_SWAR>(k);
    default: return nullptr;
  }
}

// The instance for (p, g, body), with its shared memory set and its threads
// per block; nullptr when the body does not run the launch or the arguments
// are out of range.
static const void* prepare(const StencilParams* p, const StencilGeometry* g,
                           int fuse, int body, size_t* smem, int* threads,
                           int* err) {
  *err = (int)cudaErrorInvalidValue;
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || g->tile_h < 1 ||
      g->tile_w < 1)
    return nullptr;
  if (body == STENCIL_BODY_REGS || body == STENCIL_BODY_REGS_DIRECT) {
    if (body == STENCIL_BODY_REGS ? !stencil_regs_runs(*p, *g, fuse)
                                  : !stencil_regs_direct_runs(*p, *g, fuse))
      return nullptr;
    *smem = stencil_regs_smem();
    *threads = 32 * STENCIL_REGS_WARPS;
  } else {
    if (body < 0 || body >= STENCIL_N_BODIES ||
        !stencil_body_runs(*p, *g, body))
      return nullptr;
    *smem = stencil_tile_smem(*p, *g, fuse, body);
    *threads = stencil_block_threads(*p, *g, fuse);
  }
  const void* fn = kernel_for(*p, body, g->channels);
  *err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return *err == 0 ? fn : nullptr;
}

static int g_last_body = -1;

extern "C" {

// One launch: `fuse` reps from src to dst (distinct buffers) with the body
// `body` (STENCIL_BODY_*, STENCIL_BODY_REGS, STENCIL_BODY_REGS_DIRECT).
// Returns the cudaError_t of the launch (0 = launched); a body that does
// not run the launch is cudaErrorInvalidValue.
int stencil_fused_launch(const void* src, void* dst, const StencilParams* p,
                         const StencilGeometry* g, int fuse, int body,
                         void* stream) {
  size_t smem = 0;
  int err = 0, threads = 0;
  const void* fn = prepare(p, g, fuse, body, &smem, &threads, &err);
  if (!fn) return err;
  StencilParams pv = *p;
  StencilGeometry gv = *g;
  int fz = fuse;
  int load_vec = stencil_vec_width(src, g->wc);
  int store_vec = stencil_vec_width(dst, g->wc);
  void* args[] = {&src, &dst, &pv, &gv, &fz, &load_vec, &store_vec};
  const dim3 grid(stencil_ceil_div(g->wc, g->tile_w),
                  stencil_ceil_div(g->rows, g->tile_h));
  cudaError_t e = cudaLaunchKernel(fn, grid, dim3(threads), args, smem,
                                   (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) g_last_body = body;
  return (int)e;
}

// The body of the last launch this library made (-1: none yet).
int stencil_fused_last_body(void) { return g_last_body; }

// Shared-memory bytes a launch with `body` asks for.
long long stencil_fused_smem(const StencilParams* p, const StencilGeometry* g,
                             int fuse, int body) {
  if (body == STENCIL_BODY_REGS || body == STENCIL_BODY_REGS_DIRECT)
    return (long long)stencil_regs_smem();
  return (long long)stencil_tile_smem(*p, *g, fuse, body);
}

// Resident blocks per SM of the instance a launch would use, into *blocks.
// Returns the cudaError_t of the query.
int stencil_fused_occupancy(const StencilParams* p, const StencilGeometry* g,
                            int fuse, int body, int* blocks) {
  size_t smem = 0;
  int err = 0, threads = 0;
  const void* fn = prepare(p, g, fuse, body, &smem, &threads, &err);
  if (!fn) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, smem);
}

// The registers a thread (out[0]) and local-memory bytes a thread (out[1])
// of the instance a launch would use (cudaFuncGetAttributes): a spill
// shows as local memory. Returns the cudaError_t of the query.
int stencil_fused_attributes(const StencilParams* p, const StencilGeometry* g,
                             int fuse, int body, int* out) {
  size_t smem = 0;
  int err = 0, threads = 0;
  const void* fn = prepare(p, g, fuse, body, &smem, &threads, &err);
  if (!fn) return err;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
  }
  return (int)e;
}

const char* stencil_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
