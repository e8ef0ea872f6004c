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
// What bounds it on an H100: the integer work. One gaussian rep is ~7 int32
// ops per flat element against ~1 byte of device memory per element per
// `fuse` reps, so at fuse 8 the card's int32 rate binds long before its
// 3.35 TB/s does. The design keeps every rep's intermediate in shared memory
// (device memory is touched once per `fuse` reps) and shrinks the computed
// band each rep so ghost recompute stays bounded; it pays that recompute
// (2*fuse*halo extra rows and lanes per tile) for the cut in traffic. What
// the card then spends is instructions per element (shared-memory loads
// and stores, the taps, the mask), so threads own whole lanes and keep the
// rows-pass window in registers.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes); never with
// --use_fast_math, and the divide is __fdiv_rn regardless.

#include "stencil_tile.cuh"

template <int KT>
__global__ void __launch_bounds__(STENCIL_MAX_THREADS)
    stencil_fused_kernel(const uint8_t* __restrict__ src,
                         uint8_t* __restrict__ dst, StencilParams p,
                         StencilGeometry g, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* cur;
  int* tmp;
  stencil_smem_split(smem, p, g, fuse, &cur, &tmp);
  stencil_run_tile<KT, false>(src, dst, p, g, blockIdx.y * g.tile_h,
                              blockIdx.x * g.tile_w, fuse, cur, tmp);
}

template <int KT>
static int launch(const uint8_t* src, uint8_t* dst, const StencilParams& p,
                  const StencilGeometry& g, int fuse, cudaStream_t stream) {
  const size_t smem = stencil_tile_smem(p, g, fuse);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)stencil_fused_kernel<KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(stencil_ceil_div(g.wc, g.tile_w),
                  stencil_ceil_div(g.rows, g.tile_h));
  stencil_fused_kernel<KT><<<grid, stencil_block_threads(p, g, fuse), smem,
                             stream>>>(src, dst, p, g, fuse);
  return (int)cudaGetLastError();
}

extern "C" {

// One launch: `fuse` reps from src to dst (distinct buffers). Returns the
// cudaError_t of the launch (0 = launched).
int stencil_fused_launch(const void* src, void* dst, const StencilParams* p,
                         const StencilGeometry* g, int fuse, void* stream) {
  if (fuse < 1 || p->k < 1 || p->k > STENCIL_MAX_K || g->tile_h < 1 ||
      g->tile_w < 1)
    return (int)cudaErrorInvalidValue;
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint8_t* d = static_cast<uint8_t*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p->k) {
    case 3: return launch<3>(s, d, *p, *g, fuse, st);
    case 5: return launch<5>(s, d, *p, *g, fuse, st);
    case 7: return launch<7>(s, d, *p, *g, fuse, st);
    default: return launch<0>(s, d, *p, *g, fuse, st);
  }
}

const char* stencil_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
