// `halo_fill`: one tile's ghost ring pulled from its neighbours in one
// launch.
//
// Replaces no TPU kernel: the JAX package's halo exchange is
// `lax.ppermute` inside `shard_map` (tpu_stencil/parallel/halo.py), whose
// copies XLA schedules. On the cards the strip exchange
// (tpu_stencil_torch/parallel/halo.py) moves each ghost strip by a
// PyTorch copy between cards, which orders the two cards' streams both
// ways, and builds every ghost-extended tile anew by `torch.cat`. This
// kernel is the receiving side of a pull instead: it runs on the card of
// the tile whose ring it fills (a ring of one buffer of the persistent
// slab, tpu_stencil_torch/parallel/fill.py) and reads each piece straight
// from the interior of the neighbour's buffer, on the neighbour's card
// through peer access (NVLink) or on its own card. Pieces with no
// neighbour are never written: they are the slab's zero boundary.
//
// One launch fills up to 8 pieces (the 4 edge strips and the 4 corners),
// one piece a row of blocks (blockIdx.y). A piece is a rectangle of `rows`
// rows of `width` bytes with a source and a destination pitch. Threads
// copy the widest unit (16, 8, 4 or 1 bytes) that both bases, both
// pitches and the width allow, neighbouring threads on neighbouring units
// of a row, then on the next row.
//
// What bounds it on an H100: latency, not bandwidth. A 2520x960 grey
// tile's ring at depth 8 is ~56 KB (its W and E strips 8 bytes a row), a
// few microseconds at NVLink's 450 GB/s a direction; each thread makes
// one or two round trips to the peer's memory, all threads in flight at
// once.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#define HALO_FILL_MAX_PIECES 8
#define HALO_FILL_THREADS 256
#define HALO_FILL_MAX_BLOCKS 64

// Mirrors the ctypes Structures in tpu_stencil_torch/ops/halo_fill.py.
struct HaloFillPiece {
  const uint8_t* src;   // the piece's first byte in the neighbour
  uint8_t* dst;         // the piece's first byte in the ring
  long long src_pitch;  // bytes between source rows
  long long dst_pitch;  // bytes between destination rows
  int rows;
  int width;            // bytes a row
};

struct HaloFillTable {
  int n;                // pieces, 1..HALO_FILL_MAX_PIECES
  int pad;
  HaloFillPiece piece[HALO_FILL_MAX_PIECES];
};

template <typename T>
__device__ __forceinline__ void halo_fill_rect(const HaloFillPiece& p,
                                               int first, int step) {
  const int w = p.width / (int)sizeof(T);
  const int n = p.rows * w;
  for (int e = first; e < n; e += step) {
    const int r = e / w;
    const int c = e - r * w;
    const T* s = reinterpret_cast<const T*>(p.src + r * p.src_pitch);
    T* d = reinterpret_cast<T*>(p.dst + r * p.dst_pitch);
    d[c] = s[c];
  }
}

__global__ void __launch_bounds__(HALO_FILL_THREADS)
    halo_fill_kernel(HaloFillTable t) {
  const HaloFillPiece p = t.piece[blockIdx.y];
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = gridDim.x * blockDim.x;
  const unsigned long long a =
      (unsigned long long)p.src | (unsigned long long)p.dst |
      (unsigned long long)p.src_pitch | (unsigned long long)p.dst_pitch |
      (unsigned long long)p.width;
  if ((a & 15) == 0)
    halo_fill_rect<uint4>(p, first, step);
  else if ((a & 7) == 0)
    halo_fill_rect<uint2>(p, first, step);
  else if ((a & 3) == 0)
    halo_fill_rect<unsigned int>(p, first, step);
  else
    halo_fill_rect<uint8_t>(p, first, step);
}

extern "C" {

// One launch on `stream` (a stream of the current device, the card of
// every destination): the table's pieces. Returns the cudaError_t of the
// launch (0 = launched); a table out of range is cudaErrorInvalidValue.
int halo_fill_launch(const HaloFillTable* t, void* stream) {
  if (t->n < 1 || t->n > HALO_FILL_MAX_PIECES)
    return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int k = 0; k < t->n; ++k) {
    const HaloFillPiece& p = t->piece[k];
    if (!p.src || !p.dst || p.rows < 1 || p.width < 1 ||
        p.src_pitch < p.width || p.dst_pitch < p.width)
      return (int)cudaErrorInvalidValue;
    const long long bytes = (long long)p.rows * p.width;
    if (bytes > most) most = bytes;
  }
  // Enough blocks for one 4-byte unit a thread on the largest piece.
  long long blocks = (most + 4LL * HALO_FILL_THREADS - 1) /
                     (4LL * HALO_FILL_THREADS);
  if (blocks > HALO_FILL_MAX_BLOCKS) blocks = HALO_FILL_MAX_BLOCKS;
  HaloFillTable tv = *t;
  void* args[] = {&tv};
  cudaError_t e = cudaLaunchKernel(
      (const void*)halo_fill_kernel, dim3((unsigned)blocks, (unsigned)t->n),
      dim3(HALO_FILL_THREADS), args, 0, (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

// Let the current device read `peer`'s memory (once a pair for the
// process; enabled already is not an error). Returns the cudaError_t.
int halo_fill_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();
    return 0;
  }
  return (int)e;
}

const char* halo_fill_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
