// L1 `op_chain`: a chain of N identical operations on one shared-memory
// tile per block, to cost single machine operations.
//
// Replaces the TPU kernel of `make_case` (tools/op_cost.py): per grid
// program, load an (in_block, wc) uint8 tile, convert it to the case's type,
// apply the case's operation N times, store the first `block` rows as uint8
// (integers wrap, float32 saturates). The tool times a chain of 2N against a
// chain of N; the difference over N is one operation over the tile, with the
// load, the store and the launch cancelled. The function of every case is
// the TPU case's; the tile is re-derived (the fused stencil kernel's own
// shared-memory tile, one block each, enough blocks to fill 132 SMs several
// times) and what a "pass" is follows this card:
//
//   through shared memory  one sweep of the typed tile per operation: load,
//                          operate, store, barrier. What a TPU full-tile
//                          op-pass through VMEM becomes here. The row
//                          neighbour cases (shrinking adds at offset 1 and 8,
//                          the end-around row roll) run in place down each
//                          thread's own lane; the lane rolls (1, 3, 128)
//                          ping-pong two buffers, since lanes cross threads.
//   in registers           load once, N operations on the register, store
//                          once (`strip_add_i32`: the TPU's strip cases asked
//                          whether a small working set stays in registers;
//                          here it does by construction), with an empty asm
//                          between operations so the compiler cannot fold the
//                          chain. `shfl*_add_i32` add a warp-shuffle
//                          neighbour (end-around within 32 lanes), the card's
//                          own way to a lane at a small offset.
//   packed                 `vadd4_u8` / `vadd2_i16`: four uint8 or two int16
//                          per 32-bit word (__vadd4, __vadd2), the card's
//                          answer to uint8 and int16 vector adds.
//   mxu_rows_*             the banded 144x144 rows-pass matrix times the
//                          first 144 rows of the tile, computed here in the
//                          kernel's own body: float32 FMAs on bf16-rounded
//                          inputs, or __dp4a on int8 inputs (plain loops now,
//                          tensor cores later).
//
// What bounds it: nothing is meant to. Each case isolates one operation's
// instruction cost (or a shared-memory round trip's), so its time per pass
// is read against the other cases, not against a roofline. N is a template
// parameter, so every chain is unrolled as on the TPU. The library holds
// three chains: 8 and 16, which the tool times, and 3, which it only checks:
// eight doublings (or eight shifts) of a byte leave nothing in the uint8
// that is stored, so at 8 and 16 about a quarter of the cases store a
// constant whatever the kernel did, while after three operations every
// case's output still depends on its input.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes). The float cases use
// __fmul_rn / __fadd_rn so that no multiply-add is contracted and the
// result equals the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#define OP_MAX_THREADS 512
#define OP_BAND 144  // rows and columns of the banded matrix

// Case ids: mirrored by CASES in tpu_stencil_torch/ops/lab.py.
enum OpCase {
  MXU_ROWS_BF16 = 0, MXU_ROWS_I8, STRIP_ADD_I32, SUBROLL1_ADD_I32,
  SUBROLL1_ADD_U8, CVT_U8_I32_RT, ADD_U8, ADD_I32, ADD_I16,
  MIS_SLICE_ADD_I32, MIS_SLICE_ADD_I16, AL_SLICE_ADD_I16, ROLL3_I32,
  ROLL3_ADD_I32, ROLL1_ADD_I32, ROLL128_ADD_I32, ADD_F32, MUL_ADD_F32,
  MUL_ADD_I32, SHIFT_I32, WHERE_I32, CVT_I16_I32_RT, MUL_I32, CLIP_I32,
  VADD4_U8, VADD2_I16, SHFL1_ADD_I32, SHFL3_ADD_I32, OP_N_CASES
};

struct OpTile {
  int in_block;  // rows of the input tile
  int block;     // rows stored
  int wc;        // lanes per row
};

// ---- conversions ----------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint8_t op_to_u8(T v) {
  return (uint8_t)v;  // integers wrap
}
template <>
__device__ __forceinline__ uint8_t op_to_u8<float>(float v) {
  return (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);  // float32 saturates
}

template <typename T>
__device__ __forceinline__ void op_load(const uint8_t* in, T* s, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) s[e] = (T)in[e];
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void op_store(const T* s, uint8_t* out, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) out[e] = op_to_u8<T>(s[e]);
}

// ---- the elementwise operations -------------------------------------------

template <int CASE, typename T>
__device__ __forceinline__ T op_apply(T x) {
  if constexpr (CASE == ADD_U8 || CASE == ADD_I16) {
    return (T)(x + x);
  } else if constexpr (CASE == ADD_I32 || CASE == STRIP_ADD_I32) {
    return (T)((unsigned)x + (unsigned)x);
  } else if constexpr (CASE == ADD_F32) {
    return __fadd_rn(x, x);
  } else if constexpr (CASE == MUL_ADD_F32) {
    return __fadd_rn(__fmul_rn(x, 0.998f), x);
  } else if constexpr (CASE == MUL_ADD_I32) {
    return (T)((unsigned)x * 3u + (unsigned)x);
  } else if constexpr (CASE == MUL_I32) {
    return (T)((unsigned)x * 3u);
  } else if constexpr (CASE == SHIFT_I32) {
    return x >> 1;
  } else if constexpr (CASE == WHERE_I32) {
    return x > 0 ? x : 0;
  } else if constexpr (CASE == CLIP_I32) {
    return min(max(x, 0), 255);
  } else {
    return x;
  }
}

// One sweep of the tile per operation, through shared memory.
template <int CASE, typename T, int N>
__device__ void op_run_sweeps(const uint8_t* in, uint8_t* out, OpTile t,
                              unsigned char* smem) {
  T* s = reinterpret_cast<T*>(smem);
  const int n = t.in_block * t.wc;
  op_load<T>(in, s, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      s[e] = op_apply<CASE, T>(s[e]);
    __syncthreads();
  }
  op_store<T>(s, out, t.block * t.wc);
}

// The whole chain in a register, one shared-memory round trip in all.
template <int CASE, int N>
__device__ void op_run_registers(const uint8_t* in, uint8_t* out, OpTile t,
                                 unsigned char* smem) {
  int* s = reinterpret_cast<int*>(smem);
  const int n = t.in_block * t.wc;
  op_load<int>(in, s, n);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int v = s[e];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (CASE == SHFL1_ADD_I32 || CASE == SHFL3_ADD_I32) {
        // e and the block size are multiples of 32 apart, so a warp holds
        // 32 consecutive lanes of one row (wc % 32 == 0).
        constexpr int s_off = CASE == SHFL1_ADD_I32 ? 1 : 3;
        const int lane = threadIdx.x & 31;
        v = (int)((unsigned)v + (unsigned)__shfl_sync(
                                    0xffffffffu, v, (lane - s_off) & 31));
      } else {
        v = op_apply<CASE, int>(v);
      }
      asm volatile("" : "+r"(v));  // keep the N operations apart
    }
    s[e] = v;
  }
  __syncthreads();
  op_store<int>(s, out, t.block * t.wc);
}

// Four uint8 or two int16 per 32-bit word, one sweep per operation.
template <int CASE, int N>
__device__ void op_run_packed(const uint8_t* in, uint8_t* out, OpTile t,
                              unsigned char* smem) {
  const int n = t.in_block * t.wc;
  if constexpr (CASE == VADD4_U8) {
    uint8_t* s8 = smem;
    op_load<uint8_t>(in, s8, n);
    unsigned* w = reinterpret_cast<unsigned*>(smem);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      for (int e = threadIdx.x; e < n / 4; e += blockDim.x)
        w[e] = __vadd4(w[e], w[e]);
      __syncthreads();
    }
    op_store<uint8_t>(s8, out, t.block * t.wc);
  } else {
    int16_t* s16 = reinterpret_cast<int16_t*>(smem);
    op_load<int16_t>(in, s16, n);
    unsigned* w = reinterpret_cast<unsigned*>(smem);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      for (int e = threadIdx.x; e < n / 2; e += blockDim.x)
        w[e] = __vadd2(w[e], w[e]);
      __syncthreads();
    }
    op_store<int16_t>(s16, out, t.block * t.wc);
  }
}

// Convert round trip through memory: narrow array -> int32 array -> narrow.
template <typename TN, int N>
__device__ void op_run_convert(const uint8_t* in, uint8_t* out, OpTile t,
                               unsigned char* smem) {
  const int n = t.in_block * t.wc;
  int* wide = reinterpret_cast<int*>(smem);
  TN* narrow = reinterpret_cast<TN*>(smem + (size_t)n * sizeof(int));
  op_load<TN>(in, narrow, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) wide[e] = (int)narrow[e];
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) narrow[e] = (TN)wide[e];
    __syncthreads();
  }
  op_store<TN>(narrow, out, t.block * t.wc);
}

// Shrinking row add, in place down each thread's own lanes:
// x[r] = x[r] + x[r + OFF] on OFF fewer rows each operation.
template <typename T, int OFF, int N>
__device__ void op_run_row_shrink(const uint8_t* in, uint8_t* out, OpTile t,
                                  unsigned char* smem) {
  T* s = reinterpret_cast<T*>(smem);
  op_load<T>(in, s, t.in_block * t.wc);
  int rows = t.in_block;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    rows -= OFF;
    for (int c = threadIdx.x; c < t.wc; c += blockDim.x) {
      T* x = s + c;
      for (int r = 0; r < rows; ++r, x += t.wc)
        *x = (T)((unsigned)*x + (unsigned)x[OFF * t.wc]);
    }
    __syncthreads();
  }
  op_store<T>(s, out, t.block * t.wc);
}

// x + (x rolled down one row, end-around), in place up each lane.
template <typename T, int N>
__device__ void op_run_row_roll(const uint8_t* in, uint8_t* out, OpTile t,
                                unsigned char* smem) {
  T* s = reinterpret_cast<T*>(smem);
  op_load<T>(in, s, t.in_block * t.wc);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int c = threadIdx.x; c < t.wc; c += blockDim.x) {
      T* x = s + (size_t)(t.in_block - 1) * t.wc + c;
      const T last = *x;
      for (int r = t.in_block - 1; r > 0; --r, x -= t.wc)
        *x = (T)((unsigned)*x + (unsigned)x[-t.wc]);
      *x = (T)((unsigned)*x + (unsigned)last);
    }
    __syncthreads();
  }
  op_store<T>(s, out, t.block * t.wc);
}

// Lane roll by S (out[c] = x[c - S], end-around), alone or added to x,
// ping-ponging two int32 buffers.
template <int S, bool ADD, int N>
__device__ void op_run_lane_roll(const uint8_t* in, uint8_t* out, OpTile t,
                                 unsigned char* smem) {
  const int n = t.in_block * t.wc;
  int* a = reinterpret_cast<int*>(smem);
  int* b = a + n;
  op_load<int>(in, a, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int c = threadIdx.x; c < t.wc; c += blockDim.x) {
      int from = c - S % t.wc;
      if (from < 0) from += t.wc;
      const int* xs = a + from;
      const int* xc = a + c;
      int* y = b + c;
      for (int r = 0; r < t.in_block; ++r, xs += t.wc, xc += t.wc, y += t.wc)
        *y = ADD ? (int)((unsigned)*xc + (unsigned)*xs) : *xs;
    }
    __syncthreads();
    int* sw = a;
    a = b;
    b = sw;
  }
  op_store<int>(a, out, t.block * t.wc);
}

// y = A (OP_BAND x OP_BAND) @ x[:OP_BAND] per lane; x = y on the first
// OP_BAND rows and zero below. `aux` is A, row-major: float32 holding
// bf16-exact values, or int8.
template <int CASE, int N>
__device__ void op_run_band(const uint8_t* in, uint8_t* out, const void* aux,
                            OpTile t, unsigned char* smem) {
  const int n = t.in_block * t.wc;
  int* x = reinterpret_cast<int*>(smem);
  op_load<int>(in, x, n);
  if constexpr (CASE == MXU_ROWS_BF16) {
    float* f = reinterpret_cast<float*>(smem + (size_t)n * sizeof(int));
    const float* a = static_cast<const float*>(aux);
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      for (int c = threadIdx.x; c < t.wc; c += blockDim.x) {
        // int32 -> float32 -> bf16, both round to nearest even.
        for (int k = 0; k < OP_BAND; ++k) {
          const unsigned u = __float_as_uint(__int2float_rn(x[k * t.wc + c]));
          f[k * t.wc + c] =
              __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
        }
        for (int r = 0; r < OP_BAND; ++r) {
          float acc = 0.0f;
          for (int k = 0; k < OP_BAND; ++k)
            acc = __fmaf_rn(__ldg(a + r * OP_BAND + k), f[k * t.wc + c], acc);
          x[r * t.wc + c] = (int)acc;
        }
        for (int r = OP_BAND; r < t.in_block; ++r) x[r * t.wc + c] = 0;
      }
      __syncthreads();
    }
  } else {
    int* f = reinterpret_cast<int*>(smem + (size_t)n * sizeof(int));
    const int* a = static_cast<const int*>(aux);  // 4 int8 per word
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      for (int c = threadIdx.x; c < t.wc; c += blockDim.x) {
        for (int k = 0; k < OP_BAND / 4; ++k) {
          const int* xk = x + 4 * k * t.wc + c;
          f[k * t.wc + c] = (xk[0] & 0xFF) | ((xk[t.wc] & 0xFF) << 8) |
                            ((xk[2 * t.wc] & 0xFF) << 16) |
                            ((xk[3 * t.wc] & 0xFF) << 24);
        }
        for (int r = 0; r < OP_BAND; ++r) {
          int acc = 0;
          for (int k = 0; k < OP_BAND / 4; ++k)
            acc = __dp4a(__ldg(a + r * (OP_BAND / 4) + k), f[k * t.wc + c],
                         acc);
          x[r * t.wc + c] = acc;
        }
        for (int r = OP_BAND; r < t.in_block; ++r) x[r * t.wc + c] = 0;
      }
      __syncthreads();
    }
  }
  op_store<int>(x, out, t.block * t.wc);
}

// ---- one kernel per (case, N) ---------------------------------------------

template <int CASE, int N>
__global__ void __launch_bounds__(OP_MAX_THREADS)
    op_chain_kernel(const uint8_t* __restrict__ src,
                    uint8_t* __restrict__ dst, const void* aux, OpTile t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint8_t* in = src + (size_t)blockIdx.x * t.in_block * t.wc;
  uint8_t* out = dst + (size_t)blockIdx.x * t.block * t.wc;
  if constexpr (CASE == MXU_ROWS_BF16 || CASE == MXU_ROWS_I8) {
    op_run_band<CASE, N>(in, out, aux, t, smem);
  } else if constexpr (CASE == STRIP_ADD_I32 || CASE == SHFL1_ADD_I32 ||
                       CASE == SHFL3_ADD_I32) {
    op_run_registers<CASE, N>(in, out, t, smem);
  } else if constexpr (CASE == SUBROLL1_ADD_I32) {
    op_run_row_roll<int, N>(in, out, t, smem);
  } else if constexpr (CASE == SUBROLL1_ADD_U8) {
    op_run_row_roll<uint8_t, N>(in, out, t, smem);
  } else if constexpr (CASE == CVT_U8_I32_RT) {
    op_run_convert<uint8_t, N>(in, out, t, smem);
  } else if constexpr (CASE == CVT_I16_I32_RT) {
    op_run_convert<int16_t, N>(in, out, t, smem);
  } else if constexpr (CASE == ADD_U8) {
    op_run_sweeps<CASE, uint8_t, N>(in, out, t, smem);
  } else if constexpr (CASE == ADD_I16) {
    op_run_sweeps<CASE, int16_t, N>(in, out, t, smem);
  } else if constexpr (CASE == ADD_F32 || CASE == MUL_ADD_F32) {
    op_run_sweeps<CASE, float, N>(in, out, t, smem);
  } else if constexpr (CASE == MIS_SLICE_ADD_I32) {
    op_run_row_shrink<int, 1, N>(in, out, t, smem);
  } else if constexpr (CASE == MIS_SLICE_ADD_I16) {
    op_run_row_shrink<int16_t, 1, N>(in, out, t, smem);
  } else if constexpr (CASE == AL_SLICE_ADD_I16) {
    op_run_row_shrink<int16_t, 8, N>(in, out, t, smem);
  } else if constexpr (CASE == ROLL3_I32) {
    op_run_lane_roll<3, false, N>(in, out, t, smem);
  } else if constexpr (CASE == ROLL3_ADD_I32) {
    op_run_lane_roll<3, true, N>(in, out, t, smem);
  } else if constexpr (CASE == ROLL1_ADD_I32) {
    op_run_lane_roll<1, true, N>(in, out, t, smem);
  } else if constexpr (CASE == ROLL128_ADD_I32) {
    op_run_lane_roll<128, true, N>(in, out, t, smem);
  } else if constexpr (CASE == VADD4_U8 || CASE == VADD2_I16) {
    op_run_packed<CASE, N>(in, out, t, smem);
  } else {
    op_run_sweeps<CASE, int, N>(in, out, t, smem);
  }
}

// Shared-memory bytes of one tile (mirrored by ops/lab.py
// op_chain_smem_bytes).
static size_t op_smem(int op_case, const OpTile& t) {
  const size_t n = (size_t)t.in_block * t.wc;
  switch (op_case) {
    case MXU_ROWS_BF16: return (n + (size_t)OP_BAND * t.wc) * 4;
    case MXU_ROWS_I8: return (n + (size_t)(OP_BAND / 4) * t.wc) * 4;
    case SUBROLL1_ADD_U8: case ADD_U8: case VADD4_U8: return n;
    case ADD_I16: case MIS_SLICE_ADD_I16: case AL_SLICE_ADD_I16:
    case VADD2_I16: return n * 2;
    case CVT_U8_I32_RT: return n * 5;
    case CVT_I16_I32_RT: return n * 6;
    case ROLL3_I32: case ROLL3_ADD_I32: case ROLL1_ADD_I32:
    case ROLL128_ADD_I32: return n * 8;
    default: return n * 4;
  }
}

template <int CASE, int N>
static int launch(const uint8_t* src, uint8_t* dst, const void* aux,
                  const OpTile& t, int grid, cudaStream_t stream) {
  const size_t smem = op_smem(CASE, t);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)op_chain_kernel<CASE, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (t.wc + 31) / 32 * 32;
  if (threads > OP_MAX_THREADS) threads = OP_MAX_THREADS;
  op_chain_kernel<CASE, N><<<grid, threads, smem, stream>>>(src, dst, aux, t);
  return (int)cudaGetLastError();
}

typedef int (*OpLaunch)(const uint8_t*, uint8_t*, const void*, const OpTile&,
                        int, cudaStream_t);

template <int CASE>
struct OpTable {
  static void fill(OpLaunch (*table)[3]) {
    table[CASE][0] = launch<CASE, 3>;
    table[CASE][1] = launch<CASE, 8>;
    table[CASE][2] = launch<CASE, 16>;
    OpTable<CASE + 1>::fill(table);
  }
};
template <>
struct OpTable<OP_N_CASES> {
  static void fill(OpLaunch (*)[3]) {}
};

extern "C" {

// One launch of case `op_case` with a chain of `n_ops` (3, 8 or 16) on `grid`
// tiles: src is (grid * in_block, wc) uint8, dst (grid * block, wc) uint8,
// aux the band matrix of the mxu_rows_* cases (else unused). Returns the
// cudaError_t of the launch (0 = launched).
int op_chain_launch(int op_case, int n_ops, const void* src, void* dst,
                    const void* aux, int in_block, int block, int wc,
                    int grid, void* stream) {
  static OpLaunch table[OP_N_CASES][3];
  static bool filled = false;
  if (!filled) {
    OpTable<0>::fill(table);
    filled = true;
  }
  const int chain = n_ops == 3 ? 0 : n_ops == 8 ? 1 : n_ops == 16 ? 2 : -1;
  if (op_case < 0 || op_case >= OP_N_CASES || chain < 0 || in_block < 1 ||
      block < 1 || block > in_block || wc < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const OpTile t{in_block, block, wc};
  return table[op_case][chain](
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), aux, t,
      grid, static_cast<cudaStream_t>(stream));
}

long long op_chain_smem(int op_case, int in_block, int wc) {
  const OpTile t{in_block, in_block, wc};
  return (long long)op_smem(op_case, t);
}

int op_chain_n_cases() { return OP_N_CASES; }

const char* op_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
