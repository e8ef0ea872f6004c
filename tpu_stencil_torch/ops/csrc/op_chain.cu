// L1 `op_chain`: a chain of N identical operations on one tile, to cost
// single machine operations on this card.
//
// Replaces the TPU kernel of `make_case` (tools/op_cost.py:31, its
// pallas_call at :47): per tile, convert an (in_block, wc) uint8 tile to the
// case's type, apply the case's operation N times, store the first `block`
// rows as uint8 (integers wrap, float32 saturates). The tool times a chain
// of 2N against a chain of N; the difference over N is one operation over
// the tile, with the load, the store and the launch cancelled. The function
// of every case is the TPU case's; what one operation costs follows this
// card. Each form reads only the rows the stored rows depend on (the block
// rows; a shrinking add at offset s the block + s*N; the row roll all
// in_block; the band products their 144) and computes only those.
//
// What bounds each group, and what the design does about it:
//
//   registers, flat        the elementwise cases (add_*, mul_*, shift,
//     (FORM_FLAT)          where, clip, add_f32, mul_add_f32, cvt_*_rt,
//                          strip_add_i32, vadd4_u8, vadd2_i16). A thread
//                          owns 16 bytes of a tile's stored rows (a block
//                          128 runs of one tile, so no division finds the
//                          tile): one 16-byte load, a PRMT a byte to unpack,
//                          N operations on 16 registers (16 independent
//                          chains), PRMTs to pack, one 16-byte store; no
//                          shared memory, no barrier. Bound: the integer
//                          pipes (ptxas splits the adds between IADD3 on
//                          the ALU and IMAD on the FMA pipe) beside the
//                          tile's bytes, which the launch overlaps.
//                          add_u8 / add_i16 keep their own width's wrap;
//                          vadd4 / vadd2 stay packed (four uint8 or two
//                          int16 a word); cvt_*_rt are the two convert
//                          instructions of a narrow value in a register
//                          (I2I / PRMT), no longer narrow memory traffic.
//   registers, columns     the row-neighbour cases subroll1_* (tiles of 48
//     (FORM_COLS)          rows) and mis_slice_* (tiles storing 32 rows): a
//                          thread owns one lane and every row the chain
//                          needs (48 registers at most), so the row neighbour
//                          is another register of the same thread. One byte
//                          a row per thread; a warp's 32 fill a sector.
//                          Bound: the adds, as the flat form's.
//   shared, columns        al_slice_add_i16 (block + 8N rows, 288 at the
//     (FORM_SHRINK_SMEM,   TPU's block: more than registers hold) and the
//      FORM_ROLL_SMEM)     row-neighbour cases at other tiles: the rows of
//                          a column strip of the tile in shared memory
//                          (sized for 2 blocks per SM), loaded and stored
//                          in 16-byte vectors; each thread walks its own
//                          lanes, so no barrier between operations, and
//                          loads each row's old value once, holding it in
//                          a register for its own add (the offset-8 add
//                          loads a group of 8 before it stores any).
//                          Bound: shared-memory instruction issue, a load
//                          and a store an element and operation.
//   shared buffer          the lane rolls roll1/roll3/roll3_add/roll128:
//     (FORM_LANES)         a thread owns one lane of 8 rows, a block whole
//                          rows. Every lane writes its values to a shared
//                          buffer and reads its source lane's after one
//                          barrier an operation (two buffers in turn).
//                          Bound: shared-memory instruction issue (a store
//                          and a load an element) and the barrier. A
//                          shuffle within the warp, the buffer only for the
//                          lanes across warps and the end-around, was
//                          slower on this card: the shuffle was issued for
//                          every lane all the same. Four lanes a thread was
//                          slower too: its registers held a block of 3
//                          warps to 6 an SM.
//   warp shuffle           shfl1/shfl3 roll within 32-lane groups by
//     (FORM_STRIPS)        __shfl_sync alone.
//   tensor cores           mxu_rows_bf16 / mxu_rows_i8: the 144x144 band
//     (FORM_BAND)          matrix A in shared memory as bf16 or int8, the
//                          tile's first 144 rows of a 64-lane strip in shared
//                          memory transposed (k contiguous, the B operand),
//                          converted once per operation; nine warps, one per
//                          16-row m-tile, each accumulating its 16 x 64
//                          outputs in registers with mma.sync m16n8k16
//                          bf16 -> f32 or m16n8k32 s8 -> s32 (K padded with
//                          zeros to 160), the results written back as the
//                          next operation's operand. int32 -> f32 -> bf16
//                          round to nearest even as the plain version; the
//                          int8 sums are exact. Bound: the tensor-core rate
//                          at the card's peak, far below the barriers and
//                          fragment traffic of so small a product.
//
// Every operation on a register is one or two predicated PTX instructions
// whose predicate (`on` differs from the operation's index) is true at every
// launch but opaque to the compiler, and differs from operation to
// operation: neither NVVM nor ptxas can fold or merge a chain. An empty
// asm between C operations stops NVVM only: ptxas folded the old kernel's
// strip_add_i32 chain of doublings into one shift (the same time at a chain
// of 8 and of 16). N is a template parameter, so every chain is unrolled as
// on the TPU. The library holds three chains: 8 and 16, which the tool
// times, and 3, which it only checks: eight doublings (or eight shifts) of
// a byte leave nothing in the uint8 that is stored.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 into a shared
// library with a plain C interface (loaded with ctypes). The float cases use
// add.rn / mul.rn, so that no multiply-add is contracted and the result
// equals the plain version's bit for bit.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#define OP_FLAT_THREADS 128     // threads of a FORM_FLAT block
#define OP_COL_THREADS 64       // threads (lanes) of a FORM_COLS/STRIPS block
#define OP_SMEM_THREADS 512     // most threads of a shared-memory form block
#define OP_LANES_MAX 1024       // widest row a lane-roll block holds
#define OP_BAND 144             // rows and columns of the band matrix
#define OP_REG_BLOCK 32         // stored rows of the register shrink form
#define OP_REG_ROWS 48          // rows of the register row-roll form
#define OP_STRIP 8              // rows a thread holds in the lane forms
#define OP_SMEM_TARGET (112 * 1024)  // a shared form's tile: 2 blocks per SM
#define OP_MMA_COLS 64          // lanes of a band block: 8 n-tiles of 8
#define OP_MMA_THREADS 288      // 9 warps, one per 16-row m-tile of 144
#define OP_BF16_PITCH 152       // bf16 a row of A and of the tile (144 + 8)
#define OP_I8_K 160             // int8 depth: 144 padded to 5 x 32
#define OP_I8_PITCH 176         // bytes a row of A and of the tile (160 + 16)

// Case ids: mirrored by CASES in tpu_stencil_torch/ops/lab.py.
enum OpCase {
  MXU_ROWS_BF16 = 0, MXU_ROWS_I8, STRIP_ADD_I32, SUBROLL1_ADD_I32,
  SUBROLL1_ADD_U8, CVT_U8_I32_RT, ADD_U8, ADD_I32, ADD_I16,
  MIS_SLICE_ADD_I32, MIS_SLICE_ADD_I16, AL_SLICE_ADD_I16, ROLL3_I32,
  ROLL3_ADD_I32, ROLL1_ADD_I32, ROLL128_ADD_I32, ADD_F32, MUL_ADD_F32,
  MUL_ADD_I32, SHIFT_I32, WHERE_I32, CVT_I16_I32_RT, MUL_I32, CLIP_I32,
  VADD4_U8, VADD2_I16, SHFL1_ADD_I32, SHFL3_ADD_I32, OP_N_CASES
};

// Forms: mirrored by FORMS in tpu_stencil_torch/ops/lab.py.
enum OpForm {
  FORM_FLAT = 0, FORM_COLS, FORM_STRIPS, FORM_LANES, FORM_SHRINK_SMEM,
  FORM_ROLL_SMEM, FORM_BAND
};

struct OpTile {
  int in_block;  // rows of the input tile
  int block;     // rows stored
  int wc;        // lanes per row
  int grid;      // tiles
  unsigned on;   // all ones: every operation's predicate is true
};

struct OpShape {
  int form, blocks_x, blocks_y, threads;
  long long smem;
};

// ---- the host's model of a launch (mirrored by ops/lab.py) ----------------

__host__ __device__ constexpr int op_ceil(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

__host__ __device__ constexpr bool op_is_lane_roll(int c) {
  return c == ROLL3_I32 || c == ROLL3_ADD_I32 || c == ROLL1_ADD_I32 ||
         c == ROLL128_ADD_I32;
}

__host__ __device__ constexpr int op_shrink(int c) {
  return c == AL_SLICE_ADD_I16 ? 8
         : (c == MIS_SLICE_ADD_I32 || c == MIS_SLICE_ADD_I16) ? 1 : 0;
}

// Bytes of one element of a shared-memory form's tile.
__host__ __device__ constexpr int op_smem_elem(int c) {
  return c == SUBROLL1_ADD_U8 ? 1
         : (c == MIS_SLICE_ADD_I16 || c == AL_SLICE_ADD_I16) ? 2 : 4;
}

// Rows a shared-memory form holds: the rows the stored rows depend on.
__host__ __device__ inline int op_smem_rows(int c, int n_ops,
                                            const OpTile& t) {
  return op_shrink(c) ? t.block + op_shrink(c) * n_ops : t.in_block;
}

// Lanes of a shared-memory form's column strip: the widest multiple of 16
// whose rows fit OP_SMEM_TARGET, at most the row.
__host__ __device__ inline int op_smem_cols(int c, int n_ops,
                                            const OpTile& t) {
  long long cw = (long long)OP_SMEM_TARGET /
                 ((long long)op_smem_rows(c, n_ops, t) * op_smem_elem(c));
  cw = cw / 16 * 16;
  if (cw < 16) cw = 16;
  return cw < t.wc ? (int)cw : t.wc;
}

static int op_form(int c, const OpTile& t) {
  if (c == MXU_ROWS_BF16 || c == MXU_ROWS_I8) return FORM_BAND;
  if (c == SUBROLL1_ADD_I32 || c == SUBROLL1_ADD_U8)
    return t.in_block == OP_REG_ROWS ? FORM_COLS : FORM_ROLL_SMEM;
  if (c == MIS_SLICE_ADD_I32 || c == MIS_SLICE_ADD_I16)
    return t.block == OP_REG_BLOCK ? FORM_COLS : FORM_SHRINK_SMEM;
  if (c == AL_SLICE_ADD_I16) return FORM_SHRINK_SMEM;
  if (c == SHFL1_ADD_I32 || c == SHFL3_ADD_I32) return FORM_STRIPS;
  if (op_is_lane_roll(c)) return FORM_LANES;
  return FORM_FLAT;
}

// Blocks (x, y): the flat form (tile, 16-byte runs), the column forms
// (tile [and strip], lanes), the others x alone.
static OpShape op_shape(int c, int n_ops, const OpTile& t) {
  OpShape s{op_form(c, t), t.grid, 1, OP_COL_THREADS, 0};
  const int strips = op_ceil(t.block, OP_STRIP);
  switch (s.form) {
    case FORM_FLAT:
      s.threads = OP_FLAT_THREADS;
      s.blocks_y = op_ceil(op_ceil((long long)t.block * t.wc, 16),
                           OP_FLAT_THREADS);
      break;
    case FORM_COLS:
      s.blocks_y = op_ceil(t.wc, OP_COL_THREADS);
      break;
    case FORM_STRIPS:
      s.blocks_x = t.grid * strips;
      s.blocks_y = op_ceil(t.wc, OP_COL_THREADS);
      break;
    case FORM_LANES:
      s.threads = op_ceil(t.wc, 32) * 32;
      s.blocks_x = t.grid * strips;
      s.smem = 2LL * OP_STRIP * s.threads * 4;
      break;
    case FORM_SHRINK_SMEM:
    case FORM_ROLL_SMEM: {
      const int cw = op_smem_cols(c, n_ops, t);
      s.threads = op_ceil(cw, 32) * 32;
      if (s.threads > OP_SMEM_THREADS) s.threads = OP_SMEM_THREADS;
      s.blocks_x = t.grid * op_ceil(t.wc, cw);
      s.smem = (long long)op_smem_rows(c, n_ops, t) * cw * op_smem_elem(c);
      break;
    }
    default:  // FORM_BAND
      s.threads = OP_MMA_THREADS;
      s.blocks_x = t.grid * op_ceil(t.wc, OP_MMA_COLS);
      s.smem = c == MXU_ROWS_BF16
                   ? (long long)(OP_BAND + OP_MMA_COLS) * OP_BF16_PITCH * 2
                   : (long long)(OP_BAND + OP_MMA_COLS) * OP_I8_PITCH;
  }
  return s;
}

// ---- 16-byte global access ------------------------------------------------

// Bytes [0, cnt) at p (zero above): one 16-byte load where p is 16-aligned,
// narrower aligned loads where it is 8- or 4-aligned, bytes where it is not
// or at a ragged edge (cnt < 16).
__device__ __forceinline__ uint4 op_ld16(const uint8_t* p, int cnt) {
  const unsigned a = (unsigned)(size_t)p & 15;
  if (cnt >= 16) {
    if (a == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    if ((a & 7) == 0) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      const uint2 y = __ldg(reinterpret_cast<const uint2*>(p) + 1);
      return make_uint4(x.x, x.y, y.x, y.y);
    }
    if ((a & 3) == 0) {
      const unsigned* q = reinterpret_cast<const unsigned*>(p);
      return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < cnt) w[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store bytes [0, cnt) of v at p, with the same choice of width.
__device__ __forceinline__ void op_st16(uint8_t* p, int cnt, uint4 v) {
  const unsigned a = (unsigned)(size_t)p & 15;
  if (cnt >= 16) {
    if (a == 0) {
      *reinterpret_cast<uint4*>(p) = v;
      return;
    }
    if ((a & 7) == 0) {
      reinterpret_cast<uint2*>(p)[0] = make_uint2(v.x, v.y);
      reinterpret_cast<uint2*>(p)[1] = make_uint2(v.z, v.w);
      return;
    }
    if ((a & 3) == 0) {
      unsigned* q = reinterpret_cast<unsigned*>(p);
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
      return;
    }
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < cnt) p[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

__device__ __forceinline__ uint8_t op_byte(uint4 v, int i) {
  const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (uint8_t)(w >> (8 * (i & 3)));
}

// ---- one operation on registers -------------------------------------------

// The register type a case computes in: int32 and the int16 round trip in
// 32-bit registers, float, int16 and the uint8 adds in 16-bit registers,
// the packed cases and the uint8 round trip in 32-bit words.
template <int CASE>
struct OpReg {
  using T = int;
};
template <> struct OpReg<ADD_F32> { using T = float; };
template <> struct OpReg<MUL_ADD_F32> { using T = float; };
template <> struct OpReg<ADD_I16> { using T = short; };
template <> struct OpReg<MIS_SLICE_ADD_I16> { using T = short; };
template <> struct OpReg<AL_SLICE_ADD_I16> { using T = short; };
template <> struct OpReg<ADD_U8> { using T = unsigned short; };
template <> struct OpReg<SUBROLL1_ADD_U8> { using T = unsigned short; };
template <> struct OpReg<CVT_U8_I32_RT> { using T = unsigned; };
template <> struct OpReg<VADD4_U8> { using T = unsigned; };
template <> struct OpReg<VADD2_I16> { using T = unsigned; };

// "@p": true at run time (`on` is all ones, `i` an operation's index), a
// fresh predicate for every operation as far as the compiler can tell.
#define OP_PRED(decls) \
  "{\n\t.reg .pred p;\n\t" decls "setp.ne.u32 p, %1, %2;\n\t"

// One operation of an elementwise case on v; i: the operation's index.
template <int CASE, typename T>
__device__ __forceinline__ void op_step(T& v, unsigned on, int i) {
  if constexpr (CASE == ADD_I32 || CASE == STRIP_ADD_I32) {
    asm volatile(OP_PRED("") "@p add.s32 %0, %0, %0;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == MUL_I32) {
    asm volatile(OP_PRED("") "@p mul.lo.s32 %0, %0, 3;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == MUL_ADD_I32) {
    asm volatile(OP_PRED("") "@p mad.lo.s32 %0, %0, 3, %0;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == SHIFT_I32) {
    asm volatile(OP_PRED("") "@p shr.s32 %0, %0, 1;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == WHERE_I32) {
    asm volatile(OP_PRED("") "@p max.s32 %0, %0, 0;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == CLIP_I32) {
    asm volatile(OP_PRED("") "@p max.s32 %0, %0, 0;\n\t@p min.s32 %0, %0, 255;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == ADD_F32) {
    asm volatile(OP_PRED("") "@p add.rn.f32 %0, %0, %0;\n\t}"
                 : "+f"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == MUL_ADD_F32) {
    asm volatile(OP_PRED(".reg .f32 t;\n\t") "@p mul.rn.f32 t, %0, %3;\n\t"
                 "@p add.rn.f32 %0, t, %0;\n\t}"
                 : "+f"(v) : "r"(on), "r"(i), "f"(0.998f));
  } else if constexpr (CASE == ADD_I16) {
    asm volatile(OP_PRED("") "@p add.s16 %0, %0, %0;\n\t}"
                 : "+h"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == ADD_U8) {
    // no 8-bit add: a 16-bit add and the uint8 wrap
    asm volatile(OP_PRED("") "@p add.u16 %0, %0, %0;\n\t@p and.b16 %0, %0, 255;\n\t}"
                 : "+h"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == CVT_U8_I32_RT) {
    // the narrow value widened to int32, and back
    asm volatile(OP_PRED(".reg .b32 w;\n\t") "@p cvt.u32.u8 w, %0;\n\t"
                 "@p cvt.u8.u32 %0, w;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == CVT_I16_I32_RT) {
    asm volatile(OP_PRED(".reg .b32 w;\n\t") "@p cvt.s32.s16 w, %0;\n\t"
                 "@p cvt.s16.s32 %0, w;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == VADD4_U8) {
    // __vadd4(v, v): the word doubled, the carries across bytes cleared
    asm volatile(OP_PRED(".reg .b32 t;\n\t") "@p add.u32 t, %0, %0;\n\t"
                 "@p and.b32 %0, t, 0xFEFEFEFE;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  } else if constexpr (CASE == VADD2_I16) {
    // __vadd2(v, v): the carry out of the low int16 cleared
    asm volatile(OP_PRED(".reg .b32 t;\n\t") "@p add.u32 t, %0, %0;\n\t"
                 "@p and.b32 %0, t, 0xFFFEFFFF;\n\t}"
                 : "+r"(v) : "r"(on), "r"(i));
  }
}

// One add of a neighbour: a = a + b in the case's width (the row and lane
// neighbour cases).
template <int CASE, typename T>
__device__ __forceinline__ void op_add(T& a, T b, unsigned on, int i) {
  if constexpr (sizeof(T) == 4) {
    asm volatile(OP_PRED("") "@p add.s32 %0, %0, %3;\n\t}"
                 : "+r"(a) : "r"(on), "r"(i), "r"(b));
  } else if constexpr (CASE == SUBROLL1_ADD_U8) {
    asm volatile(OP_PRED("") "@p add.u16 %0, %0, %3;\n\t@p and.b16 %0, %0, 255;\n\t}"
                 : "+h"(a) : "r"(on), "r"(i), "h"(b));
  } else {
    asm volatile(OP_PRED("") "@p add.s16 %0, %0, %3;\n\t}"
                 : "+h"(a) : "r"(on), "r"(i), "h"(b));
  }
}

// A value as the uint8 stored, in the low byte of a word (the others
// anything): integers wrap, float32 saturates.
template <typename T>
__device__ __forceinline__ uint32_t op_low(T v) {
  if constexpr (std::is_same<T, float>::value)
    return (uint32_t)fminf(fmaxf(v, 0.0f), 255.0f);
  else
    return (uint32_t)v;
}

// ---- FORM_FLAT: 16 bytes of the stored rows a thread, in registers --------

// A byte of w as a value, and the low bytes of four values as a word, one
// PRMT each (w's bytes: 0 = a, 1 = b, ...).
__device__ __forceinline__ uint32_t op_unpack(uint32_t w, int b) {
  return __byte_perm(w, 0, 0x4440 | b);
}
__device__ __forceinline__ uint32_t op_pack(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The chain on 16 bytes (four words), in place.
template <int CASE, int N>
__device__ __forceinline__ void op_flat_chain(uint32_t (&w)[4], unsigned on) {
  using T = typename OpReg<CASE>::T;
  if constexpr (CASE == VADD4_U8) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) op_step<CASE>(w[k], on, i);
  } else if constexpr (CASE == VADD2_I16) {
    uint32_t h[8];  // bytes 2k, 2k + 1 as the two int16 of word k
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[2 * k] = __byte_perm(w[k], 0, 0x4140);
      h[2 * k + 1] = __byte_perm(w[k], 0, 0x4342);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) op_step<CASE>(h[k], on, i);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __byte_perm(h[2 * k], h[2 * k + 1], 0x6420);
  } else {
    T v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = (T)op_unpack(w[b >> 2], b & 3);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int b = 0; b < 16; ++b) op_step<CASE>(v[b], on, i);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = op_pack(op_low(v[4 * k]), op_low(v[4 * k + 1]),
                     op_low(v[4 * k + 2]), op_low(v[4 * k + 3]));
  }
}

// Block (tile, y): the tile's stored rows are one flat run of block * wc
// bytes; thread x of block y owns its 16 bytes at (y * OP_FLAT_THREADS +
// x) * 16.
template <int CASE, int N>
__device__ void op_flat(const uint8_t* src, uint8_t* dst, const OpTile& t) {
  const int n = t.block * t.wc;
  const int e0 = (blockIdx.y * blockDim.x + threadIdx.x) * 16;
  if (e0 >= n) return;
  const int cnt = min(16, n - e0);
  const uint4 raw =
      op_ld16(src + (size_t)blockIdx.x * t.in_block * t.wc + e0, cnt);
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  op_flat_chain<CASE, N>(w, t.on);
  op_st16(dst + (size_t)blockIdx.x * n + e0, cnt,
          make_uint4(w[0], w[1], w[2], w[3]));
}

// ---- FORM_COLS: one lane and its rows a thread, in registers --------------

template <int CASE, int N>
__device__ void op_cols(const uint8_t* src, uint8_t* dst, const OpTile& t) {
  using T = typename OpReg<CASE>::T;
  constexpr bool roll = CASE == SUBROLL1_ADD_I32 || CASE == SUBROLL1_ADD_U8;
  constexpr int R = roll ? OP_REG_ROWS : OP_REG_BLOCK + N;  // rows held
  const int tile = blockIdx.x, c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= t.wc) return;
  const uint8_t* in = src + (size_t)tile * t.in_block * t.wc + c;
  T x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = (T)__ldg(in + (size_t)r * t.wc);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (roll) {  // x[r] += x[r - 1], end-around
      const T last = x[R - 1];
#pragma unroll
      for (int r = R - 1; r > 0; --r) op_add<CASE>(x[r], x[r - 1], t.on, i);
      op_add<CASE>(x[0], last, t.on, i);
    } else {  // x[r] += x[r + 1] on the rows the stored ones still need
#pragma unroll
      for (int r = 0; r < OP_REG_BLOCK + N - 1 - i; ++r)
        op_add<CASE>(x[r], x[r + 1], t.on, i);
    }
  }
  uint8_t* out = dst + (size_t)tile * t.block * t.wc + c;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < t.block) out[(size_t)r * t.wc] = (uint8_t)x[r];
}

// ---- FORM_STRIPS: shfl*, one lane of 8 rows a thread ----------------------

template <int CASE, int N>
__device__ void op_strips(const uint8_t* src, uint8_t* dst, const OpTile& t) {
  constexpr int S = CASE == SHFL1_ADD_I32 ? 1 : 3;
  const int strips = op_ceil(t.block, OP_STRIP);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  // wc % 32 == 0: a warp is 32 lanes of one (tile, strip), all in or out
  if (c >= t.wc) return;
  const int tile = blockIdx.x / strips;
  const int r0 = (blockIdx.x % strips) * OP_STRIP;
  const int nr = min(OP_STRIP, t.block - r0);
  const uint8_t* in = src + ((size_t)tile * t.in_block + r0) * t.wc + c;
  int x[OP_STRIP];
#pragma unroll
  for (int j = 0; j < OP_STRIP; ++j)
    x[j] = j < nr ? __ldg(in + (size_t)j * t.wc) : 0;
  const int from = ((threadIdx.x & 31) - S) & 31;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < OP_STRIP; ++j)
      op_add<CASE>(x[j], __shfl_sync(0xffffffffu, x[j], from), t.on, i);
  uint8_t* out = dst + ((size_t)tile * t.block + r0) * t.wc + c;
#pragma unroll
  for (int j = 0; j < OP_STRIP; ++j)
    if (j < nr) out[(size_t)j * t.wc] = (uint8_t)x[j];
}

// ---- FORM_LANES: the lane rolls, a block whole rows of 8 ------------------

template <int CASE, int N>
__device__ void op_lanes(const uint8_t* src, uint8_t* dst, const OpTile& t,
                         unsigned char* smem) {
  constexpr int S = CASE == ROLL128_ADD_I32 ? 128
                    : CASE == ROLL1_ADD_I32 ? 1 : 3;
  constexpr bool ADD = CASE != ROLL3_I32;
  const int strips = op_ceil(t.block, OP_STRIP);
  const int tile = blockIdx.x / strips;
  const int r0 = (blockIdx.x % strips) * OP_STRIP;
  const int nr = min(OP_STRIP, t.block - r0);
  const int T = blockDim.x, c = threadIdx.x;
  const bool valid = c < t.wc;
  int from = c - S % t.wc;  // the source lane, end-around
  if (from < 0) from += t.wc;
  const uint8_t* in = src + ((size_t)tile * t.in_block + r0) * t.wc + c;
  int x[OP_STRIP];
#pragma unroll
  for (int j = 0; j < OP_STRIP; ++j)
    x[j] = valid && j < nr ? __ldg(in + (size_t)j * t.wc) : 0;
  int* buf = reinterpret_cast<int*>(smem);  // [2][OP_STRIP][T]
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int* b = buf + (i & 1) * OP_STRIP * T;
    if (valid) {
#pragma unroll
      for (int j = 0; j < OP_STRIP; ++j) b[j * T + c] = x[j];
    }
    __syncthreads();  // one barrier an operation: the buffers alternate
#pragma unroll
    for (int j = 0; j < OP_STRIP; ++j) {
      const int v = b[j * T + from];
      if constexpr (ADD) {
        op_add<CASE>(x[j], v, t.on, i);
      } else {
        x[j] = v;
      }
    }
  }
  uint8_t* out = dst + ((size_t)tile * t.block + r0) * t.wc + c;
  if (valid) {
#pragma unroll
    for (int j = 0; j < OP_STRIP; ++j)
      if (j < nr) out[(size_t)j * t.wc] = (uint8_t)x[j];
  }
}

// ---- FORM_SHRINK_SMEM / FORM_ROLL_SMEM: a column strip in shared memory ---

template <int CASE, int N>
__device__ void op_smem_cols_run(const uint8_t* src, uint8_t* dst,
                                 const OpTile& t, unsigned char* smem) {
  using T = typename OpReg<CASE>::T;
  using S = typename std::conditional<
      op_smem_elem(CASE) == 1, uint8_t,
      typename std::conditional<op_smem_elem(CASE) == 2, short,
                                int>::type>::type;
  constexpr int OFF = op_shrink(CASE);
  const int rows = op_smem_rows(CASE, N, t);
  const int cw = op_smem_cols(CASE, N, t);
  const int strips = op_ceil(t.wc, cw);
  const int tile = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * cw;
  const int w = min(cw, t.wc - c0);  // lanes of this strip
  const int nq = op_ceil(w, 16);
  S* s = reinterpret_cast<S*>(smem);  // [rows][cw]
  const uint8_t* in = src + (size_t)tile * t.in_block * t.wc + c0;
  for (int e = threadIdx.x; e < rows * nq; e += blockDim.x) {
    const int r = e / nq, q = (e % nq) * 16;
    const uint4 v = op_ld16(in + (size_t)r * t.wc + q, w - q);
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (q + b < w) s[r * cw + q + b] = (S)op_byte(v, b);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += blockDim.x) {  // a thread's own lanes
    // Each row's old value is loaded once, as the neighbour of the row
    // before it in the walk, and kept in a register for its own add: a
    // shared load and a store an element and operation. The shrinking add
    // loads a group of OFF neighbours before it stores any of the group's
    // rows, so that OFF loads are in flight at once (a load cannot pass a
    // store to shared memory that may alias it), and tests a row's bound
    // only past the last whole group (an asm statement is not predicated:
    // a test inside the group is a branch a row).
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      if constexpr (OFF > 0) {  // x[r] += x[r + OFF], stored rows' needs
        const int live = t.block + OFF * (N - 1 - i);
        T win[OFF];  // old rows r .. r + OFF - 1
#pragma unroll
        for (int k = 0; k < OFF; ++k) win[k] = (T)s[k * cw + c];
        int r = 0;
        for (; r + OFF <= live; r += OFF) {
          T nb[OFF];  // old rows r + OFF .. r + 2 * OFF - 1
#pragma unroll
          for (int k = 0; k < OFF; ++k) nb[k] = (T)s[(r + k + OFF) * cw + c];
#pragma unroll
          for (int k = 0; k < OFF; ++k) {
            T a = win[k];
            op_add<CASE>(a, nb[k], t.on, i);
            s[(r + k) * cw + c] = (S)a;
            win[k] = nb[k];
          }
        }
#pragma unroll
        for (int k = 0; k < OFF; ++k) {  // the rows past the last group
          if (r + k < live) {
            T a = win[k];
            op_add<CASE>(a, (T)s[(r + k + OFF) * cw + c], t.on, i);
            s[(r + k) * cw + c] = (S)a;
          }
        }
      } else {  // x[r] += x[r - 1], end-around
        const T last = (T)s[(rows - 1) * cw + c];
        T a = last;
        for (int r = rows - 1; r > 0; --r) {
          const T nb = (T)s[(r - 1) * cw + c];
          op_add<CASE>(a, nb, t.on, i);
          s[r * cw + c] = (S)a;
          a = nb;
        }
        op_add<CASE>(a, last, t.on, i);
        s[c] = (S)a;
      }
    }
  }
  __syncthreads();
  uint8_t* out = dst + (size_t)tile * t.block * t.wc + c0;
  for (int e = threadIdx.x; e < t.block * nq; e += blockDim.x) {
    const int r = e / nq, q = (e % nq) * 16;
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (q + b < w)
        v[b >> 2] |= (uint32_t)(uint8_t)s[r * cw + q + b] << (8 * (b & 3));
    op_st16(out + (size_t)r * t.wc + q, w - q, make_uint4(v[0], v[1], v[2], v[3]));
  }
}

// ---- FORM_BAND: the band products on tensor cores -------------------------

__device__ __forceinline__ void op_mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void op_mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The next operation's operand from an int32 result: bf16 of float32 of y
// (both round to nearest even), or y's low byte as int8.
template <bool BF>
__device__ __forceinline__ void op_band_put(unsigned char* xs, int n, int m,
                                            int y) {
  if constexpr (BF) {
    reinterpret_cast<__nv_bfloat16*>(xs)[n * OP_BF16_PITCH + m] =
        __float2bfloat16_rn(__int2float_rn(y));
  } else {
    xs[n * OP_I8_PITCH + m] = (unsigned char)y;
  }
}

// y = A (144 x 144) @ x[:144] on a 64-lane strip of a tile; x = y on the
// first 144 rows and zero below. `aux` is A, row-major, bf16 or int8.
template <int CASE, int N>
__device__ void op_band(const uint8_t* src, uint8_t* dst, const void* aux,
                        const OpTile& t, unsigned char* smem) {
  constexpr bool BF = CASE == MXU_ROWS_BF16;
  constexpr int PITCH = BF ? OP_BF16_PITCH * 2 : OP_I8_PITCH;  // bytes
  const int strips = op_ceil(t.wc, OP_MMA_COLS);
  const int tile = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * OP_MMA_COLS;
  const int w = min(OP_MMA_COLS, t.wc - c0);
  unsigned char* as = smem;                    // A: [144][k]
  unsigned char* xs = smem + OP_BAND * PITCH;  // the tile: [64 lanes][k]
  const int tid = threadIdx.x;
  // Zero both (K's padding, the lanes past a ragged edge), then A.
  for (int e = tid; e < (OP_BAND + OP_MMA_COLS) * PITCH / 16;
       e += blockDim.x)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  constexpr int AROW = BF ? OP_BAND * 2 : OP_BAND;  // bytes of a row of aux
  for (int e = tid; e < OP_BAND * AROW / 16; e += blockDim.x) {
    const int r = e / (AROW / 16), q = e % (AROW / 16);
    *reinterpret_cast<uint4*>(as + r * PITCH + q * 16) =
        __ldg(reinterpret_cast<const uint4*>(aux) + e);
  }
  // The tile's first 144 rows, uint8 -> bf16 (exact) or int8, transposed.
  const uint8_t* in = src + (size_t)tile * t.in_block * t.wc + c0;
  for (int e = tid; e < OP_BAND * 4; e += blockDim.x) {
    const int k = e >> 2, q = (e & 3) * 16;
    if (q >= w) continue;
    const uint4 v = op_ld16(in + (size_t)k * t.wc + q, w - q);
#pragma unroll
    for (int b = 0; b < 16; ++b)
      op_band_put<BF>(xs, q + b, k, (int)op_byte(v, b));
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int m0 = warp * 16;
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    int y[8][4];
    if constexpr (BF) {
      float acc[8][4] = {};
#pragma unroll
      for (int kt = 0; kt < OP_BAND / 16; ++kt) {
        const uint32_t* ar = reinterpret_cast<const uint32_t*>(as);
        const int a0 = ((m0 + g) * OP_BF16_PITCH + kt * 16 + 2 * q4) / 2;
        const uint32_t a[4] = {ar[a0], ar[a0 + 4 * OP_BF16_PITCH],
                               ar[a0 + 4], ar[a0 + 4 * OP_BF16_PITCH + 4]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t* br = reinterpret_cast<const uint32_t*>(xs);
          const int b0 = ((nt * 8 + g) * OP_BF16_PITCH + kt * 16 + 2 * q4) / 2;
          op_mma_bf16(acc[nt], a, br[b0], br[b0 + 4]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nt][e] = __float2int_rz(acc[nt][e]);
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[nt][e] = 0;
#pragma unroll
      for (int kt = 0; kt < OP_I8_K / 32; ++kt) {
        const uint32_t* ar = reinterpret_cast<const uint32_t*>(as);
        const int a0 = ((m0 + g) * OP_I8_PITCH + kt * 32 + 4 * q4) / 4;
        const uint32_t a[4] = {ar[a0], ar[a0 + 2 * OP_I8_PITCH],
                               ar[a0 + 4], ar[a0 + 2 * OP_I8_PITCH + 4]};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t* br = reinterpret_cast<const uint32_t*>(xs);
          const int b0 = ((nt * 8 + g) * OP_I8_PITCH + kt * 32 + 4 * q4) / 4;
          op_mma_s8(y[nt], a, br[b0], br[b0 + 4]);
        }
      }
    }
    __syncthreads();  // every warp has read the operand
    if (i + 1 < N) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          op_band_put<BF>(xs, nt * 8 + 2 * q4 + (e & 1), m0 + g + (e >> 1) * 8,
                          y[nt][e]);
      __syncthreads();
    } else {  // the stored rows' low bytes, staged [m][64] over the operand
      const int rows = min(t.block, OP_BAND);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + g + (e >> 1) * 8;
          if (m < rows)
            xs[m * OP_MMA_COLS + nt * 8 + 2 * q4 + (e & 1)] =
                (unsigned char)y[nt][e];
        }
      __syncthreads();
      uint8_t* out = dst + (size_t)tile * t.block * t.wc + c0;
      for (int e = tid; e < t.block * 4; e += blockDim.x) {
        const int m = e >> 2, q = (e & 3) * 16;
        if (q >= w) continue;
        const uint4 v = m < rows ? *reinterpret_cast<const uint4*>(
                                       xs + m * OP_MMA_COLS + q)
                                 : make_uint4(0, 0, 0, 0);
        op_st16(out + (size_t)m * t.wc + q, w - q, v);
      }
    }
  }
}

// ---- one kernel per (case, N) ---------------------------------------------

__host__ __device__ constexpr int op_max_threads(int c) {
  return op_is_lane_roll(c) ? OP_LANES_MAX : OP_SMEM_THREADS;
}

template <int CASE, int N>
__global__ void __launch_bounds__(op_max_threads(CASE))
    op_chain_kernel(const uint8_t* __restrict__ src,
                    uint8_t* __restrict__ dst, const void* aux, OpTile t,
                    int form) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (CASE == MXU_ROWS_BF16 || CASE == MXU_ROWS_I8) {
    op_band<CASE, N>(src, dst, aux, t, smem);
  } else if constexpr (CASE == SHFL1_ADD_I32 || CASE == SHFL3_ADD_I32) {
    op_strips<CASE, N>(src, dst, t);
  } else if constexpr (op_is_lane_roll(CASE)) {
    op_lanes<CASE, N>(src, dst, t, smem);
  } else if constexpr (CASE == AL_SLICE_ADD_I16) {
    op_smem_cols_run<CASE, N>(src, dst, t, smem);
  } else if constexpr (CASE == SUBROLL1_ADD_I32 || CASE == SUBROLL1_ADD_U8 ||
                       CASE == MIS_SLICE_ADD_I32 ||
                       CASE == MIS_SLICE_ADD_I16) {
    if (form == FORM_COLS)
      op_cols<CASE, N>(src, dst, t);
    else
      op_smem_cols_run<CASE, N>(src, dst, t, smem);
  } else {
    op_flat<CASE, N>(src, dst, t);
  }
}

template <int CASE, int N>
static int launch(const uint8_t* src, uint8_t* dst, const void* aux,
                  const OpTile& t, cudaStream_t stream) {
  const OpShape s = op_shape(CASE, N, t);
  if (s.threads > op_max_threads(CASE) || s.blocks_x < 1 ||
      s.blocks_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (s.smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)op_chain_kernel<CASE, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return (int)err;
  }
  op_chain_kernel<CASE, N><<<dim3(s.blocks_x, s.blocks_y), s.threads, s.smem,
                              stream>>>(
      src, dst, aux, t, s.form);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of the instance at shape s.
template <int CASE, int N>
static int occupancy(const OpShape& s, int* blocks) {
  const void* fn = (const void*)op_chain_kernel<CASE, N>;
  if (s.smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, s.threads, (size_t)s.smem);
}

typedef int (*OpLaunch)(const uint8_t*, uint8_t*, const void*, const OpTile&,
                        cudaStream_t);
typedef int (*OpOccupancy)(const OpShape&, int*);

struct OpEntry {
  OpLaunch launch;
  OpOccupancy occupancy;
};

template <int CASE>
struct OpTable {
  static void fill(OpEntry (*table)[3]) {
    table[CASE][0] = {launch<CASE, 3>, occupancy<CASE, 3>};
    table[CASE][1] = {launch<CASE, 8>, occupancy<CASE, 8>};
    table[CASE][2] = {launch<CASE, 16>, occupancy<CASE, 16>};
    OpTable<CASE + 1>::fill(table);
  }
};
template <>
struct OpTable<OP_N_CASES> {
  static void fill(OpEntry (*)[3]) {}
};

static const OpEntry* op_entry(int op_case, int n_ops) {
  static OpEntry table[OP_N_CASES][3];
  static bool filled = false;
  if (!filled) {
    OpTable<0>::fill(table);
    filled = true;
  }
  const int chain = n_ops == 3 ? 0 : n_ops == 8 ? 1 : n_ops == 16 ? 2 : -1;
  if (op_case < 0 || op_case >= OP_N_CASES || chain < 0) return nullptr;
  return &table[op_case][chain];
}

// The tiles a case is defined on (ops/lab.py check_op_tile), and the
// lane rolls' widest row.
static bool op_tile_ok(int op_case, int n_ops, int in_block, int block,
                       int wc, int grid) {
  if (in_block < 1 || block < 1 || block > in_block || wc < 1 || grid < 1)
    return false;
  if (in_block < block + op_shrink(op_case) * n_ops) return false;
  if (op_is_lane_roll(op_case) && wc > OP_LANES_MAX) return false;
  if ((op_case == MXU_ROWS_BF16 || op_case == MXU_ROWS_I8) &&
      in_block < OP_BAND)
    return false;
  if ((op_case == VADD4_U8 && wc % 4) || (op_case == VADD2_I16 && wc % 2) ||
      ((op_case == SHFL1_ADD_I32 || op_case == SHFL3_ADD_I32) && wc % 32))
    return false;
  return true;
}

extern "C" {

// One launch of case `op_case` with a chain of `n_ops` (3, 8 or 16) on `grid`
// tiles: src is (grid * in_block, wc) uint8, dst (grid * block, wc) uint8,
// aux the band matrix of the mxu_rows_* cases (bf16 or int8, else unused).
// Returns the cudaError_t of the launch (0 = launched).
int op_chain_launch(int op_case, int n_ops, const void* src, void* dst,
                    const void* aux, int in_block, int block, int wc,
                    int grid, void* stream) {
  const OpEntry* e = op_entry(op_case, n_ops);
  if (!e || !op_tile_ok(op_case, n_ops, in_block, block, wc, grid))
    return (int)cudaErrorInvalidValue;
  const OpTile t{in_block, block, wc, grid, 0xffffffffu};
  return e->launch(static_cast<const uint8_t*>(src),
                   static_cast<uint8_t*>(dst), aux, t,
                   static_cast<cudaStream_t>(stream));
}

// Shared-memory bytes of one block (ops/lab.py op_chain_smem_bytes).
long long op_chain_smem(int op_case, int n_ops, int in_block, int block,
                        int wc) {
  const OpTile t{in_block, block, wc, 1, 0xffffffffu};
  return op_shape(op_case, n_ops, t).smem;
}

// The launch of (op_case, n_ops) on a tile: out = {form, blocks, threads,
// shared bytes, resident blocks per SM on the current card}. Returns a
// cudaError_t.
int op_chain_shape(int op_case, int n_ops, int in_block, int block, int wc,
                   int grid, long long* out) {
  const OpEntry* e = op_entry(op_case, n_ops);
  if (!e || !op_tile_ok(op_case, n_ops, in_block, block, wc, grid))
    return (int)cudaErrorInvalidValue;
  const OpTile t{in_block, block, wc, grid, 0xffffffffu};
  const OpShape s = op_shape(op_case, n_ops, t);
  int per_sm = 0;
  const int err = e->occupancy(s, &per_sm);
  out[0] = s.form;
  out[1] = (long long)s.blocks_x * s.blocks_y;
  out[2] = s.threads;
  out[3] = s.smem;
  out[4] = per_sm;
  return err;
}

int op_chain_n_cases() { return OP_N_CASES; }

const char* op_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
