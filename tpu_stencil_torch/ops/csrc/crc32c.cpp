// CRC32C (Castagnoli, polynomial 0x1EDC6F41 reflected) of a host buffer.
//
// The stream engine checksums every frame twice (when the reader fills a
// staging slot, and again before the slot is copied to the card), 14.5 MB
// a frame at the reference size, so the checksum must run at memory speed
// and without the interpreter: the library has a plain C interface and is
// called through ctypes, which releases the GIL for the call.
//
// x86-64 with SSE4.2: the crc32 instruction, 8 bytes at a time, over three
// independent lanes (the instruction's latency is 3 cycles, its throughput
// 1 per cycle), joined by the GF(2) shift of each lane's CRC over the
// bytes that follow it. Elsewhere, or on an x86-64 without SSE4.2:
// slicing-by-8 tables. Both give the standard values
// (crc32c("123456789") == 0xE3069283).

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(_M_X64)
#include <nmmintrin.h>
#define CRC32C_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;  // 0x1EDC6F41 reflected

uint32_t g_table[8][256];
bool g_hw = false;
constexpr size_t kLane = 8192;  // bytes per lane of the SSE4.2 path
uint32_t g_shift_lane[32];      // the raw register shifted over kLane zeros
uint32_t g_shift_2lane[32];     // ... over 2 * kLane zeros

uint32_t shift_zeros(uint32_t crc, size_t nbytes);

void init_tables() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    g_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_table[0][i];
    for (int t = 1; t < 8; ++t) {
      c = g_table[0][c & 0xFF] ^ (c >> 8);
      g_table[t][i] = c;
    }
  }
#if CRC32C_X86
  g_hw = __builtin_cpu_supports("sse4.2");
#endif
  for (int j = 0; j < 32; ++j) {
    g_shift_lane[j] = shift_zeros(1u << j, kLane);
    g_shift_2lane[j] = shift_zeros(1u << j, 2 * kLane);
  }
}

// Raw (pre/post-inversion left to the caller) CRC of n bytes, slicing-by-8.
uint32_t crc_sw(uint32_t crc, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    --n;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    uint32_t lo = static_cast<uint32_t>(w) ^ crc;
    uint32_t hi = static_cast<uint32_t>(w >> 32);
    crc = g_table[7][lo & 0xFF] ^ g_table[6][(lo >> 8) & 0xFF] ^
          g_table[5][(lo >> 16) & 0xFF] ^ g_table[4][lo >> 24] ^
          g_table[3][hi & 0xFF] ^ g_table[2][(hi >> 8) & 0xFF] ^
          g_table[1][(hi >> 16) & 0xFF] ^ g_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

// The raw CRC register after feeding `nbytes` zero bytes to `crc`: the
// linear map x -> x * x^(8 nbytes) mod P, by square-and-multiply over the
// 32x32 GF(2) matrix of one zero bit.
void gf2_square(uint32_t* sq, const uint32_t* m) {
  for (int i = 0; i < 32; ++i) {
    uint32_t v = m[i], r = 0;
    for (int j = 0; v; ++j, v >>= 1)
      if (v & 1) r ^= m[j];
    sq[i] = r;
  }
}

uint32_t gf2_apply(const uint32_t* m, uint32_t v) {
  uint32_t r = 0;
  for (int j = 0; v; ++j, v >>= 1)
    if (v & 1) r ^= m[j];
  return r;
}

uint32_t shift_zeros(uint32_t crc, size_t nbytes) {
  uint32_t odd[32], even[32];
  odd[0] = kPoly;  // one zero bit
  for (int i = 1; i < 32; ++i) odd[i] = 1u << (i - 1);
  gf2_square(even, odd);  // two bits
  gf2_square(odd, even);  // four bits
  size_t n = nbytes;
  while (n) {
    gf2_square(even, odd);  // 1, 4, 16... bytes
    if (n & 1) crc = gf2_apply(even, crc);
    n >>= 1;
    if (!n) break;
    gf2_square(odd, even);
    if (n & 1) crc = gf2_apply(odd, crc);
    n >>= 1;
  }
  return crc;
}

#if CRC32C_X86
__attribute__((target("sse4.2")))
uint32_t crc_hw(uint32_t crc, const uint8_t* p, size_t n) {
  while (n && (reinterpret_cast<uintptr_t>(p) & 7)) {
    crc = _mm_crc32_u8(crc, *p++);
    --n;
  }
  // Three lanes of kLane bytes each, joined once per block.
  while (n >= 3 * kLane) {
    uint64_t c0 = crc, c1 = 0, c2 = 0;
    const uint8_t* p1 = p + kLane;
    const uint8_t* p2 = p + 2 * kLane;
    for (size_t i = 0; i < kLane; i += 8) {
      uint64_t w0, w1, w2;
      std::memcpy(&w0, p + i, 8);
      std::memcpy(&w1, p1 + i, 8);
      std::memcpy(&w2, p2 + i, 8);
      c0 = _mm_crc32_u64(c0, w0);
      c1 = _mm_crc32_u64(c1, w1);
      c2 = _mm_crc32_u64(c2, w2);
    }
    // crc(A B C) = shift(crc(A), |B C|) ^ shift(crc0(B), |C|) ^ crc0(C),
    // where crc0 starts from a zero register.
    crc = gf2_apply(g_shift_2lane, static_cast<uint32_t>(c0)) ^
          gf2_apply(g_shift_lane, static_cast<uint32_t>(c1)) ^
          static_cast<uint32_t>(c2);
    p += 3 * kLane;
    n -= 3 * kLane;
  }
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    n -= 8;
  }
  crc = static_cast<uint32_t>(c);
  while (n--) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}
#endif

// Tables and the CPU check are made once, when the library is loaded.
struct Init {
  Init() { init_tables(); }
} g_init;

}  // namespace

extern "C" {

// CRC32C of `n` bytes at `data`, extending the running value `value`
// (0 for a fresh checksum), as zlib-style crc32 extends.
uint32_t crc32c_extend(uint32_t value, const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint32_t crc = ~value;
#if CRC32C_X86
  if (g_hw) return ~crc_hw(crc, p, n);
#endif
  return ~crc_sw(crc, p, n);
}

// The slicing-by-8 path alone, whatever the CPU (tests hold it against the
// SSE4.2 path).
uint32_t crc32c_extend_portable(uint32_t value, const void* data, size_t n) {
  return ~crc_sw(~value, static_cast<const uint8_t*>(data), n);
}

// 1 when the SSE4.2 path runs, 0 for slicing-by-8.
int crc32c_hardware() {
  return g_hw ? 1 : 0;
}

}  // extern "C"
