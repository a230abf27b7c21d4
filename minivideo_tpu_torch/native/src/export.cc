// Native picture export: YUV420->RGB conversion + JPEG/PNG/BMP/TGA
// encoders, C-speed like the reference's writers (export.c:341-615 uses
// libjpeg/libpng/stb_image_write; export_utils.c:209-326 does the
// integer BT.601 conversion).  This file is an original implementation:
// a baseline-JPEG encoder (AAN scaled DCT, Annex K.1-K.3 standard
// tables), a PNG writer over system zlib with per-row sub filtering,
// and trivial BMP/TGA writers.  All encoders write into caller-provided
// buffers and return the byte count (negative on error); file I/O stays
// in Python (export/image.py), which also keeps pure-Python fallbacks
// as the correctness oracle (tests/test_native_export.py pins parity).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// YCbCr 4:2:0 -> RGB888, integer BT.601 studio swing.  Same arithmetic
// as export/image.py yuv420_to_rgb and the reference mb_to_rgb
// (export_utils.c:297-304: 298/409/100/208/516 >> 8).

inline uint8_t clamp_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

#ifdef __AVX2__
// int32x16 (two 8-lane vectors) -> u8x16, saturating; AVX2 packs work
// per 128-bit lane, so a 64-bit permute reorders after each pack
static inline __m128i pack_u8x16(__m256i lo, __m256i hi) {
  __m256i w16 = _mm256_permute4x64_epi64(_mm256_packs_epi32(lo, hi),
                                         0xD8);
  __m256i b = _mm256_permute4x64_epi64(
      _mm256_packus_epi16(w16, _mm256_setzero_si256()), 0xD8);
  return _mm256_castsi256_si128(b);
}

// planar R/G/B u8x16 -> 48 interleaved RGB bytes (3 shuffles per
// 16-byte output chunk, OR-combined)
static inline void interleave_rgb16(__m128i R, __m128i G, __m128i B,
                                    uint8_t* o) {
  static const int8_t M[3][3][16] = {
      // chunk 0: R0 G0 B0 R1 G1 B1 ... R5 G5
      {{0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1, -1, 5},
       {-1, 0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1, -1},
       {-1, -1, 0, -1, -1, 1, -1, -1, 2, -1, -1, 3, -1, -1, 4, -1}},
      // chunk 1: G5 B5 R6 ... B10
      {{-1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1, 10, -1},
       {5, -1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1, 10},
       {-1, 5, -1, -1, 6, -1, -1, 7, -1, -1, 8, -1, -1, 9, -1, -1}},
      // chunk 2: R11 G11 B11 ... R15 G15 B15
      {{-1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15, -1, -1},
       {-1, -1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15, -1},
       {10, -1, -1, 11, -1, -1, 12, -1, -1, 13, -1, -1, 14, -1, -1, 15}}};
  for (int k = 0; k < 3; k++) {
    __m128i v = _mm_or_si128(
        _mm_or_si128(
            _mm_shuffle_epi8(R, _mm_loadu_si128((const __m128i*)M[k][0])),
            _mm_shuffle_epi8(G, _mm_loadu_si128((const __m128i*)M[k][1]))),
        _mm_shuffle_epi8(B, _mm_loadu_si128((const __m128i*)M[k][2])));
    _mm_storeu_si128((__m128i*)(o + 16 * k), v);
  }
}

// one output row, width-expanded chroma rows, 16 pixels per iteration
static void yuv_row_rgb_avx(const uint8_t* yr, const uint8_t* cbx,
                            const uint8_t* crx, int w16, uint8_t* o) {
  const __m256i k16 = _mm256_set1_epi32(16);
  const __m256i k128i = _mm256_set1_epi32(128);
  const __m256i c298 = _mm256_set1_epi32(298);
  const __m256i c409 = _mm256_set1_epi32(409);
  const __m256i c100 = _mm256_set1_epi32(100);
  const __m256i c208 = _mm256_set1_epi32(208);
  const __m256i c516 = _mm256_set1_epi32(516);
  for (int x = 0; x < w16; x += 16) {
    __m256i R[2], G[2], B[2];
    for (int half = 0; half < 2; half++) {
      __m128i y8 = _mm_loadl_epi64((const __m128i*)(yr + x + 8 * half));
      __m128i d8 = _mm_loadl_epi64((const __m128i*)(cbx + x + 8 * half));
      __m128i e8 = _mm_loadl_epi64((const __m128i*)(crx + x + 8 * half));
      __m256i c = _mm256_sub_epi32(_mm256_cvtepu8_epi32(y8), k16);
      __m256i d = _mm256_sub_epi32(_mm256_cvtepu8_epi32(d8), k128i);
      __m256i e = _mm256_sub_epi32(_mm256_cvtepu8_epi32(e8), k128i);
      __m256i base = _mm256_add_epi32(_mm256_mullo_epi32(c, c298), k128i);
      R[half] = _mm256_srai_epi32(
          _mm256_add_epi32(base, _mm256_mullo_epi32(e, c409)), 8);
      G[half] = _mm256_srai_epi32(
          _mm256_sub_epi32(
              _mm256_sub_epi32(base, _mm256_mullo_epi32(d, c100)),
              _mm256_mullo_epi32(e, c208)), 8);
      B[half] = _mm256_srai_epi32(
          _mm256_add_epi32(base, _mm256_mullo_epi32(d, c516)), 8);
    }
    interleave_rgb16(pack_u8x16(R[0], R[1]), pack_u8x16(G[0], G[1]),
                     pack_u8x16(B[0], B[1]), o + 3 * x);
  }
}
#endif  // __AVX2__

void yuv420_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                   int h, int w, int ch, int cw, uint8_t* out) {
  if (h <= 0 || w <= 0 || ch <= 0 || cw <= 0) return;
#ifdef __AVX2__
  // width-expanded chroma rows (each sample duplicated 2x) let the
  // pixel loop read chroma linearly; +2 pad so 8-byte loads at the
  // last 16-pixel group stay in bounds
  std::vector<uint8_t> cbx((size_t)w + 18), crx((size_t)w + 18);
#endif
  for (int r = 0; r < h; r++) {
    int cr_row = r >> 1;
    if (cr_row >= ch) cr_row = ch - 1;
    const uint8_t* yr = y + (int64_t)r * w;
    const uint8_t* cbr = cb + (int64_t)cr_row * cw;
    const uint8_t* crr = cr + (int64_t)cr_row * cw;
    uint8_t* o = out + (int64_t)r * w * 3;
    int x0 = 0;
#ifdef __AVX2__
    int w16 = w & ~15;
    if (w16 >= 16 && cw * 2 >= w16) {
      if ((r & 1) == 0 || r == 0) {          // expand once per chroma row
        for (int i = 0; i < (w16 + 1) / 2; i++) {
          cbx[2 * i] = cbx[2 * i + 1] = cbr[i];
          crx[2 * i] = crx[2 * i + 1] = crr[i];
        }
      }
      yuv_row_rgb_avx(yr, cbx.data(), crx.data(), w16, o);
      x0 = w16;
    }
#endif
    for (int x = x0; x < w; x++) {
      int cx = x >> 1;
      if (cx >= cw) cx = cw - 1;
      int c = (int)yr[x] - 16;
      int d = (int)cbr[cx] - 128;
      int e = (int)crr[cx] - 128;
      int base = 298 * c + 128;
      o[3 * x + 0] = clamp_u8((base + 409 * e) >> 8);
      o[3 * x + 1] = clamp_u8((base - 100 * d - 208 * e) >> 8);
      o[3 * x + 2] = clamp_u8((base + 516 * d) >> 8);
    }
  }
}

// ---------------------------------------------------------------------------
// bit sink with JPEG 0xFF byte stuffing

struct BitSink {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;          // low `nbits` bits valid; older bits above
  //                            are already-flushed garbage (harmless:
  //                            extraction windows on [nbits-32, nbits))
  int nbits = 0;
  bool err = false;

  inline void put(uint32_t code, int len) {      // len <= 24
    acc = (acc << len) | (code & ((1u << len) - 1u));
    nbits += len;
    if (nbits >= 32) emit32();
  }
  void emit32() {
    uint32_t b = (uint32_t)(acc >> (nbits - 32));
    if (n + 8 > cap) { err = true; nbits = 0; return; }
    uint32_t t = b ^ 0xFFFFFFFFu;
    if (((t - 0x01010101u) & ~t & 0x80808080u) == 0) {
      // common case: no 0xFF byte in the word — one bswap store
      uint32_t be = __builtin_bswap32(b);
      std::memcpy(out + n, &be, 4);
      n += 4;
    } else {
      for (int i = 3; i >= 0; i--) {
        uint8_t byte = (uint8_t)(b >> (8 * i));
        out[n++] = byte;
        if (byte == 0xFF) out[n++] = 0;          // stuffing
      }
    }
    nbits -= 32;
  }
  void flush() {
    if (nbits & 7) {
      int pad = 8 - (nbits & 7);
      acc = (acc << pad) | ((1u << pad) - 1u);   // 1-fill padding
      nbits += pad;
    }
    while (nbits >= 8) {
      uint8_t byte = (uint8_t)(acc >> (nbits - 8));
      if (n + 2 > cap) { err = true; nbits = 0; return; }
      out[n++] = byte;
      if (byte == 0xFF) out[n++] = 0;
      nbits -= 8;
    }
  }
  void bytes(const uint8_t* p, int64_t len) {    // raw (header) bytes
    if (n + len > cap) { err = true; return; }
    std::memcpy(out + n, p, len);
    n += len;
  }
};

// ---------------------------------------------------------------------------
// baseline JPEG encoder, 4:2:0 straight from decoded planes.
// Tables: ITU-T T.81 Annex K.1 (quant) / K.3 (Huffman) — the
// spec-recommended constants every baseline encoder ships (the same
// ones export/image.py embeds; provenance: standard, not copied code).

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kQY[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kQC[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0,
                                 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4,
                                 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
    0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4,
                                   4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
    0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    std::memset(len, 0, sizeof(len));
    uint32_t c = 0;
    int k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++) {
        code[vals[k]] = (uint16_t)c;
        len[vals[k]] = (uint8_t)l;
        c++;
        k++;
      }
      c <<= 1;
    }
    (void)nvals;
  }
};

struct JpegTabs {
  HuffTable dc_y, ac_y, dc_c, ac_c;
  JpegTabs() {
    dc_y.build(kDcLumaBits, kDcLumaVals, 12);
    ac_y.build(kAcLumaBits, kAcLumaVals, 162);
    dc_c.build(kDcChromaBits, kDcChromaVals, 12);
    ac_c.build(kAcChromaBits, kAcChromaVals, 162);
  }
};

const JpegTabs& jpeg_tabs() {
  static const JpegTabs T;
  return T;
}

#ifdef __AVX2__
// 8x8 float transpose, the classic AVX unpack/shuffle/permute ladder
static inline void transpose8(__m256 r[8]) {
  __m256 t0 = _mm256_unpacklo_ps(r[0], r[1]);
  __m256 t1 = _mm256_unpackhi_ps(r[0], r[1]);
  __m256 t2 = _mm256_unpacklo_ps(r[2], r[3]);
  __m256 t3 = _mm256_unpackhi_ps(r[2], r[3]);
  __m256 t4 = _mm256_unpacklo_ps(r[4], r[5]);
  __m256 t5 = _mm256_unpackhi_ps(r[4], r[5]);
  __m256 t6 = _mm256_unpacklo_ps(r[6], r[7]);
  __m256 t7 = _mm256_unpackhi_ps(r[6], r[7]);
  __m256 s0 = _mm256_shuffle_ps(t0, t2, 0x44);
  __m256 s1 = _mm256_shuffle_ps(t0, t2, 0xEE);
  __m256 s2 = _mm256_shuffle_ps(t1, t3, 0x44);
  __m256 s3 = _mm256_shuffle_ps(t1, t3, 0xEE);
  __m256 s4 = _mm256_shuffle_ps(t4, t6, 0x44);
  __m256 s5 = _mm256_shuffle_ps(t4, t6, 0xEE);
  __m256 s6 = _mm256_shuffle_ps(t5, t7, 0x44);
  __m256 s7 = _mm256_shuffle_ps(t5, t7, 0xEE);
  r[0] = _mm256_permute2f128_ps(s0, s4, 0x20);
  r[1] = _mm256_permute2f128_ps(s1, s5, 0x20);
  r[2] = _mm256_permute2f128_ps(s2, s6, 0x20);
  r[3] = _mm256_permute2f128_ps(s3, s7, 0x20);
  r[4] = _mm256_permute2f128_ps(s0, s4, 0x31);
  r[5] = _mm256_permute2f128_ps(s1, s5, 0x31);
  r[6] = _mm256_permute2f128_ps(s2, s6, 0x31);
  r[7] = _mm256_permute2f128_ps(s3, s7, 0x31);
}

// one AAN butterfly pass over 8 row vectors (i.e. the column DCT:
// every vector lane is an independent 1-D 8-point DCT)
static inline void aan_pass(__m256 r[8]) {
  __m256 t0 = _mm256_add_ps(r[0], r[7]), t7 = _mm256_sub_ps(r[0], r[7]);
  __m256 t1 = _mm256_add_ps(r[1], r[6]), t6 = _mm256_sub_ps(r[1], r[6]);
  __m256 t2 = _mm256_add_ps(r[2], r[5]), t5 = _mm256_sub_ps(r[2], r[5]);
  __m256 t3 = _mm256_add_ps(r[3], r[4]), t4 = _mm256_sub_ps(r[3], r[4]);
  __m256 t10 = _mm256_add_ps(t0, t3), t13 = _mm256_sub_ps(t0, t3);
  __m256 t11 = _mm256_add_ps(t1, t2), t12 = _mm256_sub_ps(t1, t2);
  r[0] = _mm256_add_ps(t10, t11);
  r[4] = _mm256_sub_ps(t10, t11);
  const __m256 c707 = _mm256_set1_ps(0.707106781f);
  const __m256 c382 = _mm256_set1_ps(0.382683433f);
  const __m256 c541 = _mm256_set1_ps(0.541196100f);
  const __m256 c130 = _mm256_set1_ps(1.306562965f);
  __m256 z1 = _mm256_mul_ps(_mm256_add_ps(t12, t13), c707);
  r[2] = _mm256_add_ps(t13, z1);
  r[6] = _mm256_sub_ps(t13, z1);
  t10 = _mm256_add_ps(t4, t5);
  t11 = _mm256_add_ps(t5, t6);
  t12 = _mm256_add_ps(t6, t7);
  __m256 z5 = _mm256_mul_ps(_mm256_sub_ps(t10, t12), c382);
  __m256 z2 = _mm256_add_ps(_mm256_mul_ps(t10, c541), z5);
  __m256 z4 = _mm256_add_ps(_mm256_mul_ps(t12, c130), z5);
  __m256 z3 = _mm256_mul_ps(t11, c707);
  __m256 z11 = _mm256_add_ps(t7, z3), z13 = _mm256_sub_ps(t7, z3);
  r[5] = _mm256_add_ps(z13, z2);
  r[3] = _mm256_sub_ps(z13, z2);
  r[1] = _mm256_add_ps(z11, z4);
  r[7] = _mm256_sub_ps(z11, z4);
}

// DCT + quantize in one vector pass; writes NATURAL-order int32 coeffs
static inline void fdct_quant_avx(const float* b, const float* fd,
                                  int32_t* q) {
  __m256 r[8];
  for (int i = 0; i < 8; i++) r[i] = _mm256_loadu_ps(b + 8 * i);
  aan_pass(r);                 // columns
  transpose8(r);
  aan_pass(r);                 // rows (on transposed data)
  transpose8(r);               // back to natural orientation
  for (int i = 0; i < 8; i++) {
    __m256 v = _mm256_mul_ps(r[i], _mm256_loadu_ps(fd + 8 * i));
    _mm256_storeu_si256((__m256i*)(q + 8 * i),
                        _mm256_cvtps_epi32(v));   // round-to-nearest
  }
}
#endif  // __AVX2__

// AAN scaled forward 8x8 DCT (5 mults per 1-D pass; descaling folded
// into the quantization table, the classic fast-JPEG formulation).
// Scalar fallback for non-AVX2 builds; the AVX2 path above runs the
// same butterflies 8 lanes wide.
[[maybe_unused]] void fdct8x8(float* b) {
  for (int pass = 0; pass < 2; pass++) {
    // rows on pass 0, columns on pass 1 (stride flips)
    int rs = pass == 0 ? 8 : 1, cs = pass == 0 ? 1 : 8;
    for (int i = 0; i < 8; i++) {
      float* d = b + i * rs;
      float d0 = d[0 * cs], d1 = d[1 * cs], d2 = d[2 * cs], d3 = d[3 * cs];
      float d4 = d[4 * cs], d5 = d[5 * cs], d6 = d[6 * cs], d7 = d[7 * cs];
      float t0 = d0 + d7, t7 = d0 - d7;
      float t1 = d1 + d6, t6 = d1 - d6;
      float t2 = d2 + d5, t5 = d2 - d5;
      float t3 = d3 + d4, t4 = d3 - d4;
      float t10 = t0 + t3, t13 = t0 - t3;
      float t11 = t1 + t2, t12 = t1 - t2;
      d[0 * cs] = t10 + t11;
      d[4 * cs] = t10 - t11;
      float z1 = (t12 + t13) * 0.707106781f;
      d[2 * cs] = t13 + z1;
      d[6 * cs] = t13 - z1;
      t10 = t4 + t5;
      t11 = t5 + t6;
      t12 = t6 + t7;
      float z5 = (t10 - t12) * 0.382683433f;
      float z2 = t10 * 0.541196100f + z5;
      float z4 = t12 * 1.306562965f + z5;
      float z3 = t11 * 0.707106781f;
      float z11 = t7 + z3, z13 = t7 - z3;
      d[5 * cs] = z13 + z2;
      d[3 * cs] = z13 - z2;
      d[1 * cs] = z11 + z4;
      d[7 * cs] = z11 - z4;
    }
  }
}

inline void put_coef(BitSink& s, const HuffTable& t, int v, int run) {
  int a = v < 0 ? -v : v;
  int size = a ? 32 - __builtin_clz((unsigned)a) : 0;
  int sym = run < 0 ? size : ((run << 4) | size);
  s.put(t.code[sym], t.len[sym]);
  if (size) {
    if (v < 0) v += (1 << size) - 1;
    s.put((uint32_t)v & ((1u << size) - 1u), size);
  }
}

// one 8x8 block: DCT + quantize + Huffman; returns new DC predictor
int encode_block(BitSink& s, float* blk, const float* fd,
                 const HuffTable& dc, const HuffTable& ac, int pred) {
  int32_t qn[64];
#ifdef __AVX2__
  fdct_quant_avx(blk, fd, qn);   // vector DCT + quant (same rounding:
  //                                cvtps round-to-nearest-even = lrintf)
#else
  fdct8x8(blk);
  for (int i = 0; i < 64; i++) qn[i] = (int32_t)lrintf(blk[i] * fd[i]);
#endif
  int zz[64];
  int last = 0;
  for (int i = 0; i < 64; i++) {
    int v = qn[kZigzag[i]];
    zz[i] = v;
    if (v) last = i;
  }
  put_coef(s, dc, zz[0] - pred, -1);
  int run = 0;
  for (int i = 1; i <= last; i++) {
    if (zz[i] == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      s.put(ac.code[0xF0], ac.len[0xF0]);      // ZRL
      run -= 16;
    }
    put_coef(s, ac, zz[i], run);
    run = 0;
  }
  if (last < 63) s.put(ac.code[0x00], ac.len[0x00]);  // EOB
  return zz[0];
}

// clamped plane fetch (edge replication for partial MCUs)
inline void load_block(const uint8_t* p, int h, int w, int y0, int x0,
                       float* blk) {
#ifdef __AVX2__
  if (y0 + 8 <= h && x0 + 8 <= w) {      // interior: no clamping
    const __m256 off = _mm256_set1_ps(128.0f);
    for (int r = 0; r < 8; r++) {
      __m128i b8 = _mm_loadl_epi64(
          (const __m128i*)(p + (int64_t)(y0 + r) * w + x0));
      __m256 v = _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(b8));
      _mm256_storeu_ps(blk + r * 8, _mm256_sub_ps(v, off));
    }
    return;
  }
#endif
  for (int r = 0; r < 8; r++) {
    int yy = y0 + r;
    if (yy >= h) yy = h - 1;
    const uint8_t* row = p + (int64_t)yy * w;
    for (int c = 0; c < 8; c++) {
      int xx = x0 + c;
      if (xx >= w) xx = w - 1;
      blk[r * 8 + c] = (float)row[xx] - 128.0f;
    }
  }
}

int64_t encode_jpeg(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                    int h, int w, int ch, int cw, int quality,
                    uint8_t* out, int64_t cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || ch <= 0 || cw <= 0)
    return -1;
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  int qy[64], qc[64];
  float fdy[64], fdc[64];
  static const float aan[8] = {1.0f, 1.387039845f, 1.306562965f,
                               1.175875602f, 1.0f, 0.785694958f,
                               0.541196100f, 0.275899379f};
  for (int i = 0; i < 64; i++) {
    qy[i] = (kQY[i] * scale + 50) / 100;
    qc[i] = (kQC[i] * scale + 50) / 100;
    qy[i] = qy[i] < 1 ? 1 : (qy[i] > 255 ? 255 : qy[i]);
    qc[i] = qc[i] < 1 ? 1 : (qc[i] > 255 ? 255 : qc[i]);
    int r = i >> 3, c = i & 7;
    fdy[i] = 1.0f / (qy[i] * aan[r] * aan[c] * 8.0f);
    fdc[i] = 1.0f / (qc[i] * aan[r] * aan[c] * 8.0f);
  }

  BitSink s{out, cap};
  uint8_t hdr[700];
  int n = 0;
  auto b2 = [&](int v) {
    hdr[n++] = (uint8_t)(v >> 8);
    hdr[n++] = (uint8_t)v;
  };
  hdr[n++] = 0xFF; hdr[n++] = 0xD8;                       // SOI
  for (int t = 0; t < 2; t++) {                           // DQT x2
    hdr[n++] = 0xFF; hdr[n++] = 0xDB;
    b2(67);
    hdr[n++] = (uint8_t)t;
    const int* q = t ? qc : qy;
    for (int i = 0; i < 64; i++) hdr[n++] = (uint8_t)q[kZigzag[i]];
  }
  hdr[n++] = 0xFF; hdr[n++] = 0xC0;                       // SOF0
  b2(17);
  hdr[n++] = 8;
  b2(h); b2(w);
  hdr[n++] = 3;
  hdr[n++] = 1; hdr[n++] = 0x22; hdr[n++] = 0;            // Y 2x2 Q0
  hdr[n++] = 2; hdr[n++] = 0x11; hdr[n++] = 1;            // Cb 1x1 Q1
  hdr[n++] = 3; hdr[n++] = 0x11; hdr[n++] = 1;            // Cr
  struct { uint8_t cls; const uint8_t* bits; const uint8_t* vals; int nv; }
  hts[4] = {{0x00, kDcLumaBits, kDcLumaVals, 12},
            {0x01, kDcChromaBits, kDcChromaVals, 12},
            {0x10, kAcLumaBits, kAcLumaVals, 162},
            {0x11, kAcChromaBits, kAcChromaVals, 162}};
  for (auto& t : hts) {                                   // DHT x4
    hdr[n++] = 0xFF; hdr[n++] = 0xC4;
    b2(19 + t.nv);
    hdr[n++] = t.cls;
    for (int l = 1; l <= 16; l++) hdr[n++] = t.bits[l];
    for (int i = 0; i < t.nv; i++) hdr[n++] = t.vals[i];
  }
  hdr[n++] = 0xFF; hdr[n++] = 0xDA;                       // SOS
  b2(12);
  hdr[n++] = 3;
  hdr[n++] = 1; hdr[n++] = 0x00;
  hdr[n++] = 2; hdr[n++] = 0x11;
  hdr[n++] = 3; hdr[n++] = 0x11;
  hdr[n++] = 0; hdr[n++] = 63; hdr[n++] = 0;
  s.bytes(hdr, n);

  const JpegTabs& T = jpeg_tabs();
  int py = 0, pcb = 0, pcr = 0;
  float blk[64];
  for (int my = 0; my < h; my += 16) {
    for (int mx = 0; mx < w; mx += 16) {
      for (int sub = 0; sub < 4; sub++) {
        int dy = (sub >> 1) * 8, dx = (sub & 1) * 8;
        load_block(y, h, w, my + dy, mx + dx, blk);
        py = encode_block(s, blk, fdy, T.dc_y, T.ac_y, py);
      }
      load_block(cb, ch, cw, my / 2, mx / 2, blk);
      pcb = encode_block(s, blk, fdc, T.dc_c, T.ac_c, pcb);
      load_block(cr, ch, cw, my / 2, mx / 2, blk);
      pcr = encode_block(s, blk, fdc, T.dc_c, T.ac_c, pcr);
      if (s.err) return -2;
    }
  }
  s.flush();
  if (s.n + 2 > cap) return -2;
  out[s.n++] = 0xFF;
  out[s.n++] = 0xD9;                                      // EOI
  return s.err ? -2 : s.n;
}

// ---------------------------------------------------------------------------
// PNG (RGB8), zlib deflate over per-row "sub" filtering.  Sub (type 1)
// is the cheap one-pass filter that captures most of the horizontal
// gradient redundancy in natural images; stb's per-row MSAD selection
// buys a few % ratio for ~2x filter cost — not worth it at the
// compression levels export uses (measured in tests/test_native_export).

void be32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

int64_t png_chunk(uint8_t* out, const char* tag, const uint8_t* payload,
                  int64_t len) {
  be32(out, (uint32_t)len);
  std::memcpy(out + 4, tag, 4);
  if (len) std::memcpy(out + 8, payload, len);
  uint32_t crc = crc32(0, out + 4, (uInt)(4 + len));
  be32(out + 8 + len, crc);
  return 12 + len;
}

// One worker: sub-filter its rows then raw-deflate them.  Non-last
// bands end with Z_FULL_FLUSH (byte-aligned empty stored block, no
// BFINAL), the last with Z_FINISH — so the concatenation of the bands'
// output is ONE valid deflate stream (the pigz construction).  Each
// band also returns the adler32 of its filtered bytes; the zlib
// trailer is their adler32_combine.  run() throws nothing: a failed
// allocation in a band's thread sets `err`, and encode_png returns its
// error code, where an exception leaving the thread would end the
// process (a difference by design from the JAX package's copy).
struct PngBand {
  const uint8_t* rgb;
  int w, r0, r1;
  int level, last;
  std::vector<uint8_t> z;
  uint32_t adler = 0;
  int64_t filt_len = 0;
  bool err = false;

  void run() noexcept {
    try {
      encode();
    } catch (...) {                              // std::bad_alloc
      err = true;
    }
  }

  void encode() {
    int64_t stride = (int64_t)w * 3;
    filt_len = (int64_t)(r1 - r0) * (stride + 1);
    std::vector<uint8_t> filt((size_t)filt_len);
    for (int r = r0; r < r1; r++) {
      const uint8_t* src = rgb + (int64_t)r * stride;
      uint8_t* dst = filt.data() + (int64_t)(r - r0) * (stride + 1);
      dst[0] = 1;                                // sub filter
      dst[1] = src[0];
      dst[2] = src[1];
      dst[3] = src[2];
      for (int64_t i = 3; i < stride; i++)
        dst[1 + i] = (uint8_t)(src[i] - src[i - 3]);
    }
    adler = (uint32_t)adler32(adler32(0, nullptr, 0), filt.data(),
                              (uInt)filt_len);
    // deflateEnd runs however this scope is left
    struct Deflater {
      z_stream zs;
      bool live = false;
      ~Deflater() {
        if (live) deflateEnd(&zs);
      }
    } d;
    z_stream& zs = d.zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK) {
      err = true;
      return;
    }
    d.live = true;
    z.resize((size_t)deflateBound(&zs, (uLong)filt_len) + 16);
    zs.next_in = filt.data();
    zs.avail_in = (uInt)filt_len;
    zs.next_out = z.data();
    zs.avail_out = (uInt)z.size();
    int rc = deflate(&zs, last ? Z_FINISH : Z_FULL_FLUSH);
    if (last ? rc != Z_STREAM_END : rc != Z_OK) err = true;
    z.resize(zs.total_out);
  }
};

int64_t encode_png(const uint8_t* rgb, int h, int w, int level,
                   int threads, uint8_t* out, int64_t cap) {
  if (h <= 0 || w <= 0) return -1;
  if ((int64_t)h * (3 * (int64_t)w + 1) >= (int64_t)UINT32_MAX)
    return -1;                                   // zlib uInt band limit
  if (level < 0) level = 3;
  int hw = (int)std::thread::hardware_concurrency();
  if (threads <= 0) threads = hw > 0 ? hw : 1;
  // ≥64 rows per band: tiny bands cost ratio (no cross-band history)
  int max_bands = h / 64 > 0 ? h / 64 : 1;
  int nb = threads < max_bands ? threads : max_bands;
  std::vector<PngBand> bands((size_t)nb);
  for (int i = 0; i < nb; i++) {
    bands[i].rgb = rgb;
    bands[i].w = w;
    bands[i].r0 = (int)((int64_t)h * i / nb);
    bands[i].r1 = (int)((int64_t)h * (i + 1) / nb);
    bands[i].level = level;
    bands[i].last = i == nb - 1;
  }
  std::vector<std::thread> ts;
  ts.reserve((size_t)nb);
  for (int i = 1; i < nb; i++) {
    try {
      ts.emplace_back([&bands, i] { bands[i].run(); });
    } catch (...) {               // no thread to be had: run it here
      bands[i].run();
    }
  }
  bands[0].run();
  for (auto& t : ts) t.join();

  int64_t zlen = 2;                              // zlib header
  uint32_t adler = (uint32_t)adler32(0, nullptr, 0);
  for (auto& b : bands) {
    if (b.err) return -2;
    zlen += (int64_t)b.z.size();
    adler = (uint32_t)adler32_combine(adler, b.adler, (z_off_t)b.filt_len);
  }
  zlen += 4;                                     // adler trailer
  int64_t need = 8 + 25 + zlen + 12 + 12;
  if (need > cap) return -2;

  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                 '\n'};
  std::memcpy(out, sig, 8);
  int64_t n = 8;
  uint8_t ihdr[13];
  be32(ihdr, (uint32_t)w);
  be32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  n += png_chunk(out + n, "IHDR", ihdr, 13);
  // IDAT assembled in place: length + tag + zlib stream + crc
  uint8_t* idat = out + n;
  be32(idat, (uint32_t)zlen);
  std::memcpy(idat + 4, "IDAT", 4);
  uint8_t* p = idat + 8;
  *p++ = 0x78;                                   // CMF: deflate, 32K win
  *p++ = 0x01;                                   // FLG: checks out mod 31
  for (auto& b : bands) {
    std::memcpy(p, b.z.data(), b.z.size());
    p += b.z.size();
  }
  be32(p, adler);
  p += 4;
  uint32_t crc = crc32(0, idat + 4, (uInt)(4 + zlen));
  be32(p, crc);
  n += 12 + zlen;
  n += png_chunk(out + n, "IEND", nullptr, 0);
  return n;
}

// ---------------------------------------------------------------------------
// BMP (bottom-up BGR, row-padded) and TGA (top-down BGR)

int64_t encode_bmp(const uint8_t* rgb, int h, int w, uint8_t* out,
                   int64_t cap) {
  if (h <= 0 || w <= 0) return -1;
  int64_t row = (int64_t)w * 3;
  int64_t pad = (4 - row % 4) % 4;
  int64_t img = (row + pad) * h;
  int64_t total = 54 + img;
  if (total > cap || total > (int64_t)UINT32_MAX) return -2;
  std::memset(out, 0, 54);
  out[0] = 'B'; out[1] = 'M';
  auto le32 = [&](int64_t off, uint32_t v) {
    out[off] = (uint8_t)v; out[off + 1] = (uint8_t)(v >> 8);
    out[off + 2] = (uint8_t)(v >> 16); out[off + 3] = (uint8_t)(v >> 24);
  };
  le32(2, (uint32_t)total);
  le32(10, 54);
  le32(14, 40);
  le32(18, (uint32_t)w);
  le32(22, (uint32_t)h);
  out[26] = 1;
  out[28] = 24;
  le32(34, (uint32_t)img);
  le32(38, 2835);
  le32(42, 2835);
  uint8_t* p = out + 54;
  for (int r = h - 1; r >= 0; r--) {
    const uint8_t* src = rgb + (int64_t)r * row;
    for (int64_t i = 0; i < row; i += 3) {
      *p++ = src[i + 2];
      *p++ = src[i + 1];
      *p++ = src[i];
    }
    for (int64_t i = 0; i < pad; i++) *p++ = 0;
  }
  return total;
}

int64_t encode_tga(const uint8_t* rgb, int h, int w, uint8_t* out,
                   int64_t cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535) return -1;
  int64_t total = 18 + (int64_t)h * w * 3;
  if (total > cap) return -2;
  std::memset(out, 0, 18);
  out[2] = 2;                                    // uncompressed truecolor
  out[12] = (uint8_t)w; out[13] = (uint8_t)(w >> 8);
  out[14] = (uint8_t)h; out[15] = (uint8_t)(h >> 8);
  out[16] = 24;
  out[17] = 0x20;                                // top-down
  uint8_t* p = out + 18;
  const uint8_t* src = rgb;
  for (int64_t i = 0; i < (int64_t)h * w; i++, src += 3) {
    *p++ = src[2];
    *p++ = src[1];
    *p++ = src[0];
  }
  return total;
}

}  // namespace

extern "C" {

void mv_yuv420_to_rgb(const uint8_t* y, const uint8_t* cb,
                      const uint8_t* cr, int32_t h, int32_t w,
                      int32_t ch, int32_t cw, uint8_t* out) {
  yuv420_to_rgb(y, cb, cr, h, w, ch, cw, out);
}

int64_t mv_encode_jpeg(const uint8_t* y, const uint8_t* cb,
                       const uint8_t* cr, int32_t h, int32_t w,
                       int32_t ch, int32_t cw, int32_t quality,
                       uint8_t* out, int64_t cap) {
  return encode_jpeg(y, cb, cr, h, w, ch, cw, quality, out, cap);
}

int64_t mv_encode_png(const uint8_t* rgb, int32_t h, int32_t w,
                      int32_t level, int32_t threads, uint8_t* out,
                      int64_t cap) {
  try {
    return encode_png(rgb, h, w, level, threads, out, cap);
  } catch (...) {                 // the bands' table: no memory
    return -3;
  }
}

int64_t mv_encode_bmp(const uint8_t* rgb, int32_t h, int32_t w,
                      uint8_t* out, int64_t cap) {
  return encode_bmp(rgb, h, w, out, cap);
}

int64_t mv_encode_tga(const uint8_t* rgb, int32_t h, int32_t w,
                      uint8_t* out, int64_t cap) {
  return encode_tga(rgb, h, w, out, cap);
}

}  // extern "C"
