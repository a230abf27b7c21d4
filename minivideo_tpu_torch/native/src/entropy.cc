// Native H.264 I-slice entropy decoder (CAVLC + CABAC).
//
// TPU-native equivalent of the reference's C hot path (SURVEY.md §3.3:
// CABAC bin decoding and CAVLC table decoding are the top host costs).
// This is a line-for-line port of the *Python* implementation in
// minivideo_tpu/models/h264/{syntax,cavlc,cabac}.py (not of the reference
// C code); parity with the Python parser is enforced by
// tests/test_entropy_parity.py on fuzzed streams.
//
// The C ABI writes directly into caller-provided numpy buffers laid out
// exactly like FrameSyntax (see bindings in minivideo_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include "h264_tables.h"

namespace {

// ---------------------------------------------------------------------------
// bit reader (MSB-first)

struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos;
  bool error = false;

  inline int read_bit() {
    if (pos >= nbits) { error = true; return 0; }
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  // next n (<= 24) bits MSB-first, zero-padded past EOF; no advance
  inline uint32_t peek_bits(int n) const {
    int64_t byte = pos >> 3;
    int sh = (int)(pos & 7);
    int64_t nbytes = (nbits + 7) >> 3;
    uint32_t v;
    if (byte + 4 <= nbytes) {            // fast path: one unaligned load
      std::memcpy(&v, data + byte, 4);
      v = __builtin_bswap32(v);
    } else {
      v = 0;
      for (int i = 0; i < 4; i++)
        v = (v << 8) | (byte + i < nbytes ? data[byte + i] : 0);
    }
    return (v >> (32 - sh - n)) & ((n == 32 ? 0u : (1u << n)) - 1u);
  }
  // 32-bit aligned-window peek for the CABAC refill (zero-padded)
  inline uint32_t peek_bits32() const {
    int64_t byte = pos >> 3;
    int sh = (int)(pos & 7);
    int64_t nbytes = (nbits + 7) >> 3;
    uint64_t v;
    if (byte + 8 <= nbytes) {
      std::memcpy(&v, data + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      v = 0;
      for (int i = 0; i < 8; i++)
        v = (v << 8) | (byte + i < nbytes ? data[byte + i] : 0);
    }
    return (uint32_t)(v >> (32 - sh));
  }
  // fast multi-bit read (n <= 24); error semantics match bitwise reads
  inline uint32_t read_bits_f(int n) {
    uint32_t v = peek_bits(n);
    pos += n;
    if (pos > nbits) error = true;
    return v;
  }

  uint32_t read_bits(int n) {
    if (n <= 24) return read_bits_f(n);
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }
  void align() { pos = (pos + 7) & ~7LL; }
  bool more_rbsp_data(int64_t stop_bit_pos) const {
    return pos < stop_bit_pos;
  }
};

// exp-golomb: one 32-bit peek + clz replaces the bit-by-bit zero scan
// (the scan was ~17% of CAVLC parse time at 1080p)
static uint32_t read_ue(BitReader& r) {
  uint32_t v = r.peek_bits32();
  if (v & 0x80000000u) { r.pos++; return 0; }     // 1-bit fast path
  int lz = v ? __builtin_clz(v) : 32;
  if (lz <= 15) {                                 // code fits the peek
    r.pos += 2 * lz + 1;
    if (r.pos > r.nbits) { r.error = true; return 0; }
    return (v >> (31 - 2 * lz)) - 1;
  }
  // >31-bit codes (pathological): bitwise fallback
  int zeros = 0;
  while (r.read_bit() == 0) {
    if (++zeros > 32 || r.error) { r.error = true; return 0; }
  }
  if (zeros == 0) return 0;
  return (1u << zeros) - 1 + r.read_bits(zeros);
}
static int32_t read_se(BitReader& r) {
  uint32_t k = read_ue(r);
  if (k & 1) return (int32_t)((k + 1) >> 1);
  return -(int32_t)(k >> 1);
}

// VLC decode over (len, code, v0, v1) quad tables via a TWO-LEVEL
// peek-LUT: high-probability codes are short by construction, so an
// 8-bit first stage (1 KiB/table — the whole family stays L1-resident)
// resolves almost every symbol; codes longer than 8 bits fall through
// to a full-width second stage.  The round-3 single-level LUT needed
// up to 2^16 entries x 4 B = 256 KiB per coeff_token class, and the
// L2-missing loads were 52% of CAVLC parse time at 1080p.
struct VlcLut {
  int bits = 0;                         // full index width = max code len
  std::vector<uint32_t> e1;             // 8-bit first stage (0 = escape)
  std::vector<uint32_t> e;              // full-width second stage
};

static VlcLut build_vlc_lut(const int16_t* tab, int n) {
  VlcLut l;
  for (int i = 0; i < n; i++)
    if (tab[i * 4] > l.bits) l.bits = tab[i * 4];
  l.e.assign((size_t)1 << l.bits, 0);
  for (int i = 0; i < n; i++) {
    int len = tab[i * 4];
    if (len <= 0) continue;
    uint32_t code = (uint32_t)tab[i * 4 + 1];
    uint32_t entry = (uint32_t)len
                   | ((uint32_t)(tab[i * 4 + 2] + 64) << 8)
                   | ((uint32_t)(tab[i * 4 + 3] + 64) << 16);
    uint32_t base = code << (l.bits - len);
    for (uint32_t k = 0; k < (1u << (l.bits - len)); k++)
      l.e[base + k] = entry;
  }
  l.e1.assign(256, 0);
  for (uint32_t idx = 0; idx < 256; idx++) {
    uint32_t full = l.bits > 8 ? (idx << (l.bits - 8))
                               : (idx >> (8 - l.bits));
    uint32_t entry = l.e[full];
    if ((entry & 0xFF) <= 8 || l.bits <= 8) l.e1[idx] = entry;
  }
  return l;
}

struct VlcLuts {
  VlcLut coeff[4];                      // nC classes 0/1/2 + chroma DC
  VlcLut tz[15], tzc[3], run[7];
  VlcLuts() {
    coeff[0] = build_vlc_lut(kCoeffTok0, kCoeffTokSizes[0]);
    coeff[1] = build_vlc_lut(kCoeffTok1, kCoeffTokSizes[1]);
    coeff[2] = build_vlc_lut(kCoeffTok2, kCoeffTokSizes[2]);
    coeff[3] = build_vlc_lut(kCoeffTokCdc, kCoeffTokSizes[3]);
    for (int i = 0; i < 15; i++)
      tz[i] = build_vlc_lut(kTotalZerosTabs[i], kTotalZerosSizes[i]);
    for (int i = 0; i < 3; i++)
      tzc[i] = build_vlc_lut(kTotalZerosCdcTabs[i], kTotalZerosCdcSizes[i]);
    for (int i = 0; i < 7; i++)
      run[i] = build_vlc_lut(kRunBeforeTabs[i], kRunBeforeSizes[i]);
  }
};

static const VlcLuts& vlc_luts() {
  static const VlcLuts L;              // built once, thread-safe
  return L;
}

static inline bool read_vlc_lut(BitReader& r, const VlcLut& l,
                                int* v0, int* v1) {
  uint32_t e = l.e1[r.peek_bits(8)];
  if (e == 0 && l.bits > 8) e = l.e[r.peek_bits(l.bits)];
  int len = (int)(e & 0xFF);
  if (len == 0 || r.pos + len > r.nbits) { r.error = true; return false; }
  r.pos += len;
  *v0 = (int)((e >> 8) & 0xFF) - 64;
  *v1 = (int)((e >> 16) & 0xFF) - 64;
  return true;
}

// ---------------------------------------------------------------------------
// frame buffers (must match the ctypes struct in native/__init__.py)

struct FrameBufs {
  int8_t* mb_kind;
  int32_t* qpy;
  int8_t* i16_mode;
  int8_t* chroma_mode;
  int8_t* luma4x4_modes;     // [n][16]
  int8_t* luma8x8_modes;     // [n][4]
  int8_t* cbp_luma;
  int8_t* cbp_chroma;
  int32_t* luma_dc;          // [n][16] raster
  int32_t* luma_ac;          // [n][16][16] raster per 4x4 blk
  int32_t* luma8x8_coeff;    // [n][4][64] raster per 8x8 blk
  int32_t* chroma_dc;        // [n][2][4]
  int32_t* chroma_ac;        // [n][2][4][16]
  int16_t* total_coeff_luma;    // [n][16]
  int16_t* total_coeff_chroma;  // [n][2][4]
  // slab mode (see ops/slab.py for the layouts): coefficient writes go
  // to skew-slot-ordered int16 records [n_waves*maxw][256|128|32]
  // instead of the raster buffers; in the device mode to the parts of
  // the record of the MB being parsed (SliceDec::rec)
  int16_t* luma_slab = nullptr;
  int16_t* chroma_slab = nullptr;
  int16_t* dc_slab = nullptr;
  int8_t* cbf_luma_dc;
  int8_t* cbf_luma;          // [n][16]
  int8_t* cbf_luma8x8;       // [n][4]
  int8_t* cbf_chroma_dc;     // [n][2]
  int8_t* cbf_chroma;        // [n][2][4]
  int8_t* transform8x8;
  uint8_t* parsed;
};

constexpr int KIND_I4 = 0, KIND_I16 = 1, KIND_PCM = 2, KIND_I8 = 3;

// ---------------------------------------------------------------------------
// slab-mode write tables (scan position -> slab offset; ops/slab.py layouts)

struct SlabTabs {
  int l4[16][16];    // [decode-order blk][scan k] -> luma slab offset
  int l8[4][64];     // [blk8][scan k]
  int c4[8][16];     // [4*ic + blk][scan k] -> chroma slab offset
  int pcm_y[256];    // raster pixel -> luma slab offset
  int pcm_c[128];    // (64*ic + 8*Y + X) -> chroma slab offset
  SlabTabs() {
    for (int blk = 0; blk < 16; blk++) {
      // decode order blk = 8*y8 + 4*x8 + 2*y4 + x4 -> raster b = 4u+v
      int y8 = blk >> 3, x8 = (blk >> 2) & 1, y4 = (blk >> 1) & 1,
          x4 = blk & 1;
      int b = 4 * (2 * y8 + y4) + 2 * x8 + x4;
      for (int k = 0; k < 16; k++) {
        int r = kZigzag4[k];
        l4[blk][k] = 64 * (r & 3) + 16 * (r >> 2) + b;
      }
    }
    for (int b8 = 0; b8 < 4; b8++)
      for (int k = 0; k < 64; k++) {
        int r = kZigzag8[k];
        l8[b8][k] = 32 * (r & 7) + 4 * (r >> 3) + b8;
      }
    for (int q = 0; q < 8; q++)
      for (int k = 0; k < 16; k++) {
        int r = kZigzag4[k];
        c4[q][k] = 32 * (r & 3) + 8 * (r >> 2) + q;
      }
    for (int i = 0; i < 256; i++) {
      int Y = i >> 4, X = i & 15;
      pcm_y[i] = 64 * (Y & 3) + 16 * (X & 3) + 4 * (Y >> 2) + (X >> 2);
    }
    for (int i = 0; i < 128; i++) {
      int ic = i >> 6, Y = (i >> 3) & 7, X = i & 7;
      pcm_c[i] = 32 * (Y & 3) + 8 * (X & 3) + 4 * ic + 2 * (Y >> 2)
               + (X >> 2);
    }
  }
};

static const SlabTabs& slab_tabs() {
  static const SlabTabs T;
  return T;
}

// ---------------------------------------------------------------------------
// spatial neighbor derivations (port of spatial.py)

// Precomputed neighbor tables: for every (block, which A/B) pair the
// neighbor's location class (0 = same MB, 1 = left MB, 2 = up MB) and
// block index are FIXED by geometry — the per-call coordinate math +
// branches (blk4_at was 8% of CAVLC parse) reduce to two table bytes.
struct NbrTabs {
  uint8_t l4_loc[16][2], l4_blk[16][2];   // 4x4 luma, decode order
  uint8_t l8_loc[4][2], l8_blk[4][2];     // 8x8 luma
  uint8_t c4_loc[4][2], c4_blk[4][2];     // 4x4 chroma
  static int blk4_at(int x, int y) {
    return 8 * (y / 8) + 4 * (x / 8) + 2 * ((y % 8) / 4) + ((x % 8) / 4);
  }
  NbrTabs() {
    for (int blk = 0; blk < 16; blk++)
      for (int w = 0; w < 2; w++) {
        int x = kBlkX[blk], y = kBlkY[blk];
        int xn = w == 0 ? x - 4 : x, yn = w == 0 ? y : y - 4;
        if (xn < 0) { l4_loc[blk][w] = 1; l4_blk[blk][w] = blk4_at(xn + 16, yn); }
        else if (yn < 0) { l4_loc[blk][w] = 2; l4_blk[blk][w] = blk4_at(xn, yn + 16); }
        else { l4_loc[blk][w] = 0; l4_blk[blk][w] = blk4_at(xn, yn); }
      }
    for (int b8 = 0; b8 < 4; b8++)
      for (int w = 0; w < 2; w++) {
        int x = (b8 % 2) * 8, y = (b8 / 2) * 8;
        int xn = w == 0 ? x - 8 : x, yn = w == 0 ? y : y - 8;
        if (xn < 0) { l8_loc[b8][w] = 1; l8_blk[b8][w] = (yn / 8) * 2 + (xn + 16) / 8; }
        else if (yn < 0) { l8_loc[b8][w] = 2; l8_blk[b8][w] = ((yn + 16) / 8) * 2 + xn / 8; }
        else { l8_loc[b8][w] = 0; l8_blk[b8][w] = (yn / 8) * 2 + xn / 8; }
      }
    for (int blk = 0; blk < 4; blk++)
      for (int w = 0; w < 2; w++) {
        int x = (blk % 2) * 4, y = (blk / 2) * 4;
        int xn = w == 0 ? x - 4 : x, yn = w == 0 ? y : y - 4;
        if (xn < 0) { c4_loc[blk][w] = 1; c4_blk[blk][w] = (yn / 4) * 2 + (xn + 8) / 4; }
        else if (yn < 0) { c4_loc[blk][w] = 2; c4_blk[blk][w] = ((yn + 8) / 4) * 2 + xn / 4; }
        else { c4_loc[blk][w] = 0; c4_blk[blk][w] = (yn / 4) * 2 + xn / 4; }
      }
  }
};

static const NbrTabs& nbr_tabs() {
  static const NbrTabs T;
  return T;
}

struct Geo {
  int wmb, hmb, first_mb;
  const NbrTabs* nt = &nbr_tabs();
  // resolve a NbrTabs location class against the CURRENT MB's cached
  // neighbors (every parse-time derivation targets the MB being parsed)
  inline int loc_mb(int loc) const {
    return loc == 0 ? cur_mb : (loc == 1 ? cur_a : cur_b);
  }
  // current-MB cache: every neighbor derivation during macroblock parse
  // refers to the MB being parsed, so the x/y division and the skew
  // slot are computed ONCE per MB (set_current) instead of per call —
  // the per-call `mb % wmb` divisions were measurable in the bin loop.
  int cur_mb = -1, cur_x = 0, cur_y = 0, cur_a = -1, cur_b = -1;
  int64_t cur_slot = 0;
  void set_current(int mb, int maxw) {
    cur_mb = mb;
    cur_x = mb % wmb;
    cur_y = mb / wmb;
    cur_a = (cur_x > 0) ? mb - 1 : -1;
    cur_b = (cur_y > 0) ? mb - wmb : -1;
    if (cur_a < first_mb) cur_a = -1;
    if (cur_b < first_mb) cur_b = -1;
    int w = 2 * cur_y + cur_x;
    int r0w = w / 2 < hmb - 1 ? w / 2 : hmb - 1;
    cur_slot = (int64_t)w * maxw + (r0w - cur_y);
  }
  inline void mb_neighbors(int mb, int* a, int* b) const {
    if (mb == cur_mb) { *a = cur_a; *b = cur_b; return; }
    int x = mb % wmb, y = mb / wmb;
    *a = (x > 0) ? mb - 1 : -1;
    *b = (y > 0) ? mb - wmb : -1;
    if (*a < first_mb) *a = -1;
    if (*b < first_mb) *b = -1;
  }
  static int blk4_at(int x, int y) {
    return 8 * (y / 8) + 4 * (x / 8) + 2 * ((y % 8) / 4) + ((x % 8) / 4);
  }
  // which: 0 = A (left), 1 = B (up)
  bool luma4_nbr(int mb, int blk, int which, int* mb_n, int* blk_n) const {
    int x = kBlkX[blk], y = kBlkY[blk];
    int xn = which == 0 ? x - 4 : x;
    int yn = which == 0 ? y : y - 4;
    int a, b;
    if (xn < 0) {
      mb_neighbors(mb, &a, &b);
      if (a < 0) return false;
      *mb_n = a; *blk_n = blk4_at(xn + 16, yn);
      return true;
    }
    if (yn < 0) {
      mb_neighbors(mb, &a, &b);
      if (b < 0) return false;
      *mb_n = b; *blk_n = blk4_at(xn, yn + 16);
      return true;
    }
    *mb_n = mb; *blk_n = blk4_at(xn, yn);
    return true;
  }
  bool luma8_nbr(int mb, int blk8, int which, int* mb_n, int* blk_n) const {
    int x = (blk8 % 2) * 8, y = (blk8 / 2) * 8;
    int xn = which == 0 ? x - 8 : x;
    int yn = which == 0 ? y : y - 8;
    int a, b;
    if (xn < 0) {
      mb_neighbors(mb, &a, &b);
      if (a < 0) return false;
      *mb_n = a; *blk_n = (yn / 8) * 2 + (xn + 16) / 8;
      return true;
    }
    if (yn < 0) {
      mb_neighbors(mb, &a, &b);
      if (b < 0) return false;
      *mb_n = b; *blk_n = ((yn + 16) / 8) * 2 + xn / 8;
      return true;
    }
    *mb_n = mb; *blk_n = (yn / 8) * 2 + xn / 8;
    return true;
  }
  bool chroma4_nbr(int mb, int blk, int which, int* mb_n, int* blk_n) const {
    int x = (blk % 2) * 4, y = (blk / 2) * 4;
    int xn = which == 0 ? x - 4 : x;
    int yn = which == 0 ? y : y - 4;
    int a, b;
    if (xn < 0) {
      mb_neighbors(mb, &a, &b);
      if (a < 0) return false;
      *mb_n = a; *blk_n = (yn / 4) * 2 + (xn + 8) / 4;
      return true;
    }
    if (yn < 0) {
      mb_neighbors(mb, &a, &b);
      if (b < 0) return false;
      *mb_n = b; *blk_n = ((yn + 8) / 4) * 2 + xn / 4;
      return true;
    }
    *mb_n = mb; *blk_n = (yn / 4) * 2 + xn / 4;
    return true;
  }
};

// intra mode prediction (port of IntraModeResolver)
struct ModePred {
  const FrameBufs* f;
  const Geo* g;
  int pred4(int mb, int blk) const {
    const NbrTabs& T = *g->nt;
    int preds[2];
    for (int which = 0; which < 2; which++) {
      int mb_n = g->loc_mb(T.l4_loc[blk][which]);
      if (mb_n < 0 || !f->parsed[mb_n]) { preds[which] = -1; continue; }
      int blk_n = T.l4_blk[blk][which];
      int k = f->mb_kind[mb_n];
      if (k == KIND_I4) preds[which] = f->luma4x4_modes[mb_n * 16 + blk_n];
      else if (k == KIND_I8)
        preds[which] = f->luma8x8_modes[mb_n * 4 + (blk_n >> 2)];
      else preds[which] = 2;
    }
    if (preds[0] < 0 || preds[1] < 0) return 2;
    return preds[0] < preds[1] ? preds[0] : preds[1];
  }
  int pred8(int mb, int blk8) const {
    const NbrTabs& T = *g->nt;
    int preds[2];
    for (int which = 0; which < 2; which++) {
      int mb_n = g->loc_mb(T.l8_loc[blk8][which]);
      if (mb_n < 0 || !f->parsed[mb_n]) { preds[which] = -1; continue; }
      int blk_n = T.l8_blk[blk8][which];
      int k = f->mb_kind[mb_n];
      if (k == KIND_I8) preds[which] = f->luma8x8_modes[mb_n * 4 + blk_n];
      else if (k == KIND_I4) {
        int nsub = which == 0 ? 1 : 2;
        preds[which] = f->luma4x4_modes[mb_n * 16 + blk_n * 4 + nsub];
      } else preds[which] = 2;
    }
    if (preds[0] < 0 || preds[1] < 0) return 2;
    return preds[0] < preds[1] ? preds[0] : preds[1];
  }
};

// ---------------------------------------------------------------------------
// CAVLC

struct CavlcCtx {
  BitReader* r;
  FrameBufs* f;
  const Geo* g;
  const VlcLuts* L = &vlc_luts();   // hoisted: the per-call static-local
                                    // guard was ~16% of CAVLC parse
  int64_t stop_bit;

  int nc_luma(int mb, int blk) const {
    const NbrTabs& T = *g->nt;
    int ns[2];
    for (int which = 0; which < 2; which++) {
      int mb_n = g->loc_mb(T.l4_loc[blk][which]);
      if (mb_n < 0 || !f->parsed[mb_n]) { ns[which] = -1; continue; }
      if (f->mb_kind[mb_n] == KIND_PCM) ns[which] = 16;
      else ns[which] = f->total_coeff_luma[mb_n * 16
                                           + T.l4_blk[blk][which]];
    }
    if (ns[0] >= 0 && ns[1] >= 0) return (ns[0] + ns[1] + 1) >> 1;
    return ns[0] >= 0 ? ns[0] : (ns[1] >= 0 ? ns[1] : 0);
  }
  int nc_chroma(int mb, int ic, int blk) const {
    const NbrTabs& T = *g->nt;
    int ns[2];
    for (int which = 0; which < 2; which++) {
      int mb_n = g->loc_mb(T.c4_loc[blk][which]);
      if (mb_n < 0 || !f->parsed[mb_n]) { ns[which] = -1; continue; }
      if (f->mb_kind[mb_n] == KIND_PCM) ns[which] = 16;
      else ns[which] = f->total_coeff_chroma[(mb_n * 2 + ic) * 4
                                             + T.c4_blk[blk][which]];
    }
    if (ns[0] >= 0 && ns[1] >= 0) return (ns[0] + ns[1] + 1) >> 1;
    return ns[0] >= 0 ? ns[0] : (ns[1] >= 0 ? ns[1] : 0);
  }

  // returns TotalCoeff; fills levels[max] in scan order
  // returns TotalCoeff; emits the significant coefficients as SPARSE
  // (scan position, value) pairs — pos ascending, at most TotalCoeff
  // entries.  Zero positions are never materialized: the stores write
  // only the significant slots into zero-initialized staging, which
  // A/B-measured faster than dense 16-wide stores + memset (and unlike
  // the rejected per-element zero-skip, iterating a known-significant
  // list has no mispredicted branch).
  int residual(int nC, int start, int end, int maxn, int* pos_out,
               int* val_out) {
    BitReader& rd = *r;
    const VlcLuts& L = *this->L;
    int tc = 0, t1 = 0;
    if (nC >= 8) {
      uint32_t v = rd.read_bits(6);
      if (v == 3) { tc = 0; t1 = 0; }
      else { tc = (int)(v >> 2) + 1; t1 = (int)(v & 3); }
    } else if (nC < 0) {
      if (!read_vlc_lut(rd, L.coeff[3], &tc, &t1))
        { rd.error = true; return -1; }
    } else {
      int cls = nC < 2 ? 0 : (nC < 4 ? 1 : 2);
      if (!read_vlc_lut(rd, L.coeff[cls], &tc, &t1))
        { rd.error = true; return -1; }
    }
    if (tc == 0) return 0;
    if (tc > end - start + 1) { rd.error = true; return -1; }
    (void)maxn;

    int lv[64];
    int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
    if (t1 > 0) {                       // trailing-one signs, batched
      uint32_t s = rd.read_bits_f(t1);
      for (int i = 0; i < t1; i++)
        lv[i] = 1 - 2 * (int)((s >> (t1 - 1 - i)) & 1);
    }
    for (int i = t1; i < tc; i++) {
      // level_prefix zero scan via one peek + clz (was bit-by-bit);
      // the suffix rides in the SAME peeked window whenever
      // prefix + 1 + suffix_size <= 32 (always, outside escape codes),
      // halving the stream reads of the hottest CAVLC loop
      uint32_t pk = rd.peek_bits32();
      int prefix = pk ? __builtin_clz(pk) : 32;
      int suffix_size = suffix_len;
      int suffix;
      if (prefix >= 15) {               // escape / pathological: slow path
        if (prefix >= 32) {
          prefix = 0;
          while (rd.read_bit() == 0) {
            if (++prefix > 32 || rd.error) { rd.error = true; return -1; }
          }
        } else {
          rd.pos += prefix + 1;
          if (rd.pos > rd.nbits) { rd.error = true; return -1; }
        }
        if (prefix >= 15) suffix_size = prefix - 3;
        else if (prefix == 14 && suffix_len == 0) suffix_size = 4;
        suffix = suffix_size > 0 ? (int)rd.read_bits(suffix_size) : 0;
      } else {
        if (prefix == 14 && suffix_len == 0) suffix_size = 4;
        int take = prefix + 1 + suffix_size;
        rd.pos += take;
        if (rd.pos > rd.nbits) { rd.error = true; return -1; }
        suffix = suffix_size > 0
                 ? (int)((pk >> (32 - take)) & ((1u << suffix_size) - 1))
                 : 0;
      }
      int code = ((prefix < 15 ? prefix : 15) << suffix_len) + suffix;
      if (prefix >= 15 && suffix_len == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      lv[i] = (code % 2 == 0) ? (code + 2) >> 1 : -((code + 1) >> 1);
      if (suffix_len == 0) suffix_len = 1;
      int a = lv[i] < 0 ? -lv[i] : lv[i];
      if (a > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int total_zeros = 0;
    if (tc < end - start + 1) {
      int dummy;
      const VlcLut& tzl = maxn == 4 ? L.tzc[tc - 1] : L.tz[tc - 1];
      if (!read_vlc_lut(rd, tzl, &total_zeros, &dummy))
        { rd.error = true; return -1; }
      // spec 9.2.3: total_zeros in [0, maxNumCoeff - TotalCoeff]; the
      // 15-coefficient AC blocks share the 16-coefficient VLC tables,
      // so a corrupt stream can code one zero too many — without this
      // check the scan position walks past the block (OOB zigzag read
      // + wrong-slot store; caught by tools/asan_check.sh)
      if (total_zeros > end - start + 1 - tc)
        { rd.error = true; return -1; }
    }

    int runs[64];
    int zeros_left = total_zeros;
    for (int i = 0; i < tc - 1; i++) {
      runs[i] = 0;
      if (zeros_left > 0) {
        int zl = zeros_left < 7 ? zeros_left : 7;
        int dummy;
        if (!read_vlc_lut(rd, L.run[zl - 1], &runs[i], &dummy))
          { rd.error = true; return -1; }
        zeros_left -= runs[i];
        if (zeros_left < 0) { rd.error = true; return -1; }
      }
    }
    runs[tc - 1] = zeros_left;

    int coeff_num = -1;
    for (int i = tc - 1; i >= 0; i--) {
      coeff_num += runs[i] + 1;
      pos_out[tc - 1 - i] = start + coeff_num;
      val_out[tc - 1 - i] = lv[i];
    }
    return tc;
  }
};

// ---------------------------------------------------------------------------
// CABAC

// fused context-transition tables indexed by packed (state << 1) | valMPS:
// next packed context after an MPS / LPS decision (LPS flips valMPS at
// state 0), plus the LPS range subtable replicated per packed value so
// decision() needs no unpacking shifts.
struct CabacTabs {
  uint8_t next_mps[128];
  uint8_t next_lps[128];
  uint8_t lps[128][4];
  // packed[s] = lps[0..3] | next_mps<<32 | next_lps<<40: the whole
  // per-state record in ONE 8-byte load (the split tables cost up to
  // three loads per decision on distinct cache lines)
  uint64_t packed[128];
  CabacTabs() {
    for (int s = 0; s < 128; s++) {
      int st = s >> 1, v = s & 1;
      next_mps[s] = (uint8_t)((kTransIdxMps[st] << 1) | v);
      next_lps[s] = (uint8_t)((kTransIdxLps[st] << 1)
                              | (st == 0 ? v ^ 1 : v));
      for (int q = 0; q < 4; q++)
        lps[s][q] = (uint8_t)kRangeTabLps[st * 4 + q];
      packed[s] = (uint64_t)lps[s][0] | ((uint64_t)lps[s][1] << 8)
                | ((uint64_t)lps[s][2] << 16) | ((uint64_t)lps[s][3] << 24)
                | ((uint64_t)next_mps[s] << 32)
                | ((uint64_t)next_lps[s] << 40);
    }
  }
};

static const CabacTabs& cabac_tabs() {
  static const CabacTabs T;
  return T;
}

// process-wide CABAC bin counter (observability: bench reports measured
// bins/frame; one register increment per bin, accumulated per slice)
std::atomic<uint64_t> g_cabac_bins{0};

struct CabacEngine {
  uint64_t bins = 0;                   // bins decoded by THIS engine
  // Buffered-low arithmetic decoder (same results as spec 9.3.3.2):
  // `low` holds the engine offset in its top bits with S pending
  // not-yet-consumed stream bits below it, so renormalization is just
  // S -= shift (the offset absorbs pending bits) and the bitstream is
  // touched only on 16-bit refills — the per-bin renorm read of the
  // naive engine was its hottest memory op.
  BitReader* r;
  const CabacTabs* t = &cabac_tabs();
  uint8_t ctx[460];                    // (state << 1) | valMPS, one load
  uint32_t range;
  uint64_t low;                        // offset << S | pending bits
  int S = 0;                           // pending bit count

  void init_contexts(int qp) {
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < 460; i++) {
      int m = kCtxInitI[i * 2], n = kCtxInitI[i * 2 + 1];
      int pre = ((m * qp) >> 4) + n;
      if (pre < 1) pre = 1;
      if (pre > 126) pre = 126;
      if (pre <= 63) ctx[i] = (uint8_t)((63 - pre) << 1);
      else ctx[i] = (uint8_t)(((pre - 64) << 1) | 1);
    }
  }
  inline void refill() {
    // 32-bit refills: offset(9b) + S(<=55) stays within uint64
    // (510 << 55 < 2^64); halves the refill frequency of the round-2
    // 16-bit engine
    if (S <= 23) {
      low = (low << 32) | r->peek_bits32();
      r->pos += 32;                    // prefetch (zero-padded past EOF)
      S += 32;
      if (r->pos - S > r->nbits) r->error = true;  // CONSUMED past end
    }
  }
  void init_engine() {
    range = 510;
    low = r->read_bits(9);
    S = 0;
    refill();
  }
  // return prefetched bits so the caller can read the raw stream
  // (I_PCM path: spec 9.3.1.2 re-initializes after aligned reads)
  void sync_reader() {
    r->pos -= S;
    S = 0;
    low = 0;
  }
  inline int decision(int i) {
    bins++;
    uint32_t s = ctx[i];
    uint64_t e = t->packed[s];                 // one load: lps x4 + nexts
    uint32_t r_lps = (uint32_t)(e >> (((range >> 6) & 3) * 8)) & 0xFF;
    uint32_t r_mps = range - r_lps;
    uint64_t thr = (uint64_t)r_mps << S;
#if MV_DEC_BRANCHLESS
    // forced-branchless MPS/LPS select (mask arithmetic, no jump).
    // A/B on the x264 QP26 stream measured this ~14% SLOWER than the
    // branchy form: at these QPs the MPS path dominates, the branch
    // predicts well, and the mask form serializes the dependency
    // chain — see PERF.md round 5.  Kept compilable for re-measurement
    // on other content (-DMV_DEC_BRANCHLESS=1).
    uint64_t is_lps = (uint64_t)(low >= thr);
    uint64_t mask = 0 - is_lps;                // ~0 on LPS
    low -= thr & mask;
    range = (uint32_t)((r_mps & ~mask) | (r_lps & mask));
    ctx[i] = (uint8_t)(e >> (32 + (is_lps << 3)));
#else
    // branchy select: compiles to one well-predicted conditional jump
    // (MPS-dominant content), letting the core speculate the common
    // path with a shorter dependency chain
    int is_lps = low >= thr;
    low -= is_lps ? thr : 0;
    range = is_lps ? r_lps : r_mps;
    ctx[i] = (uint8_t)(e >> (is_lps ? 40 : 32));
#endif
    int k = 9 - (32 - __builtin_clz(range));   // renorm (k in 0..7)
    range <<= k;
    S -= k;
    refill();
    return (int)(((uint64_t)s ^ (uint64_t)is_lps) & 1);
  }
  inline int bypass() {
    bins++;
    // refill BEFORE consuming: after `S -= 1` the invariant is only
    // low < 2*range << S, and `low << 32` would overflow at S = 23
    refill();
    S -= 1;
    uint64_t thr = (uint64_t)range << S;
#if MV_BYP_BRANCHLESS
    // sign bits are ~random so this compare branch is ~50%
    // mispredicted; the mask form trades it for a 2-op dependency
    uint64_t ge = (uint64_t)(low >= thr);
    low -= thr & (0 - ge);
    return (int)ge;
#else
    if (low >= thr) { low -= thr; return 1; }
    return 0;
#endif
  }
  // Bypass-run batching (UEG0 escapes): ONE 64-bit division yields the
  // next `m` bypass bins as the base-2 digits of low / (range << (S-m))
  // — each bypass step is one long-division digit step, so the whole
  // quotient IS the bin string.  bypass_peek never consumes;
  // bypass_consume(j) keeps exactly the first j digits.
  inline uint32_t bypass_peek(int m) {
    refill();                                  // guarantees S >= 24
    return (uint32_t)(low / ((uint64_t)range << (S - m)));
  }
  inline void bypass_consume(int j) {
    bins += j;
    S -= j;
    low %= (uint64_t)range << S;
  }
  int terminate() {
    bins++;
    range -= 2;
    if (low >= (uint64_t)range << S) return 1;
    int k = 9 - (32 - __builtin_clz(range));
    range <<= k;
    S -= k;
    refill();
    return 0;
  }
};

// Register-resident engine view for the residual hot loops: the member
// CabacEngine's per-bin state (range/low/S) lives behind `this`, and the
// disassembly showed every bin paying ~6 store/load round trips on that
// chain; a LOCAL object whose address never escapes lets the compiler
// keep all three in registers across the whole residual block, syncing
// with the member engine only at entry/exit.
struct EngLocal {
  uint32_t range;
  uint64_t low;
  int S;
  uint64_t nbins = 0;
  BitReader* r;
  const CabacTabs* t;
  uint8_t* ctx;

  explicit EngLocal(CabacEngine& e)
      : range(e.range), low(e.low), S(e.S), r(e.r), t(e.t), ctx(e.ctx) {}
  void flush(CabacEngine& e) {
    e.range = range;
    e.low = low;
    e.S = S;
    e.bins += nbins;
  }
  __attribute__((always_inline)) inline void refill() {
    if (S <= 23) {
      low = (low << 32) | r->peek_bits32();
      r->pos += 32;
      S += 32;
      if (r->pos - S > r->nbits) r->error = true;
    }
  }
  __attribute__((always_inline)) inline int decision(int i) {
    nbins++;
    uint32_t s = ctx[i];
    uint64_t e = t->packed[s];
    uint32_t r_lps = (uint32_t)(e >> (((range >> 6) & 3) * 8)) & 0xFF;
    uint32_t r_mps = range - r_lps;
    uint64_t thr = (uint64_t)r_mps << S;
    int is_lps = low >= thr;        // branchy: predicts well (see
    low -= is_lps ? thr : 0;        // CabacEngine::decision)
    range = is_lps ? r_lps : r_mps;
    ctx[i] = (uint8_t)(e >> (is_lps ? 40 : 32));
    int k = 9 - (32 - __builtin_clz(range));
    range <<= k;
    S -= k;
    refill();
    return (int)((s & 1) ^ (uint32_t)is_lps);
  }
  __attribute__((always_inline)) inline int bypass() {
    nbins++;
    refill();
    S -= 1;
    uint64_t thr = (uint64_t)range << S;
    uint64_t ge = (uint64_t)(low >= thr);
    low -= thr & (0 - ge);
    return (int)ge;
  }
  __attribute__((always_inline)) inline uint32_t bypass_peek(int m) {
    refill();
    return (uint32_t)(low / ((uint64_t)range << (S - m)));
  }
  __attribute__((always_inline)) inline void bypass_consume(int j) {
    nbins += j;
    S -= j;
    low %= (uint64_t)range << S;
  }
};

struct CabacCtx {
  BitReader* r;
  FrameBufs* f;
  const Geo* g;
  CabacEngine e;
  int prev_qp_delta = 0;

  int nbr(int mb, int which) const {
    int a, b;
    g->mb_neighbors(mb, &a, &b);
    int n = which == 0 ? a : b;
    if (n >= 0 && f->parsed[n]) return n;
    return -1;
  }
  int cond_mbtype(int mb) const {
    int inc = 0;
    for (int which = 0; which < 2; which++) {
      int n = nbr(mb, which);
      if (n >= 0 && f->mb_kind[n] != KIND_I4 && f->mb_kind[n] != KIND_I8)
        inc++;
    }
    return inc;
  }
  int cond_t8(int mb) const {
    int inc = 0;
    for (int which = 0; which < 2; which++) {
      int n = nbr(mb, which);
      if (n >= 0 && f->transform8x8[n]) inc++;
    }
    return inc;
  }
  int cond_chroma(int mb) const {
    int inc = 0;
    for (int which = 0; which < 2; which++) {
      int n = nbr(mb, which);
      if (n >= 0 && f->mb_kind[n] != KIND_PCM && f->chroma_mode[n] != 0)
        inc++;
    }
    return inc;
  }
  int cond_cbp_luma(int mb, int blk8) const {
    const NbrTabs& T = *g->nt;
    int incs[2];
    for (int which = 0; which < 2; which++) {
      int mb_n = g->loc_mb(T.l8_loc[blk8][which]);
      int blk_n = T.l8_blk[blk8][which];
      if (mb_n < 0) { incs[which] = 0; continue; }
      if (mb_n == mb) {
        incs[which] = ((f->cbp_luma[mb] >> blk_n) & 1) ? 0 : 1;
      } else if (!f->parsed[mb_n] || f->mb_kind[mb_n] == KIND_PCM) {
        incs[which] = 0;
      } else {
        incs[which] = ((f->cbp_luma[mb_n] >> blk_n) & 1) ? 0 : 1;
      }
    }
    return incs[0] + 2 * incs[1];
  }
  int cond_cbp_chroma(int mb, int binidx) const {
    int incs[2];
    for (int which = 0; which < 2; which++) {
      int n = nbr(mb, which);
      if (n < 0) { incs[which] = 0; continue; }
      if (f->mb_kind[n] == KIND_PCM) { incs[which] = 1; continue; }
      int c = f->cbp_chroma[n];
      incs[which] = binidx == 0 ? (c != 0 ? 1 : 0) : (c == 2 ? 1 : 0);
    }
    return incs[0] + 2 * incs[1];
  }
  // cat: 0 dc,1 ac,2 4x4,3 cdc,4 cac; blk packs (ic, blk4) for cac
  int cond_cbf(int mb, int cat, int blk, int ic) const {
    int incs[2];
    for (int which = 0; which < 2; which++) {
      if (cat == 0) {
        int n = nbr(mb, which);
        if (n < 0) { incs[which] = 1; }
        else if (f->mb_kind[n] == KIND_PCM) incs[which] = 1;
        else if (f->mb_kind[n] == KIND_I16) incs[which] = f->cbf_luma_dc[n];
        else incs[which] = 0;
      } else if (cat == 1 || cat == 2) {
        const NbrTabs& T = *g->nt;
        int mb_n = g->loc_mb(T.l4_loc[blk][which]);
        int blk_n = T.l4_blk[blk][which];
        if (mb_n < 0 || (mb_n != mb && !f->parsed[mb_n])) { incs[which] = 1; }
        else if (f->mb_kind[mb_n] == KIND_PCM) incs[which] = 1;
        else if (f->transform8x8[mb_n])
          incs[which] = (f->cbp_luma[mb_n] >> (blk_n >> 2)) & 1;
        else if (((f->cbp_luma[mb_n] >> (blk_n >> 2)) & 1) == 0)
          incs[which] = 0;
        else incs[which] = f->cbf_luma[mb_n * 16 + blk_n];
      } else if (cat == 3) {
        int n = nbr(mb, which);
        if (n < 0) incs[which] = 1;
        else if (f->mb_kind[n] == KIND_PCM) incs[which] = 1;
        else if (f->cbp_chroma[n] != 0)
          incs[which] = f->cbf_chroma_dc[n * 2 + blk];
        else incs[which] = 0;
      } else {
        const NbrTabs& T = *g->nt;
        int mb_n = g->loc_mb(T.c4_loc[blk][which]);
        int blk_n = T.c4_blk[blk][which];
        if (mb_n < 0 || (mb_n != mb && !f->parsed[mb_n])) { incs[which] = 1; }
        else if (f->mb_kind[mb_n] == KIND_PCM) incs[which] = 1;
        else if (f->cbp_chroma[mb_n] == 2)
          incs[which] = f->cbf_chroma[(mb_n * 2 + ic) * 4 + blk_n];
        else incs[which] = 0;
      }
    }
    return incs[0] + 2 * incs[1];
  }

  // returns cbf; fills levels[maxn] scan order
  // returns cbf (negative error); emits the significant coefficients
  // as SPARSE (scan position, value) pairs, pos ascending; *np_out =
  // pair count (see the CAVLC residual note).
  int residual(int mb, int cat, int blk, int ic, int maxn, int* pos_out,
               int* val_out, int* np_out) {
    static const int cat_off_cbf[5] = {0, 4, 8, 12, 16};
    *np_out = 0;
    static const int cat_off_sig[5] = {0, 15, 29, 44, 47};
    static const int cat_off_abs[5] = {0, 10, 20, 30, 39};
    // ctxIdxInc per scan position, hoisted out of the bin loop (the
    // per-bin cat branches were measurable): identity for cats 0-2,
    // min(i, 2) for chroma DC, kSig8x8/kLast8x8 for cat 5
    static const uint8_t kIdent[63] = {
        0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
        16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
        32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
        48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62};
    static const uint8_t kCdcInc[3] = {0, 1, 2};
    EngLocal el(e);              // range/low/S in registers for the
    //                              whole block (flush on every exit)
    int cbf = 1;
    if (cat != 5) {
      int inc = cond_cbf(mb, cat, blk, ic);
      cbf = el.decision(85 + cat_off_cbf[cat] + inc);
      if (!cbf) { el.flush(e); return 0; }
    }
    int sig_base, last_base, abs_base;
    const uint8_t *sig_tab, *last_tab;
    if (cat == 5) {
      sig_base = 402; last_base = 417; abs_base = 426;
      sig_tab = kSig8x8; last_tab = kLast8x8;
    } else {
      sig_base = 105 + cat_off_sig[cat];
      last_base = 166 + cat_off_sig[cat];
      abs_base = 227 + cat_off_abs[cat];
      if (cat == 3) { sig_tab = kCdcInc; last_tab = kCdcInc; }
      else { sig_tab = kIdent; last_tab = kIdent; }
    }
    // significance scan records positions directly (no sig[] bitmap /
    // memset, and the level loop only visits significant positions)
    int* pos = pos_out;
    int np = 0;
    bool last_fired = false;
    for (int i = 0; i < maxn - 1; i++) {
      if (el.decision(sig_base + sig_tab[i])) {
        pos[np++] = i;
        if (el.decision(last_base + last_tab[i])) { last_fired = true; break; }
      }
    }
    if (!last_fired) pos[np++] = maxn - 1;

    int num_gt1 = 0, num_eq1 = 0;
    for (int pi = np - 1; pi >= 0; pi--) {
      int idx = pos[pi];
      int inc0 = num_gt1 ? 0 : (1 + num_eq1 < 4 ? 1 + num_eq1 : 4);
      int prefix = 0;
      if (el.decision(abs_base + inc0)) {
        prefix = 1;
        int cap = cat == 3 ? 3 : 4;
        int inc_n = 5 + (num_gt1 < cap ? num_gt1 : cap);
        while (prefix < 14 && el.decision(abs_base + inc_n)) prefix++;
      }
      int64_t level = prefix + 1;
      int sign;
      if (prefix == 14) {
#if !MV_NO_ESC_BATCH
        // UEG0 escape: k leading-1 bins, a 0, k suffix bins, then the
        // sign — 2k+2 bypass bins resolved from ONE division peek when
        // k <= 10 (levels to ~2^10+14; larger falls to the serial loop)
        uint32_t dig = el.bypass_peek(22);
        int k = __builtin_clz(~(dig << 10));   // leading ones of 22 digits
        if (k <= 10) {
          uint32_t used = dig >> (22 - (2 * k + 2));
          sign = (int)(used & 1);
          uint32_t suffix = (used >> 1) & ((1u << k) - 1u);
          el.bypass_consume(2 * k + 2);
          level += (1LL << k) - 1 + suffix;
        } else {
          k = 0;
          while (el.bypass()) {
            if (++k > 30) { r->error = true; el.flush(e); return 0; }
          }
          int64_t suffix = 0;
          for (int j = 0; j < k; j++) suffix = (suffix << 1) | el.bypass();
          level += (1LL << k) - 1 + suffix;
          sign = el.bypass();
        }
#else
        int k = 0;
        while (el.bypass()) {
          if (++k > 30) { r->error = true; el.flush(e); return 0; }
        }
        int64_t suffix = 0;
        for (int j = 0; j < k; j++) suffix = (suffix << 1) | el.bypass();
        level += (1LL << k) - 1 + suffix;
        sign = el.bypass();
#endif
      } else {
        sign = el.bypass();
      }
      if (level == 1) num_eq1++; else num_gt1++;
      if (sign) level = -level;
      (void)idx;
      val_out[pi] = (int)level;
    }
    *np_out = np;
    el.flush(e);
    return 1;
  }
};

// ---------------------------------------------------------------------------
// device-mode records (native/__init__.py REC_*): one int16 record per MB in
// raster order, luma 256, chroma 128, DC 32, the META_ROWS rows 0..33,
// zero padding to whole 32-byte sectors (the card's load granule)

constexpr int kRecLuma = 0, kRecChroma = 256, kRecDc = 384, kRecMeta = 416;
constexpr int kRecMetaRows = 34;
constexpr int kRecLen = 464;
static_assert(kRecMeta + kRecMetaRows <= kRecLen, "record overflow");
static_assert(kRecLen * 2 % 32 == 0, "records are whole 32-byte sectors");

// Copy one record to the staging with non-temporal stores where the
// target is aligned for them (the staging is written once and read by
// the copy to the card, never by this core again), else memcpy.
static inline void stream_record(int16_t* dst, const int16_t* src) {
  constexpr int kBytes = kRecLen * 2;
#if defined(__SSE2__)
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    auto* d = reinterpret_cast<__m128i*>(dst);
    auto* s = reinterpret_cast<const __m128i*>(src);
    for (int i = 0; i < kBytes / 16; i++)
      _mm_stream_si128(d + i, _mm_load_si128(s + i));
    return;
  }
#endif
  std::memcpy(dst, src, kBytes);
}

// orders the non-temporal stores of a slice before its return
struct StoreFence {
  bool on;
  ~StoreFence() {
#if defined(__SSE2__)
    if (on) _mm_sfence();
#endif
  }
};

// ---------------------------------------------------------------------------
// macroblock layer (shared plumbing)

struct SliceDec {
  BitReader r;
  FrameBufs f;
  Geo g;
  ModePred mp;
  int qp_prev;
  int cabac;
  int transform8x8_mode;
  int chroma_array_type = 1;
  int slab_mode = 0;
  int maxw = 0;                 // skew lane width (slab mode)
  // the device mode (slab_v2): each MB's record, coefficients and meta
  // rows, is built whole in `rec` (zeroed per MB, so the coefficient
  // stores stay sparse) and then written to rec_out[mb] in one
  // contiguous store: every MB the slice parses is written whole, so the
  // staging needs no zeroing first.  ops/wave_layout.py lays the records
  // out into the kernel's per-wave feeds on the card.
  int slab_v2 = 0;
  int16_t* rec_out = nullptr;   // [n_mbs][kRecLen]
  alignas(16) int16_t rec[kRecLen];
  int cb_qp_off = 0, cr_qp_off = 0;
  const SlabTabs* ST = &slab_tabs();  // hoisted static-local guard
  int64_t stop_bit;
  CavlcCtx cav;
  CabacCtx cab;

  // skew slot of MB (r, c): wave w = 2r + c, lane k = r0(w) - r
  // (must match ops/recon_wave.skew_tables; cached in Geo per MB)
  inline int64_t slot_of(int mb) const {
    if (mb == g.cur_mb) return g.cur_slot;
    int rr = mb / g.wmb, cc = mb % g.wmb;
    int w = 2 * rr + cc;
    int r0w = w / 2 < g.hmb - 1 ? w / 2 : g.hmb - 1;
    return (int64_t)w * maxw + (r0w - rr);
  }
  // per-MB base offset into a slab with S sublane rows: the slot's
  // record [slot][S] in the records mode; in the device mode the slabs
  // point into `rec`, the record of the MB being parsed (every store
  // targets the current MB)
  inline int64_t slab_base(int mb, int S) const {
    return slab_v2 ? 0 : slot_of(mb) * S;
  }

  // coefficient stores: scan-ordered levels -> raster buffers (classic
  // mode) or slab records (slab mode; ops/slab.py layouts)
  // Coefficient stores are SPARSE: residual() emits (scan position,
  // value) pairs for the significant coefficients only, and these
  // write exactly those slots into the zero-initialized staging.
  // (A dense 16-wide store + memset per block was the round-3 form; a
  // per-element zero-skip branch was measured 30% slower — iterating
  // the significant list has neither the branch nor the zero writes.)
  void store_luma_dc(int mb, const int* pos, const int* val, int n) {
    if (slab_mode) {
      int16_t* out = f.dc_slab + slab_base(mb, 32);
      for (int j = 0; j < n; j++)
        out[kZigzag4[pos[j]]] = (int16_t)val[j];
    } else {
      int32_t* out = f.luma_dc + mb * 16;
      for (int j = 0; j < n; j++) out[kZigzag4[pos[j]]] = val[j];
    }
  }
  // shift = 1 for I16x16 AC blocks (scan position k -> block pos k+1)
  void store_luma4(int mb, int blk, const int* pos, const int* val,
                   int n, int shift) {
    if (slab_mode) {
      int16_t* out = f.luma_slab + slab_base(mb, 256);
      const int* t = ST->l4[blk];
      for (int j = 0; j < n; j++)
        out[t[pos[j] + shift]] = (int16_t)val[j];
    } else {
      int32_t* out = f.luma_ac + (mb * 16 + blk) * 16;
      for (int j = 0; j < n; j++)
        out[kZigzag4[pos[j] + shift]] = val[j];
    }
  }
  // 8x8 blocks: pos[] are 64-coefficient scan positions
  void store_luma8_scan(int mb, int b8, const int* pos, const int* val,
                        int n) {
    if (slab_mode) {
      int16_t* out = f.luma_slab + slab_base(mb, 256);
      const int* t = ST->l8[b8];
      for (int j = 0; j < n; j++)
        out[t[pos[j]]] = (int16_t)val[j];
    } else {
      int32_t* out = f.luma8x8_coeff + (mb * 4 + b8) * 64;
      for (int j = 0; j < n; j++) out[kZigzag8[pos[j]]] = val[j];
    }
  }
  void store_chroma_dc(int mb, int ic, const int* pos, const int* val,
                       int n) {
    if (slab_mode) {
      int16_t* out = f.dc_slab + slab_base(mb, 32) + (16 + ic * 4);
      for (int j = 0; j < n; j++) out[pos[j]] = (int16_t)val[j];
    } else {
      int32_t* out = f.chroma_dc + (mb * 2 + ic) * 4;
      for (int j = 0; j < n; j++) out[pos[j]] = val[j];
    }
  }
  // chroma AC: always the k -> k+1 scan shift (no DC in the block)
  void store_chroma4(int mb, int ic, int blk, const int* pos,
                     const int* val, int n) {
    if (slab_mode) {
      int16_t* out = f.chroma_slab + slab_base(mb, 128);
      const int* t = ST->c4[ic * 4 + blk];
      for (int j = 0; j < n; j++)
        out[t[pos[j] + 1]] = (int16_t)val[j];
    } else {
      int32_t* out = f.chroma_ac + ((mb * 2 + ic) * 4 + blk) * 16;
      for (int j = 0; j < n; j++)
        out[kZigzag4[pos[j] + 1]] = val[j];
    }
  }

  // device mode: start the record of the MB about to be parsed
  void begin_record() {
    if (slab_v2) std::memset(rec, 0, sizeof rec);
  }
  // device mode: this MB's meta rows (kind/parsed/availability/modes/QP
  // deriveds, the ops/slab.py META_ROWS layout) into its record, then
  // the record to its raster place.  Availability matches
  // ops/slab.meta_raster: neighbor exists, already parsed, same slice
  // (sequential raster parse from first_mb makes that `>= first_mb`).
  void end_record(int mb) {
    if (!slab_v2) return;
    int16_t* m = rec + kRecMeta;
    int x = g.cur_x, y = g.cur_y;
    m[0] = f.mb_kind[mb];
    m[1] = 1;
    m[2] = (x > 0 && mb - 1 >= g.first_mb) ? 1 : 0;
    m[3] = (y > 0 && mb - g.wmb >= g.first_mb) ? 1 : 0;
    m[4] = (x > 0 && y > 0 && mb - g.wmb - 1 >= g.first_mb) ? 1 : 0;
    m[5] = (x < g.wmb - 1 && y > 0 && mb - g.wmb + 1 >= g.first_mb)
           ? 1 : 0;
    m[6] = f.i16_mode[mb];
    m[7] = f.chroma_mode[mb];
    for (int i = 0; i < 4; i++) m[8 + i] = f.luma8x8_modes[mb * 4 + i];
    for (int i = 0; i < 16; i++) m[12 + i] = f.luma4x4_modes[mb * 16 + i];
    int qp = f.qpy[mb];
    m[28] = (int16_t)(qp % 6);
    m[29] = (int16_t)(qp / 6);
    int qcb = qp + cb_qp_off;
    qcb = kQpcFromQpi[qcb < 0 ? 0 : (qcb > 51 ? 51 : qcb)];
    m[30] = (int16_t)(qcb % 6);
    m[31] = (int16_t)(qcb / 6);
    int qcr = qp + cr_qp_off;
    qcr = kQpcFromQpi[qcr < 0 ? 0 : (qcr > 51 ? 51 : qcr)];
    m[32] = (int16_t)(qcr % 6);
    m[33] = (int16_t)(qcr / 6);
    stream_record(rec_out + (int64_t)mb * kRecLen, rec);
  }

  int parse_mb_cavlc(int mb);
  int parse_mb_cabac(int mb);
  void apply_pcm(int mb);
};

void SliceDec::apply_pcm(int mb) {
  // raw samples are stored via the Python wrapper reading them back from
  // the bitstream position we record; here we copy into luma_ac /
  // chroma_ac using the "PCM rides the coefficient buffers" layout.
  f.mb_kind[mb] = KIND_PCM;
  f.parsed[mb] = 1;
  r.align();
  if (slab_mode) {
    const SlabTabs& t = *ST;
    int16_t* y = f.luma_slab + slab_base(mb, 256);
    for (int i = 0; i < 256; i++)
      y[t.pcm_y[i]] = (int16_t)r.read_bits(8);
    int16_t* c = f.chroma_slab + slab_base(mb, 128);
    for (int i = 0; i < 128; i++)
      c[t.pcm_c[i]] = (int16_t)r.read_bits(8);
  } else {
    int32_t* y = f.luma_ac + mb * 256;
    for (int i = 0; i < 256; i++) y[i] = (int32_t)r.read_bits(8);
    int32_t* c = f.chroma_ac + mb * 128;
    for (int i = 0; i < 128; i++) c[i] = (int32_t)r.read_bits(8);
  }
  for (int i = 0; i < 16; i++) f.total_coeff_luma[mb * 16 + i] = 16;
  for (int i = 0; i < 8; i++) f.total_coeff_chroma[mb * 8 + i] = 16;
  f.cbf_luma_dc[mb] = 1;
  for (int i = 0; i < 16; i++) f.cbf_luma[mb * 16 + i] = 1;
  for (int i = 0; i < 4; i++) f.cbf_luma8x8[mb * 4 + i] = 1;
  for (int i = 0; i < 2; i++) f.cbf_chroma_dc[mb * 2 + i] = 1;
  for (int i = 0; i < 8; i++) f.cbf_chroma[mb * 8 + i] = 1;
  f.qpy[mb] = qp_prev;
}

int SliceDec::parse_mb_cavlc(int mb) {
  uint32_t mb_type = read_ue(r);
  if (r.error || mb_type > 25) return -1;
  if (mb_type == 25) { apply_pcm(mb); return 0; }

  int is_i16 = 0, cbp_l = 0, cbp_c = 0;
  if (mb_type == 0) {
    int t8 = 0;
    if (transform8x8_mode) t8 = r.read_bit();
    f.transform8x8[mb] = (int8_t)t8;
    f.mb_kind[mb] = t8 ? KIND_I8 : KIND_I4;
    f.parsed[mb] = 1;
    // prev_intra_pred_mode_flag + rem_intra_pred_mode in ONE 4-bit peek
    auto read_mode = [&](int pred) {
      uint32_t mv = r.peek_bits(4);
      if (mv & 8) { r.pos += 1; return pred; }
      r.pos += 4;
      if (r.pos > r.nbits) r.error = true;
      int rem = (int)(mv & 7);
      return rem < pred ? rem : rem + 1;
    };
    if (t8) {
      for (int b8 = 0; b8 < 4; b8++)
        f.luma8x8_modes[mb * 4 + b8] = (int8_t)read_mode(mp.pred8(mb, b8));
    } else {
      for (int b = 0; b < 16; b++)
        f.luma4x4_modes[mb * 16 + b] = (int8_t)read_mode(mp.pred4(mb, b));
    }
    uint32_t m = read_ue(r);
    if (m > 3) return -1;
    f.chroma_mode[mb] = (int8_t)m;
    uint32_t code_num = read_ue(r);
    const uint8_t* tab = chroma_array_type == 1 || chroma_array_type == 2
                         ? kMeCbp12 : kMeCbp03;
    int tabn = (chroma_array_type == 1 || chroma_array_type == 2) ? 48 : 16;
    if ((int)code_num >= tabn) return -1;
    int cbp = tab[code_num * 2];
    cbp_l = cbp & 15;
    cbp_c = cbp >> 4;
  } else {
    is_i16 = 1;
    int t = (int)mb_type - 1;
    f.mb_kind[mb] = KIND_I16;
    f.parsed[mb] = 1;
    f.i16_mode[mb] = (int8_t)(t % 4);
    cbp_c = (t / 4) % 3;
    cbp_l = t >= 12 ? 15 : 0;
    uint32_t m = read_ue(r);
    if (m > 3) return -1;
    f.chroma_mode[mb] = (int8_t)m;
  }
  f.cbp_luma[mb] = (int8_t)cbp_l;
  f.cbp_chroma[mb] = (int8_t)cbp_c;

  if (cbp_l || cbp_c || is_i16) {
    int delta = read_se(r);
    if (delta <= -27 || delta >= 26) return -1;
    qp_prev = (qp_prev + delta + 52) % 52;
  }
  f.qpy[mb] = qp_prev;

  int cpos[64], cval[64];
  int transform8 = f.transform8x8[mb];
  if (is_i16) {
    int nc = cav.nc_luma(mb, 0);
    int tc = cav.residual(nc, 0, 15, 16, cpos, cval);
    if (tc < 0) return -1;
    if (tc > 0) store_luma_dc(mb, cpos, cval, tc);
  }
  for (int b8 = 0; b8 < 4; b8++) {
    int coded = (cbp_l >> b8) & 1;
    if (!coded) continue;
    if (transform8) {
      for (int i4 = 0; i4 < 4; i4++) {
        int blk = b8 * 4 + i4;
        int nc = cav.nc_luma(mb, blk);
        int tc = cav.residual(nc, 0, 15, 16, cpos, cval);
        if (tc < 0) return -1;
        f.total_coeff_luma[mb * 16 + blk] = (int16_t)tc;
        // sub-block scan k -> 8x8 scan position 4k + i4
        for (int j = 0; j < tc; j++) cpos[j] = 4 * cpos[j] + i4;
        store_luma8_scan(mb, b8, cpos, cval, tc);
      }
    } else {
      for (int i4 = 0; i4 < 4; i4++) {
        int blk = b8 * 4 + i4;
        int nc = cav.nc_luma(mb, blk);
        int tc;
        if (is_i16) {
          tc = cav.residual(nc, 0, 14, 15, cpos, cval);
          if (tc < 0) return -1;
          if (tc > 0) store_luma4(mb, blk, cpos, cval, tc, 1);
        } else {
          tc = cav.residual(nc, 0, 15, 16, cpos, cval);
          if (tc < 0) return -1;
          if (tc > 0) store_luma4(mb, blk, cpos, cval, tc, 0);
        }
        f.total_coeff_luma[mb * 16 + blk] = (int16_t)tc;
      }
    }
  }
  if (cbp_c) {
    for (int ic = 0; ic < 2; ic++) {
      int tc = cav.residual(-1, 0, 3, 4, cpos, cval);
      if (tc < 0) return -1;
      if (tc > 0) store_chroma_dc(mb, ic, cpos, cval, tc);
    }
  }
  if (cbp_c & 2) {
    for (int ic = 0; ic < 2; ic++) {
      for (int blk = 0; blk < 4; blk++) {
        int nc = cav.nc_chroma(mb, ic, blk);
        int tc = cav.residual(nc, 0, 14, 15, cpos, cval);
        if (tc < 0) return -1;
        f.total_coeff_chroma[(mb * 2 + ic) * 4 + blk] = (int16_t)tc;
        if (tc > 0) store_chroma4(mb, ic, blk, cpos, cval, tc);
      }
    }
  }
  return 0;
}

int SliceDec::parse_mb_cabac(int mb) {
  CabacEngine& e = cab.e;
  // mb_type
  int mb_type;
  if (e.decision(3 + cab.cond_mbtype(mb)) == 0) mb_type = 0;
  else if (e.terminate()) {
    e.sync_reader();                 // return prefetched bits for PCM
    apply_pcm(mb);
    cab.prev_qp_delta = 0;
    e.init_engine();
    return 0;
  } else {
    int cbp_l = e.decision(3 + 3) ? 15 : 0;
    int cbp_c = 0;
    if (e.decision(3 + 4)) cbp_c = e.decision(3 + 5) ? 2 : 1;
    int hi = e.decision(3 + 6), lo = e.decision(3 + 7);
    mb_type = 1 + (2 * hi + lo) + 4 * cbp_c + (cbp_l ? 12 : 0);
  }

  int is_i16 = 0, cbp_l = 0, cbp_c = 0;
  if (mb_type == 0) {
    int t8 = 0;
    if (transform8x8_mode) t8 = e.decision(399 + cab.cond_t8(mb));
    f.transform8x8[mb] = (int8_t)t8;
    f.mb_kind[mb] = t8 ? KIND_I8 : KIND_I4;
    f.parsed[mb] = 1;
    int nblk = t8 ? 4 : 16;
    for (int b = 0; b < nblk; b++) {
      int pred = t8 ? mp.pred8(mb, b) : mp.pred4(mb, b);
      int mode;
      if (e.decision(68)) mode = pred;
      else {
        int rem = e.decision(69);
        rem |= e.decision(69) << 1;
        rem |= e.decision(69) << 2;
        mode = rem < pred ? rem : rem + 1;
      }
      if (t8) f.luma8x8_modes[mb * 4 + b] = (int8_t)mode;
      else f.luma4x4_modes[mb * 16 + b] = (int8_t)mode;
    }
    // chroma mode
    int cm = 0;
    if (e.decision(64 + cab.cond_chroma(mb))) {
      cm = 1;
      if (e.decision(67)) cm = e.decision(67) ? 3 : 2;
    }
    f.chroma_mode[mb] = (int8_t)cm;
    // cbp
    for (int b8 = 0; b8 < 4; b8++) {
      int inc = cab.cond_cbp_luma(mb, b8);
      if (e.decision(73 + inc)) cbp_l |= 1 << b8;
      f.cbp_luma[mb] = (int8_t)cbp_l;
    }
    if (e.decision(77 + cab.cond_cbp_chroma(mb, 0)))
      cbp_c = e.decision(81 + cab.cond_cbp_chroma(mb, 1)) ? 2 : 1;
  } else {
    is_i16 = 1;
    int t = mb_type - 1;
    f.mb_kind[mb] = KIND_I16;
    f.parsed[mb] = 1;
    f.i16_mode[mb] = (int8_t)(t % 4);
    cbp_c = (t / 4) % 3;
    cbp_l = t >= 12 ? 15 : 0;
    int cm = 0;
    if (e.decision(64 + cab.cond_chroma(mb))) {
      cm = 1;
      if (e.decision(67)) cm = e.decision(67) ? 3 : 2;
    }
    f.chroma_mode[mb] = (int8_t)cm;
  }
  f.cbp_luma[mb] = (int8_t)cbp_l;
  f.cbp_chroma[mb] = (int8_t)cbp_c;

  if (cbp_l || cbp_c || is_i16) {
    // mb_qp_delta
    int inc = cab.prev_qp_delta != 0 ? 1 : 0;
    int code = 0;
    if (e.decision(60 + inc)) {
      code = 1;
      if (e.decision(62)) {
        code = 2;
        while (e.decision(63)) { if (++code > 87) return -1; }
      }
    }
    int delta = (code & 1) ? (code + 1) >> 1 : -(code >> 1);
    cab.prev_qp_delta = delta;
    qp_prev = (qp_prev + delta + 52) % 52;
  } else {
    cab.prev_qp_delta = 0;
  }
  f.qpy[mb] = qp_prev;

  int cpos[64], cval[64], np;
  int transform8 = f.transform8x8[mb];
  if (is_i16) {
    int cbf = cab.residual(mb, 0, 0, 0, 16, cpos, cval, &np);
    if (r.error) return -1;
    f.cbf_luma_dc[mb] = (int8_t)cbf;
    if (cbf) store_luma_dc(mb, cpos, cval, np);
  }
  for (int b8 = 0; b8 < 4; b8++) {
    int coded = (cbp_l >> b8) & 1;
    if (!coded) continue;
    if (transform8) {
      if (!cab.residual(mb, 5, b8, 0, 64, cpos, cval, &np) && r.error)
        return -1;
      f.cbf_luma8x8[mb * 4 + b8] = 1;
      store_luma8_scan(mb, b8, cpos, cval, np);
    } else {
      for (int i4 = 0; i4 < 4; i4++) {
        int blk = b8 * 4 + i4;
        int cbf;
        if (is_i16) {
          cbf = cab.residual(mb, 1, blk, 0, 15, cpos, cval, &np);
          if (r.error) return -1;
          if (cbf) store_luma4(mb, blk, cpos, cval, np, 1);
        } else {
          cbf = cab.residual(mb, 2, blk, 0, 16, cpos, cval, &np);
          if (r.error) return -1;
          if (cbf) store_luma4(mb, blk, cpos, cval, np, 0);
        }
        f.cbf_luma[mb * 16 + blk] = (int8_t)cbf;
      }
    }
  }
  if (cbp_c) {
    for (int ic = 0; ic < 2; ic++) {
      int cbf = cab.residual(mb, 3, ic, ic, 4, cpos, cval, &np);
      if (r.error) return -1;
      f.cbf_chroma_dc[mb * 2 + ic] = (int8_t)cbf;
      if (cbf) store_chroma_dc(mb, ic, cpos, cval, np);
    }
  }
  if (cbp_c & 2) {
    for (int ic = 0; ic < 2; ic++) {
      for (int blk = 0; blk < 4; blk++) {
        int cbf = cab.residual(mb, 4, blk, ic, 15, cpos, cval, &np);
        if (r.error) return -1;
        f.cbf_chroma[(mb * 2 + ic) * 4 + blk] = (int8_t)cbf;
        if (cbf) store_chroma4(mb, ic, blk, cpos, cval, np);
      }
    }
  }
  return 0;
}

// Parse one I-slice's slice_data(); returns MBs parsed or negative error.
// Buffer pointer order MUST match _FIELDS in native/__init__.py; in the
// records mode three int16 slab buffers follow (luma/chroma/dc) and
// maxw > 0; in the device mode (slab_v2) one, the picture's records.
static int64_t parse_slice_impl(
    const uint8_t* rbsp, int64_t rbsp_len_bytes, int64_t data_bit_offset,
    int32_t wmb, int32_t hmb, int32_t first_mb, int32_t slice_qp,
    int32_t entropy_cabac, int32_t transform8x8_mode,
    void** bufs, int32_t slab_mode, int32_t maxw,
    int32_t slab_v2 = 0, int32_t cb_qp_off = 0, int32_t cr_qp_off = 0) {
  SliceDec d;
  StoreFence fence{slab_v2 != 0};
  d.r.data = rbsp;
  d.r.nbits = rbsp_len_bytes * 8;
  d.r.pos = data_bit_offset;
  int i = 0;
  d.f.mb_kind = (int8_t*)bufs[i++];
  d.f.qpy = (int32_t*)bufs[i++];
  d.f.i16_mode = (int8_t*)bufs[i++];
  d.f.chroma_mode = (int8_t*)bufs[i++];
  d.f.luma4x4_modes = (int8_t*)bufs[i++];
  d.f.luma8x8_modes = (int8_t*)bufs[i++];
  d.f.cbp_luma = (int8_t*)bufs[i++];
  d.f.cbp_chroma = (int8_t*)bufs[i++];
  d.f.luma_dc = (int32_t*)bufs[i++];
  d.f.luma_ac = (int32_t*)bufs[i++];
  d.f.luma8x8_coeff = (int32_t*)bufs[i++];
  d.f.chroma_dc = (int32_t*)bufs[i++];
  d.f.chroma_ac = (int32_t*)bufs[i++];
  d.f.total_coeff_luma = (int16_t*)bufs[i++];
  d.f.total_coeff_chroma = (int16_t*)bufs[i++];
  d.f.cbf_luma_dc = (int8_t*)bufs[i++];
  d.f.cbf_luma = (int8_t*)bufs[i++];
  d.f.cbf_luma8x8 = (int8_t*)bufs[i++];
  d.f.cbf_chroma_dc = (int8_t*)bufs[i++];
  d.f.cbf_chroma = (int8_t*)bufs[i++];
  d.f.transform8x8 = (int8_t*)bufs[i++];
  d.f.parsed = (uint8_t*)bufs[i++];
  d.slab_mode = slab_mode;
  d.maxw = maxw;
  d.slab_v2 = slab_v2;
  if (slab_v2) {
    d.rec_out = (int16_t*)bufs[i++];
    d.f.luma_slab = d.rec + kRecLuma;
    d.f.chroma_slab = d.rec + kRecChroma;
    d.f.dc_slab = d.rec + kRecDc;
    d.cb_qp_off = cb_qp_off;
    d.cr_qp_off = cr_qp_off;
  } else if (slab_mode) {
    d.f.luma_slab = (int16_t*)bufs[i++];
    d.f.chroma_slab = (int16_t*)bufs[i++];
    d.f.dc_slab = (int16_t*)bufs[i++];
  }

  d.g.wmb = wmb;
  d.g.hmb = hmb;
  d.g.first_mb = first_mb;
  d.mp.f = &d.f;
  d.mp.g = &d.g;
  d.qp_prev = slice_qp;
  d.cabac = entropy_cabac;
  d.transform8x8_mode = transform8x8_mode;
  d.cav.r = &d.r;
  d.cav.f = &d.f;
  d.cav.g = &d.g;
  d.cab.r = &d.r;
  d.cab.f = &d.f;
  d.cab.g = &d.g;

  int n_mbs = wmb * hmb;
  int mb = first_mb;

  if (entropy_cabac) {
    d.r.align();
    d.cab.e.r = &d.r;
    d.cab.e.init_contexts(slice_qp);
    d.cab.e.init_engine();
    while (true) {
      if (mb >= n_mbs) return -2;
      d.g.set_current(mb, maxw);
      d.begin_record();
      if (d.parse_mb_cabac(mb) < 0 || d.r.error) return -3;
      d.end_record(mb);
      mb++;
      if (d.cab.e.terminate()) break;
    }
    g_cabac_bins.fetch_add(d.cab.e.bins, std::memory_order_relaxed);
  } else {
    // locate the rbsp stop bit (backward scan, as in bitio.py)
    int64_t stop = -1;
    for (int64_t byte = rbsp_len_bytes - 1; byte >= 0; byte--) {
      if (rbsp[byte]) {
        uint8_t v = rbsp[byte];
        int low = 0;
        while (!((v >> low) & 1)) low++;
        stop = byte * 8 + (7 - low);
        break;
      }
    }
    if (stop < 0) return -4;
    while (d.r.pos < stop) {
      if (mb >= n_mbs) return -2;
      d.g.set_current(mb, maxw);
      d.begin_record();
      if (d.parse_mb_cavlc(mb) < 0 || d.r.error) return -3;
      d.end_record(mb);
      mb++;
    }
  }
  return mb - first_mb;
}

}  // namespace

extern "C" {

int64_t mv_parse_slice(
    const uint8_t* rbsp, int64_t rbsp_len_bytes, int64_t data_bit_offset,
    int32_t wmb, int32_t hmb, int32_t first_mb, int32_t slice_qp,
    int32_t entropy_cabac, int32_t transform8x8_mode,
    void** bufs) {
  return parse_slice_impl(rbsp, rbsp_len_bytes, data_bit_offset, wmb, hmb,
                          first_mb, slice_qp, entropy_cabac,
                          transform8x8_mode, bufs, 0, 0);
}

// Slab-emission variant: coefficients written as skew-slot-ordered int16
// slab records (ops/slab.py layouts) so the device prep is one dense
// transpose.  bufs carries the 22 classic pointers + luma/chroma/dc
// slab pointers; maxw is skew_tables' lane width.
int64_t mv_parse_slice_slab(
    const uint8_t* rbsp, int64_t rbsp_len_bytes, int64_t data_bit_offset,
    int32_t wmb, int32_t hmb, int32_t first_mb, int32_t slice_qp,
    int32_t entropy_cabac, int32_t transform8x8_mode, int32_t maxw,
    void** bufs) {
  return parse_slice_impl(rbsp, rbsp_len_bytes, data_bit_offset, wmb, hmb,
                          first_mb, slice_qp, entropy_cabac,
                          transform8x8_mode, bufs, 1, maxw);
}

// Device-mode variant: each MB the slice parses is written whole as one
// int16 record of kRecLen (native/__init__.py REC_*: coefficients and
// meta rows) at its raster index of the picture's records, so the
// staging needs no zeroing first and the card lays the records out into
// the kernel's per-wave feeds (ops/wave_layout.py).  bufs carries the 22
// classic pointers + the picture's records [n_mbs][kRecLen].
int64_t mv_parse_slice_slab2(
    const uint8_t* rbsp, int64_t rbsp_len_bytes, int64_t data_bit_offset,
    int32_t wmb, int32_t hmb, int32_t first_mb, int32_t slice_qp,
    int32_t entropy_cabac, int32_t transform8x8_mode,
    int32_t cb_qp_off, int32_t cr_qp_off, void** bufs) {
  return parse_slice_impl(rbsp, rbsp_len_bytes, data_bit_offset, wmb, hmb,
                          first_mb, slice_qp, entropy_cabac,
                          transform8x8_mode, bufs, 1, 0,
                          1, cb_qp_off, cr_qp_off);
}

// int16 elements of a device-mode record (the bindings check theirs)
int32_t mv_record_len(void) { return kRecLen; }

// total CABAC bins decoded by this process (all threads, all slices)
uint64_t mv_cabac_bins_total(void) {
  return g_cabac_bins.load(std::memory_order_relaxed);
}

}  // extern "C"
