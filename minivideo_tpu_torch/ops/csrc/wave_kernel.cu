// Fused wavefront intra reconstruction of H.264 I pictures on Hopper.
//
// Replaces the TPU kernel minivideo_tpu/ops/recon_fused.py::_wave_kernel
// (the Pallas kernel built by _build_kernel).  One launch reconstructs one
// anti-diagonal wave w (MB (r, c) with 2*r + c == w) of every frame of the
// batch: dequant, 4x4/8x8 IDCT, I16x16 and chroma DC Hadamards, PCM
// pass-through (ops/slab.residual_from_slabs), then I4x4, I8x8 (with
// reference filtering), I16x16 and chroma prediction, reconstruction and
// clipping to u8 (ops/recon_lane.wave_compute_lane).
//
// Design.  The TPU kernel carries the neighbour state (right column,
// corners, double-buffered bottom rows) from one grid step to the next in
// VMEM scratch, because its grid runs in order on one core.  Here the
// blocks of one launch run in no order, so the state lives in the output
// itself: each block writes its MB straight into the raster Y/Cb/Cr planes
// [B, H, W] u8 (which also does the JAX path's unskew_fused), and the next
// launches read their left, top, top-left and top-right neighbours from
// those planes.  Launches on one stream run in order, so wave w sees every
// MB of waves < w.  Availability comes from the parser's meta rows
// (al/at/atl/atr), as in the TPU kernel.
//
// Grid (maxw, B), 256 threads: one block per MB lane of the wave.  The
// block reads its MB's meta row and int16 coefficient slabs straight from
// the device-layout staging [B, W, S, maxw] (no feed transpose), builds
// the residual in shared memory in int32 integer arithmetic, and runs the
// prediction chain in decoding order with __syncthreads() between
// sub-blocks.  The JAX code's f32 0/1 matmuls (pixel assembly, Hadamards,
// selection matrices) are exact, so integer index maps and tap tables
// compute the same integers.  Products and left shifts wrap like JAX's
// int32 arithmetic.
//
// Bound.  A block reads its MB's meta row (160 bytes) and, for a parsed
// MB, its coefficients (luma 512, chroma 256, 24 DC rows 48: 976 bytes
// in all), and writes 384 bytes of planes; padding lanes of a wave read
// nothing.  At 1080p batch 16 (130,560 MBs) that is about 177.6 MB,
// about 0.053 ms at 3.35 TB/s.  The real limit is latency: 254 dependent
// waves at 1080p, each a launch whose blocks run a chain of up to 16
// dependent 4x4 prediction steps, so the card is far from either
// roofline.  The design keeps the chain inside one block's shared memory
// and makes no pass over device memory other than the staging reads and
// the plane writes.  The wave loop runs here in C (mvt_wave_run), so a
// batch costs the host one call; folding waves into fewer launches is
// left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int META_ROWS = 40;
constexpr int KIND_I4x4 = 0;
constexpr int KIND_I16x16 = 1;
constexpr int KIND_IPCM = 2;
constexpr int KIND_I8x8 = 3;

// meta rows (ops/slab.py)
constexpr int R_KIND = 0, R_PARSED = 1, R_AL = 2, R_AT = 3, R_ATL = 4,
              R_ATR = 5, R_I16M = 6, R_CMODE = 7, R_MODES8 = 8,
              R_MODES4 = 12, R_YM6 = 28, R_YDIV = 29, R_CBM6 = 30,
              R_CBDIV = 31, R_CRM6 = 32, R_CRDIV = 33;

// 4x4 block positions in decoding order (spec 6.4.3) and whether the
// top-right samples of block b lie inside the MB and are already decoded
__constant__ int kBlkX[16] = {0, 4, 0, 4, 8, 12, 8, 12,
                              0, 4, 0, 4, 8, 12, 8, 12};
__constant__ int kBlkY[16] = {0, 0, 4, 4, 0, 0, 4, 4,
                              8, 8, 12, 12, 8, 8, 12, 12};
__constant__ int kTrIn[16] = {0, 0, 1, 0, 0, 0, 1, 0,
                              1, 1, 1, 0, 1, 0, 1, 0};
// 4x4 Hadamard (luma DC, spec 8.5.10) and the 2x2 one as kron(H2, H2)
// over the four DC values of a chroma component (spec 8.5.11)
__constant__ int kH4[4][4] = {{1, 1, 1, 1},
                              {1, 1, -1, -1},
                              {1, -1, -1, 1},
                              {1, -1, 1, -1}};
__constant__ int kH22[4][4] = {{1, 1, 1, 1},
                               {1, -1, 1, -1},
                               {1, 1, -1, -1},
                               {1, -1, -1, 1}};

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wshl(int a, int n) {
  return (int)((unsigned)a << n);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// LevelScale entry for QP%6 = m6; 0 outside [0, 6) as in the JAX select
__device__ __forceinline__ int scale_at(const int* __restrict__ ls, int m6,
                                        int per_m6, int idx) {
  return (m6 >= 0 && m6 < 6) ? ls[m6 * per_m6 + idx] : 0;
}

// v << (div - qbits) when div >= qbits, else rounded >> (qbits - div)
__device__ __forceinline__ int dequant(int v, int div, int qbits) {
  if (div >= qbits) return wshl(v, div - qbits);
  int rnd = (1 << (qbits - 1)) >> min(div, qbits - 1);
  return wadd(v, rnd) >> (qbits - div);
}

__device__ __forceinline__ int dc_pred(int sum_l, int sum_t, int al, int at,
                                       int log2n) {
  int n = 1 << log2n;
  if (al && at) return (sum_l + sum_t + n) >> (log2n + 1);
  if (al) return (sum_l + n / 2) >> log2n;
  if (at) return (sum_t + n / 2) >> log2n;
  return 128;
}

// 4-point inverse core transform butterfly (spec 8.5.12.2)
__device__ __forceinline__ void idct4(const int* d, int* o) {
  int e0 = d[0] + d[2];
  int e1 = d[0] - d[2];
  int e2 = (d[1] >> 1) - d[3];
  int e3 = d[1] + (d[3] >> 1);
  o[0] = e0 + e3;
  o[1] = e1 + e2;
  o[2] = e1 - e2;
  o[3] = e0 - e3;
}

// 8-point inverse transform butterfly (spec 8.5.13.2)
__device__ __forceinline__ void idct8(const int* d, int* o) {
  int a0 = d[0] + d[4];
  int a4 = d[0] - d[4];
  int a2 = (d[2] >> 1) - d[6];
  int a6 = d[2] + (d[6] >> 1);
  int b0 = a0 + a6;
  int b2 = a4 + a2;
  int b4 = a4 - a2;
  int b6 = a0 - a6;
  int a1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
  int a3 = d[1] + d[7] - d[3] - (d[3] >> 1);
  int a5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
  int a7 = d[3] + d[5] + d[1] + (d[1] >> 1);
  int b1 = a1 + (a7 >> 2);
  int b7 = a7 - (a1 >> 2);
  int b3 = a3 + (a5 >> 2);
  int b5 = (a3 >> 2) - a5;
  o[0] = b0 + b7;
  o[1] = b2 + b5;
  o[2] = b4 + b3;
  o[3] = b6 + b1;
  o[4] = b6 - b1;
  o[5] = b4 - b3;
  o[6] = b2 - b5;
  o[7] = b0 - b7;
}

// directional prediction of one sample from the tap table
// (ops/predtables.py rows: idx0..2, w0..2, rnd, shift)
__device__ __forceinline__ int pred_taps(const int* __restrict__ taps,
                                         int row, const int* s) {
  const int* t = taps + row * 8;
  return (t[3] * s[t[0]] + t[4] * s[t[1]] + t[5] * s[t[2]] + t[6]) >> t[7];
}

struct Args {
  const int* meta;        // [B, W, 40, maxw] int32
  const int16_t* luma;    // [B, W, 256, maxw]
  const int16_t* chroma;  // [B, W, 128, maxw]
  const int16_t* dc;      // [B, W, 32, maxw]
  const int* ls4;         // [3, 6, 4, 4] luma/Cb/Cr LevelScale
  const int* ls8;         // [6, 8, 8]
  const int* taps4;       // [9*16, 8]
  const int* taps8;       // [9*64, 8]
  uint8_t* Y;             // [B, 16*hmb, 16*wmb]
  uint8_t* Cb;            // [B, 8*hmb, 8*wmb]
  uint8_t* Cr;
  int W, maxw, wmb, hmb, w, has8x8, haspcm;
};

__global__ void __launch_bounds__(256) wave_kernel(Args a) {
  const int t = threadIdx.x;
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = min(a.w / 2, a.hmb - 1);
  const int r = r0 - k;
  const int c = a.w - 2 * r0 + 2 * k;
  if (r < 0 || c >= a.wmb) return;       // padding lane: no MB

  const int pw = 16 * a.wmb, ph = 16 * a.hmb;
  const int cw = 8 * a.wmb, ch = 8 * a.hmb;
  uint8_t* Yp = a.Y + (size_t)b * ph * pw;
  uint8_t* Cp[2] = {a.Cb + (size_t)b * ch * cw, a.Cr + (size_t)b * ch * cw};
  const size_t slot = (size_t)b * a.W + a.w;   // (frame, wave) row

  __shared__ int m[META_ROWS];
  __shared__ int cl[256], tl[256], resl[256], tile[256];
  __shared__ int cc[128], tc[128], resc[128];
  __shared__ int dcs[24];
  __shared__ int left[16], top[16], trr[8], leftc[16], topc[16];
  __shared__ int corner, cornerc[2];
  __shared__ int refs[32];
  __shared__ int pv[4];
  __shared__ int cdc[8], cplane[6];

  if (t < META_ROWS) m[t] = a.meta[(slot * META_ROWS + t) * a.maxw + k];
  __syncthreads();

  if (m[R_PARSED] <= 0) {                  // unparsed MB: zero pixels
    Yp[(size_t)(16 * r + t / 16) * pw + 16 * c + t % 16] = 0;
    if (t < 128)
      Cp[t / 64][(size_t)(8 * r + (t / 8) % 8) * cw + 8 * c + t % 8] = 0;
    return;
  }

  const int kind = m[R_KIND];
  const int al = m[R_AL] > 0, at = m[R_AT] > 0;
  const int atl = m[R_ATL] > 0, atr = m[R_ATR] > 0;
  const int is8 = kind == KIND_I8x8 && a.has8x8;
  const int ispcm = kind == KIND_IPCM && a.haspcm;

  // ---- loads: coefficient slabs and neighbour samples --------------------
  cl[t] = a.luma[(slot * 256 + t) * a.maxw + k];
  if (t < 128) cc[t] = a.chroma[(slot * 128 + t) * a.maxw + k];
  if (t < 24) dcs[t] = a.dc[(slot * 32 + t) * a.maxw + k];
  if (t < 16) {
    left[t] = (al && c > 0) ? Yp[(size_t)(16 * r + t) * pw + 16 * c - 1] : 0;
    top[t] = (at && r > 0) ? Yp[(size_t)(16 * r - 1) * pw + 16 * c + t] : 0;
    int ic = t / 8, i = t % 8;
    leftc[t] = (al && c > 0)
        ? Cp[ic][(size_t)(8 * r + i) * cw + 8 * c - 1] : 0;
    topc[t] = (at && r > 0)
        ? Cp[ic][(size_t)(8 * r - 1) * cw + 8 * c + i] : 0;
  } else if (t < 24) {
    int i = t - 16;
    trr[i] = (atr && r > 0 && c + 1 < a.wmb)
        ? Yp[(size_t)(16 * r - 1) * pw + 16 * c + 16 + i] : 0;
  } else if (t == 24) {
    corner = (atl && r > 0 && c > 0)
        ? Yp[(size_t)(16 * r - 1) * pw + 16 * c - 1] : 0;
  } else if (t == 25 || t == 26) {
    int ic = t - 25;
    cornerc[ic] = (atl && r > 0 && c > 0)
        ? Cp[ic][(size_t)(8 * r - 1) * cw + 8 * c - 1] : 0;
  }
  __syncthreads();

  // ---- luma residual ------------------------------------------------------
  const int ym6 = m[R_YM6], ydiv = m[R_YDIV];
  if (ispcm) {
    // raw samples: pixel (Y, X) at s = 64(Y%4) + 16(X%4) + 4(Y/4) + X/4
    int Y = t / 16, X = t % 16;
    resl[t] = cl[64 * (Y % 4) + 16 * (X % 4) + 4 * (Y / 4) + X / 4];
  } else if (is8) {
    // s = 32j + 4i + blk
    int i = (t >> 2) & 7, j = t >> 5;
    tl[t] = dequant(wmul(cl[t], scale_at(a.ls8, ym6, 64, i * 8 + j)),
                    ydiv, 6);
    __syncthreads();
    if (t < 32) {                          // rows: (i, blk)
      int i2 = t >> 2, blk = t & 3, d[8], o[8];
      for (int jj = 0; jj < 8; ++jj) d[jj] = tl[32 * jj + 4 * i2 + blk];
      idct8(d, o);
      for (int x = 0; x < 8; ++x) cl[32 * x + 4 * i2 + blk] = o[x];
    }
    __syncthreads();
    if (t < 32) {                          // columns: (x, blk)
      int x = t >> 2, blk = t & 3, d[8], o[8];
      for (int ii = 0; ii < 8; ++ii) d[ii] = cl[32 * x + 4 * ii + blk];
      idct8(d, o);
      for (int y = 0; y < 8; ++y)
        resl[16 * (8 * (blk >> 1) + y) + 8 * (blk & 1) + x] =
            (o[y] + 32) >> 6;
    }
  } else {
    // s = 64j + 16i + q, q = 4u + v the block's raster position
    int i = (t >> 4) & 3, j = t >> 6;
    int sc = scale_at(a.ls4, ym6, 16, i * 4 + j);
    int d = dequant(wmul(cl[t], sc), ydiv, 4);
    if (kind == KIND_I16x16 && t < 16) {   // DC: 4x4 Hadamard + scaling
      int f = 0;
      for (int kk = 0; kk < 16; ++kk)
        f += kH4[t >> 2][kk >> 2] * kH4[t & 3][kk & 3] * dcs[kk];
      d = dequant(wmul(f, sc), ydiv, 6);
    }
    tl[t] = d;
    __syncthreads();
    if (t < 64) {                          // rows: (i, q)
      int i2 = t >> 4, q = t & 15, dd[4], o[4];
      for (int jj = 0; jj < 4; ++jj) dd[jj] = tl[64 * jj + 16 * i2 + q];
      idct4(dd, o);
      for (int x = 0; x < 4; ++x) cl[64 * x + 16 * i2 + q] = o[x];
    }
    __syncthreads();
    if (t < 64) {                          // columns: (x, q)
      int x = t >> 4, q = t & 15, dd[4], o[4];
      for (int ii = 0; ii < 4; ++ii) dd[ii] = cl[64 * x + 16 * ii + q];
      idct4(dd, o);
      for (int y = 0; y < 4; ++y)
        resl[16 * (4 * (q >> 2) + y) + 4 * (q & 3) + x] = (o[y] + 32) >> 6;
    }
  }

  // ---- chroma residual ----------------------------------------------------
  if (ispcm) {
    if (t < 128) {
      int ic = t / 64, Y = (t / 8) % 8, X = t % 8;
      resc[t] = cc[32 * (Y % 4) + 8 * (X % 4) + 4 * ic + 2 * (Y / 4) + X / 4];
    }
  } else {
    // s = 32j + 8i + 4ic + blk
    if (t < 128) {
      int ic = (t >> 2) & 1, i = (t >> 3) & 3, j = t >> 5;
      int m6 = ic ? m[R_CRM6] : m[R_CBM6];
      int div = ic ? m[R_CRDIV] : m[R_CBDIV];
      int sc = scale_at(a.ls4 + (1 + ic) * 96, m6, 16, i * 4 + j);
      int d;
      if (t < 8) {                         // DC: 2x2 Hadamard (8.5.11)
        int q = t & 3, f = 0;
        for (int kk = 0; kk < 4; ++kk)
          f += kH22[q][kk] * dcs[16 + 4 * ic + kk];
        d = wshl(wmul(f, sc), div) >> 5;
      } else {
        d = dequant(wmul(cc[t], sc), div, 4);
      }
      tc[t] = d;
    }
    __syncthreads();
    if (t < 32) {                          // rows: (i, q)
      int i2 = t >> 3, q = t & 7, dd[4], o[4];
      for (int jj = 0; jj < 4; ++jj) dd[jj] = tc[32 * jj + 8 * i2 + q];
      idct4(dd, o);
      for (int x = 0; x < 4; ++x) cc[32 * x + 8 * i2 + q] = o[x];
    }
    __syncthreads();
    if (t < 32) {                          // columns: (x, q)
      int x = t >> 3, q = t & 7, dd[4], o[4];
      for (int ii = 0; ii < 4; ++ii) dd[ii] = cc[32 * x + 8 * ii + q];
      idct4(dd, o);
      int ic = q >> 2, blk = q & 3;
      for (int y = 0; y < 4; ++y)
        resc[64 * ic + 8 * (4 * (blk >> 1) + y) + 4 * (blk & 1) + x] =
            (o[y] + 32) >> 6;
    }
  }
  tile[t] = 0;
  __syncthreads();

  // ---- luma prediction + reconstruction -----------------------------------
  if (kind == KIND_I4x4) {
    for (int blk = 0; blk < 16; ++blk) {
      const int bx = kBlkX[blk], by = kBlkY[blk];
      if (t == 0) {
        int l4[4], t4[4], tr4[4], c4, al_b, at_b, tr_b, ac_b;
        for (int y = 0; y < 4; ++y)
          l4[y] = bx == 0 ? left[by + y] : tile[(by + y) * 16 + bx - 1];
        al_b = bx == 0 ? al : 1;
        if (by == 0) {
          for (int x = 0; x < 4; ++x) t4[x] = top[bx + x];
          at_b = at;
          if (bx < 12) {
            for (int x = 0; x < 4; ++x) tr4[x] = top[bx + 4 + x];
            tr_b = at;
          } else {
            for (int x = 0; x < 4; ++x) tr4[x] = trr[x];
            tr_b = atr;
          }
          c4 = bx == 0 ? corner : top[bx - 1];
          ac_b = bx == 0 ? atl : at;
        } else {
          const int* row = tile + (by - 1) * 16;
          for (int x = 0; x < 4; ++x) t4[x] = row[bx + x];
          at_b = 1;
          tr_b = kTrIn[blk];
          for (int x = 0; x < 4; ++x) tr4[x] = tr_b ? row[bx + 4 + x] : 0;
          c4 = bx == 0 ? left[by - 1] : row[bx - 1];
          ac_b = bx == 0 ? al : 1;
        }
        int sl = 0, st = 0;
        for (int x = 0; x < 4; ++x) {
          l4[x] = al_b ? l4[x] : 0;
          t4[x] = at_b ? t4[x] : 0;
        }
        for (int x = 0; x < 4; ++x) {
          tr4[x] = tr_b ? tr4[x] : t4[3];
          tr4[x] = at_b ? tr4[x] : 0;
          sl += l4[x];
          st += t4[x];
        }
        refs[0] = ac_b ? c4 : 0;
        for (int x = 0; x < 4; ++x) {
          refs[1 + x] = t4[x];
          refs[5 + x] = tr4[x];
          refs[9 + x] = l4[x];
        }
        pv[0] = dc_pred(sl, st, al_b, at_b, 2);
      }
      __syncthreads();
      if (t < 16) {
        const int y = t >> 2, x = t & 3, mode = m[R_MODES4 + blk];
        int p = mode == 2 ? pv[0]
              : (mode >= 0 && mode <= 8)
                  ? pred_taps(a.taps4, mode * 16 + t, refs) : 0;
        const int o = (by + y) * 16 + bx + x;
        tile[o] = clip255(p + resl[o]);
      }
      __syncthreads();
    }
  } else if (is8) {
    for (int b8 = 0; b8 < 4; ++b8) {
      const int bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
      if (t == 0) {
        int l8[8], t16[16], c8, al_b, at_b, tr_b, ac_b;
        for (int y = 0; y < 8; ++y)
          l8[y] = bx == 0 ? left[by + y] : tile[(by + y) * 16 + bx - 1];
        al_b = bx == 0 ? al : 1;
        if (by == 0) {
          for (int x = 0; x < 8; ++x) t16[x] = top[bx + x];
          at_b = at;
          if (bx == 0) {
            for (int x = 0; x < 8; ++x) t16[8 + x] = top[8 + x];
            tr_b = at;
            c8 = corner;
            ac_b = atl;
          } else {
            for (int x = 0; x < 8; ++x) t16[8 + x] = trr[x];
            tr_b = atr;
            c8 = top[bx - 1];
            ac_b = at;
          }
        } else {
          const int* row = tile + (by - 1) * 16;
          for (int x = 0; x < 8; ++x) t16[x] = row[bx + x];
          at_b = 1;
          tr_b = b8 == 2;
          for (int x = 0; x < 8; ++x) t16[8 + x] = tr_b ? row[8 + x] : 0;
          c8 = bx == 0 ? left[by - 1] : row[bx - 1];
          ac_b = bx == 0 ? al : 1;
        }
        for (int x = 0; x < 8; ++x) {
          l8[x] = al_b ? l8[x] : 0;
          t16[x] = at_b ? t16[x] : 0;
        }
        for (int x = 8; x < 16; ++x) {
          t16[x] = tr_b ? t16[x] : t16[7];
          t16[x] = at_b ? t16[x] : 0;
        }
        c8 = ac_b ? c8 : 0;
        // reference sample filtering (spec 8.3.2.2.1)
        int ft[16], fl[8], fc;
        ft[0] = ac_b ? (c8 + 2 * t16[0] + t16[1] + 2) >> 2
                     : (3 * t16[0] + t16[1] + 2) >> 2;
        for (int x = 1; x < 15; ++x)
          ft[x] = (t16[x - 1] + 2 * t16[x] + t16[x + 1] + 2) >> 2;
        ft[15] = (t16[14] + 3 * t16[15] + 2) >> 2;
        if (!at_b)
          for (int x = 0; x < 16; ++x) ft[x] = t16[x];
        if (at_b && al_b) fc = (t16[0] + 2 * c8 + l8[0] + 2) >> 2;
        else if (at_b) fc = (3 * c8 + t16[0] + 2) >> 2;
        else if (al_b) fc = (3 * c8 + l8[0] + 2) >> 2;
        else fc = c8;
        if (!ac_b) fc = c8;
        fl[0] = ac_b ? (c8 + 2 * l8[0] + l8[1] + 2) >> 2
                     : (3 * l8[0] + l8[1] + 2) >> 2;
        for (int y = 1; y < 7; ++y)
          fl[y] = (l8[y - 1] + 2 * l8[y] + l8[y + 1] + 2) >> 2;
        fl[7] = (l8[6] + 3 * l8[7] + 2) >> 2;
        if (!al_b)
          for (int y = 0; y < 8; ++y) fl[y] = l8[y];
        int sl = 0, st = 0;
        refs[0] = fc;
        for (int x = 0; x < 16; ++x) refs[1 + x] = ft[x];
        for (int y = 0; y < 8; ++y) {
          refs[17 + y] = fl[y];
          sl += fl[y];
          st += ft[y];
        }
        pv[0] = dc_pred(sl, st, al_b, at_b, 3);
      }
      __syncthreads();
      if (t < 64) {
        const int y = t >> 3, x = t & 7, mode = m[R_MODES8 + b8];
        int p = mode == 2 ? pv[0]
              : (mode >= 0 && mode <= 8)
                  ? pred_taps(a.taps8, mode * 64 + t, refs) : 0;
        const int o = (by + y) * 16 + bx + x;
        tile[o] = clip255(p + resl[o]);
      }
      __syncthreads();
    }
  } else if (kind == KIND_I16x16 || ispcm) {
    const int mode = m[R_I16M];
    if (t == 0) {
      int sl = 0, st = 0, acc_h = 0, acc_v = 0;
      for (int i = 0; i < 16; ++i) {
        sl += left[i];
        st += top[i];
      }
      for (int x = 0; x < 8; ++x) {
        int lo_t = x == 7 ? corner : top[6 - x];
        int lo_l = x == 7 ? corner : left[6 - x];
        acc_h += (x + 1) * (top[8 + x] - lo_t);
        acc_v += (x + 1) * (left[8 + x] - lo_l);
      }
      pv[0] = dc_pred(sl, st, al, at, 4);
      pv[1] = 16 * (left[15] + top[15]);
      pv[2] = (5 * acc_h + 32) >> 6;
      pv[3] = (5 * acc_v + 32) >> 6;
    }
    __syncthreads();
    const int y = t >> 4, x = t & 15;
    int p;
    if (ispcm) p = 0;
    else if (mode == 0) p = top[x];
    else if (mode == 1) p = left[y];
    else if (mode == 2) p = pv[0];
    else p = clip255((pv[1] + pv[2] * (x - 7) + pv[3] * (y - 7) + 16) >> 5);
    tile[t] = clip255(p + resl[t]);
  }

  // ---- chroma prediction + reconstruction ---------------------------------
  __syncthreads();
  if (t < 2) {
    const int ic = t;
    const int* lc = leftc + 8 * ic;
    const int* tcs = topc + 8 * ic;
    int st0 = 0, st1 = 0, sl0 = 0, sl1 = 0, acc_h = 0, acc_v = 0;
    for (int i = 0; i < 4; ++i) {
      st0 += tcs[i];
      st1 += tcs[4 + i];
      sl0 += lc[i];
      sl1 += lc[4 + i];
    }
    const int both0 = (st0 + sl0 + 4) >> 3, both1 = (st1 + sl1 + 4) >> 3;
    const int t0 = (st0 + 2) >> 2, t1 = (st1 + 2) >> 2;
    const int l0 = (sl0 + 2) >> 2, l1 = (sl1 + 2) >> 2;
    // quadrants: 00 prefers both, 01 top, 10 left, 11 both
    cdc[4 * ic + 0] = (al && at) ? both0 : at ? t0 : al ? l0 : 128;
    cdc[4 * ic + 1] = at ? t1 : al ? l0 : 128;
    cdc[4 * ic + 2] = al ? l1 : at ? t0 : 128;
    cdc[4 * ic + 3] = (al && at) ? both1 : at ? t1 : al ? l1 : 128;
    const int cr = cornerc[ic];
    for (int x = 0; x < 4; ++x) {
      int lo_t = x == 3 ? cr : tcs[2 - x];
      int lo_l = x == 3 ? cr : lc[2 - x];
      acc_h += (x + 1) * (tcs[4 + x] - lo_t);
      acc_v += (x + 1) * (lc[4 + x] - lo_l);
    }
    cplane[3 * ic + 0] = 16 * (lc[7] + tcs[7]);
    cplane[3 * ic + 1] = (17 * acc_h + 16) >> 5;
    cplane[3 * ic + 2] = (17 * acc_v + 16) >> 5;
  }
  __syncthreads();
  if (t < 128) {
    const int ic = t >> 6, y = (t >> 3) & 7, x = t & 7;
    const int cmode = m[R_CMODE];
    int p;
    if (ispcm) p = 0;
    else if (cmode == 0) p = cdc[4 * ic + 2 * (y >> 2) + (x >> 2)];
    else if (cmode == 1) p = leftc[8 * ic + y];
    else if (cmode == 2) p = topc[8 * ic + x];
    else p = clip255((cplane[3 * ic] + cplane[3 * ic + 1] * (x - 3)
                      + cplane[3 * ic + 2] * (y - 3) + 16) >> 5);
    Cp[ic][(size_t)(8 * r + y) * cw + 8 * c + x] =
        (uint8_t)clip255(p + resc[t]);
  }
  Yp[(size_t)(16 * r + t / 16) * pw + 16 * c + t % 16] = (uint8_t)tile[t];
}

}  // namespace

// Launch waves 0..W-1 in order on `stream`; returns the first launch
// error (cudaGetLastError), or 0 when all W launches were made.
extern "C" int mvt_wave_run(
    const void* meta, const void* luma, const void* chroma, const void* dc,
    const void* ls4, const void* ls8, const void* taps4, const void* taps8,
    void* Y, void* Cb, void* Cr, int B, int W, int maxw, int wmb, int hmb,
    int has8x8, int haspcm, void* stream) {
  Args a;
  a.meta = (const int*)meta;
  a.luma = (const int16_t*)luma;
  a.chroma = (const int16_t*)chroma;
  a.dc = (const int16_t*)dc;
  a.ls4 = (const int*)ls4;
  a.ls8 = (const int*)ls8;
  a.taps4 = (const int*)taps4;
  a.taps8 = (const int*)taps8;
  a.Y = (uint8_t*)Y;
  a.Cb = (uint8_t*)Cb;
  a.Cr = (uint8_t*)Cr;
  a.W = W;
  a.maxw = maxw;
  a.wmb = wmb;
  a.hmb = hmb;
  a.has8x8 = has8x8;
  a.haspcm = haspcm;
  for (int w = 0; w < W; ++w) {
    a.w = w;
    wave_kernel<<<dim3(maxw, B), 256, 0, (cudaStream_t)stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
