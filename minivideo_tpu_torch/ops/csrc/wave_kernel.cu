// Fused wavefront intra reconstruction of H.264 I pictures on Hopper.
//
// Replaces the TPU kernel minivideo_tpu/ops/recon_fused.py::_wave_kernel
// (the Pallas kernel built by _build_kernel).  It computes dequant,
// 4x4/8x8 IDCT, I16x16 and chroma DC Hadamards, PCM pass-through
// (ops/slab.residual_from_slabs), then I4x4, I8x8 (with reference
// filtering), I16x16 and chroma prediction, reconstruction and clipping to
// u8 (ops/recon_lane.wave_compute_lane), and writes raster Y/Cb/Cr planes
// [B, H, W] u8 (which also does the JAX path's unskew_fused).
//
// Schedule.  One persistent launch per batch, one block per (frame, MB
// row).  A block takes its row from an atomic ticket t (r = t / B,
// b = t % B), so every row it waits on was claimed earlier by a block that
// is already running: the launch cannot deadlock for any B or any number
// of resident blocks.  The block walks its row left to right.  Before
// MB (r, c) it waits until progress[b][r-1] >= min(c + 2, wmb) (top,
// top-right and top-left neighbours written), and after writing the MB it
// publishes progress[b][r] = c + 1 (each writing lane fences, the warp
// syncs, one lane stores with release semantics).  Neighbour pixels of the
// row above are read with ld.global.cg: L1 is not coherent between SMs,
// and an earlier top-right read may have pulled into L1 a line that holds
// pixels written later.  The left column is kept in shared memory: the
// block decoded it itself.  Every spin-wait is bounded (~1 s of clock64);
// on timeout the kernel sets the error word and stops waiting, and the
// wrapper raises.  MB (r, c) sits at staging slot w = 2r + c,
// k = min(w / 2, hmb - 1) - r.
//
// Roles.  A block is three warps.  Two producer warps, taking alternate
// MBs, run up to STAGES MBs ahead along the row: each loads its MB's meta
// row and int16 coefficient slabs (read-only loads), computes the
// residual (dequant, Hadamards, IDCTs, PCM) and hands it to the consumer
// through a ring of STAGES shared-memory stages guarded by named barriers
// (full/empty per stage).  The consumer warp runs only the dependent
// part: the wait, the neighbour reads, prediction, reconstruction, the
// plane writes and the publish.  It builds each MB in a shared-memory
// byte image that carries the MB's neighbours, so every reference is one
// load at an offset each lane computes.  The chain is spread over the
// warp: an I4x4 MB takes 10 steps of up to two 4x4 blocks (block (i, j)
// needs only blocks of earlier steps 2i + j), an I8x8 MB 4 steps whose
// reference filter takes its taps by shuffles; DC sums are warp
// reductions, I16x16 and chroma DC and plane sums byte dot products
// (dp4a), the directional taps read the references by shuffles from a
// byte tap table in shared memory; __syncwarp() orders the chain.  Luma
// rows leave as 16-byte stores, chroma rows as 8-byte stores.
//
// Exactness.  The JAX code's f32 0/1 matmuls (pixel assembly, Hadamards,
// selection matrices) are exact, so integer index maps and tap tables
// compute the same integers.  Products and left shifts wrap like JAX's
// int32 arithmetic.  No float anywhere.
//
// Bound.  A decoded MB reads its meta row (160 bytes), its coefficients
// (luma 512, chroma 256, 24 DC rows 48: 976 bytes with the meta) and
// writes 384 bytes of planes; an unparsed MB reads its meta only.  At
// 1080p batch 16 (130,560 MBs) that is 177.6 MB, 0.0530 ms at 3.35 TB/s.
// The real limit is latency: a frame's critical path is 2 * hmb + wmb - 2
// dependent MB steps (254 at 1080p), and nothing shortens it.  What the
// design cuts is the cost of a step, against the launch-per-wave kernel
// it replaces: (1) no launch and no grid-wide barrier per wave, only a
// flag handoff between two blocks; (2) no single thread builds the
// references while the rest wait; (3) the residual leaves the critical
// path (producer warp); (4) only the row above is read from device memory
// (L2), the left column stays in shared memory; (5) each warp has work
// that fits 32 lanes, and the register budget keeps 4 blocks on each SM
// (528 of a 1080p batch's 1,088 rows at once).  Tensor cores do not
// apply: every transform is an exact integer 4- or 8-point butterfly with
// floor shifts between stages, and no product is large enough to fill a
// wgmma tile.  TMA does not apply either: the staging puts one MB's
// values at a stride of maxw elements, so there is no contiguous tile to
// copy; the producers running ahead play the part of the asynchronous
// copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// MVT_PHASES (ops/wave_phases.py) records clock64() at marks 0-7 of each
// MB's consumer and 11-14 of its producer, and the MB kind at 10, into
// phases[B, hmb, wmb, 16] (int64); without it the marks compile to nothing
#ifdef MVT_PHASES
__device__ long long* g_phases;
#define PHASES_AT(a, b, r, c)                                              \
  long long* ph = g_phases ? g_phases + ((((size_t)(b) * (a).hmb + (r))  \
                                          * (a).wmb + (c)) * 16) : nullptr
#define PHASE(i, v) if (lane == 0 && ph) ph[i] = (v)
#else
#define PHASES_AT(a, b, r, c)
#define PHASE(i, v)
#endif

// MVT_HOLD_ROW (tests/test_torch_gpu_bench.py) holds frame 0's row 0
// before its first publish for twice the wait bound, so that row 1's wait
// for it times out: the error word is set and check_waits() must raise

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

// Producer warps and the blocks that must fit on one SM (which sets the
// register budget: 65,536 / (4 blocks * 96 threads) = 170 a thread).  On
// the H100 with the 1080p batch of 16, one producer warp, or 6 blocks with
// fewer registers, ran slower (PERF.md).
constexpr int PRODUCERS = 2;
constexpr int MIN_BLOCKS = 4;
constexpr int THREADS = 32 * (1 + PRODUCERS);   // warp 0 is the consumer
constexpr int STAGES = 4;           // residual ring depth
// producer p fills the stages s with s % PRODUCERS == p (see producer())
static_assert(STAGES % PRODUCERS == 0, "STAGES must be a multiple of "
              "PRODUCERS");
constexpr int BAR_FULL = 1;         // named barrier ids (0 is syncthreads)
constexpr int BAR_EMPTY = BAR_FULL + STAGES;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long TIMEOUT_CYCLES = 2000000000LL;   // ~1 s at ~1.8 GHz
constexpr int ERR_TIMEOUT = 1;

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
  return (m6 >= 0 && m6 < 6) ? __ldg(ls + m6 * per_m6 + idx) : 0;
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

// directional prediction of one sample from a tap-table row
// (ops/predtables.py: idx0..2, w0..2, rnd, shift, one byte each); the
// reference vector s lies across lanes base.. of the warp (s[i] on lane
// base + i), so every lane of the warp must call this together
__device__ __forceinline__ int pred_taps(const uint2 t, int s, int base) {
  const int s0 = __shfl_sync(FULL, s, base + (t.x & 0xff));
  const int s1 = __shfl_sync(FULL, s, base + ((t.x >> 8) & 0xff));
  const int s2 = __shfl_sync(FULL, s, base + ((t.x >> 16) & 0xff));
  const int w0 = t.x >> 24, w1 = t.y & 0xff, w2 = (t.y >> 8) & 0xff;
  const int rnd = (t.y >> 16) & 0xff, shift = t.y >> 24;
  return (w0 * s0 + w1 * s1 + w2 * s2 + rnd) >> shift;
}

// ---- synchronisation -------------------------------------------------------

// named barriers between the consumer warp and one producer warp (the
// non-aligned forms, which do not need the warp converged)
constexpr int BAR_THREADS = 64;
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "n"(BAR_THREADS)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "n"(BAR_THREADS)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               ::"l"(p), "r"(v) : "memory");
}

// Spin (one lane) until *p >= target; returns the last value read.  Gives
// up once another block has set the error word, or after TIMEOUT_CYCLES,
// when it sets the error word itself.
__device__ int wait_at_least(const int* p, int target, int* err) {
  const long long t0 = clock64();
  for (int i = 1;; ++i) {
    const int v = ld_acquire(p);
    if (v >= target) return v;
    if (i % 64 == 0) {
      if (ld_relaxed(err) != 0) return v;
      if (clock64() - t0 > TIMEOUT_CYCLES) {
        atomicOr(err, ERR_TIMEOUT);
        return v;
      }
    }
  }
}

struct Args {
  const int* meta;        // [B, W, 40, maxw] int32
  const int16_t* luma;    // [B, W, 256, maxw]
  const int16_t* chroma;  // [B, W, 128, maxw]
  const int16_t* dc;      // [B, W, 32, maxw]
  const int* ls4;         // [3, 6, 4, 4] luma/Cb/Cr LevelScale
  const int* ls8;         // [6, 8, 8]
  const uint8_t* taps4;   // [9*16, 8] bytes
  const uint8_t* taps8;   // [9*64, 8] bytes
  uint8_t* Y;             // [B, 16*hmb, 16*wmb]
  uint8_t* Cb;            // [B, 8*hmb, 8*wmb]
  uint8_t* Cr;
  int* ctr;               // [B*hmb] progress, then ticket, then error word
  int B, W, maxw, wmb, hmb, has8x8, haspcm;
};

// one MB's residual, handed from a producer to the consumer
struct Stage {
  int meta[META_ROWS];
  int resl[256];          // luma residual, raster 16x16
  int resc[128];          // Cb then Cr residual, raster 8x8 each
};

// a producer warp's working copy of one MB's coefficients
struct Scratch {
  int sl[256], sc[128], dcs[24];
};

// The consumer builds each MB inside a byte image that carries its
// neighbours: luma rows 1..16 hold the MB at columns 16..31, column 15
// the left neighbours, row 0 the row above (corner at 15, top at 16..31,
// top-right at 32..39); chroma likewise with pitch 16 (row 0: corner at
// 7, top at 8..15; the MB at columns 8..15).  Every reference of a 4x4 or
// 8x8 prediction step is then one load at an offset that each lane
// computes.  The left columns are also kept packed (yl, cl) for the byte
// dot products of the DC and plane sums.
constexpr int YP = 48, CPITCH = 16;
constexpr int TAP4_BYTES = 9 * 16 * 8, TAP8_BYTES = 9 * 64 * 8;

struct Smem {
  Stage st[STAGES];
  Scratch work[PRODUCERS];
  alignas(16) uint8_t tap4[TAP4_BYTES];
  alignas(16) uint8_t tap8[TAP8_BYTES];
  alignas(16) uint8_t yi[17 * YP];
  alignas(16) uint8_t ci[2][9 * CPITCH];
  alignas(16) uint8_t yl[16];      // the MB's left neighbours, gated
  alignas(8) uint8_t cl[2][8];
  uint8_t lcol[16], lcolc[16];     // raw right column of the previous MB
  int ticket;
};

// ---- producer: residual of one MB ------------------------------------------

__device__ void produce(const Args& a, Scratch& w, Stage& S, size_t slot,
                        int k, int lane) {
  const int* m = S.meta;
  const int kind = m[R_KIND];
  const int is8 = kind == KIND_I8x8 && a.has8x8;
  const int ispcm = kind == KIND_IPCM && a.haspcm;
  const size_t mw = a.maxw;
  const int16_t* lp = a.luma + slot * 256 * mw + k;
  const int16_t* cp = a.chroma + slot * 128 * mw + k;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w.sl[lane + 32 * i] = __ldg(lp + (lane + 32 * i) * mw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w.sc[lane + 32 * i] = __ldg(cp + (lane + 32 * i) * mw);
  if (lane < 24) w.dcs[lane] = __ldg(a.dc + (slot * 32 + lane) * mw + k);
  __syncwarp();

  // ---- luma ----
  int* cl = w.sl;
  const int ym6 = m[R_YM6], ydiv = m[R_YDIV];
  if (ispcm) {
    // raw samples: pixel (Y, X) at s = 64(Y%4) + 16(X%4) + 4(Y/4) + X/4
    for (int t = lane; t < 256; t += 32) {
      int Y = t / 16, X = t % 16;
      S.resl[t] = cl[64 * (Y % 4) + 16 * (X % 4) + 4 * (Y / 4) + X / 4];
    }
  } else if (is8) {
    // s = 32j + 4i + blk; dequant in place, one element per thread
    for (int t = lane; t < 256; t += 32) {
      int i = (t >> 2) & 7, j = t >> 5;
      cl[t] = dequant(wmul(cl[t], scale_at(a.ls8, ym6, 64, i * 8 + j)),
                      ydiv, 6);
    }
    __syncwarp();
    {                                      // rows: (i, blk), in place
      int i2 = lane >> 2, blk = lane & 3, d[8], o[8];
      for (int jj = 0; jj < 8; ++jj) d[jj] = cl[32 * jj + 4 * i2 + blk];
      idct8(d, o);
      for (int x = 0; x < 8; ++x) cl[32 * x + 4 * i2 + blk] = o[x];
    }
    __syncwarp();
    {                                      // columns: (x, blk)
      int x = lane >> 2, blk = lane & 3, d[8], o[8];
      for (int ii = 0; ii < 8; ++ii) d[ii] = cl[32 * x + 4 * ii + blk];
      idct8(d, o);
      for (int y = 0; y < 8; ++y)
        S.resl[16 * (8 * (blk >> 1) + y) + 8 * (blk & 1) + x] =
            (o[y] + 32) >> 6;
    }
  } else {
    // s = 64j + 16i + q, q = 4u + v the block's raster position
    for (int t = lane; t < 256; t += 32) {
      int i = (t >> 4) & 3, j = t >> 6;
      int sc = scale_at(a.ls4, ym6, 16, i * 4 + j);
      int d = dequant(wmul(cl[t], sc), ydiv, 4);
      if (kind == KIND_I16x16 && t < 16) {   // DC: 4x4 Hadamard + scaling
        int f = 0;
        for (int kk = 0; kk < 16; ++kk)
          f += kH4[t >> 2][kk >> 2] * kH4[t & 3][kk & 3] * w.dcs[kk];
        d = dequant(wmul(f, sc), ydiv, 6);
      }
      cl[t] = d;
    }
    __syncwarp();
    for (int task = lane; task < 64; task += 32) {   // rows: (i, q)
      int i2 = task >> 4, q = task & 15, dd[4], o[4];
      for (int jj = 0; jj < 4; ++jj) dd[jj] = cl[64 * jj + 16 * i2 + q];
      idct4(dd, o);
      for (int x = 0; x < 4; ++x) cl[64 * x + 16 * i2 + q] = o[x];
    }
    __syncwarp();
    for (int task = lane; task < 64; task += 32) {   // columns: (x, q)
      int x = task >> 4, q = task & 15, dd[4], o[4];
      for (int ii = 0; ii < 4; ++ii) dd[ii] = cl[64 * x + 16 * ii + q];
      idct4(dd, o);
      for (int y = 0; y < 4; ++y)
        S.resl[16 * (4 * (q >> 2) + y) + 4 * (q & 3) + x] = (o[y] + 32) >> 6;
    }
  }

  // ---- chroma ----
  int* cc = w.sc;
  if (ispcm) {
    for (int t = lane; t < 128; t += 32) {
      int ic = t / 64, Y = (t / 8) % 8, X = t % 8;
      S.resc[t] =
          cc[32 * (Y % 4) + 8 * (X % 4) + 4 * ic + 2 * (Y / 4) + X / 4];
    }
  } else {
    // s = 32j + 8i + 4ic + blk; dequant in place
    for (int t = lane; t < 128; t += 32) {
      int ic = (t >> 2) & 1, i = (t >> 3) & 3, j = t >> 5;
      int m6 = ic ? m[R_CRM6] : m[R_CBM6];
      int div = ic ? m[R_CRDIV] : m[R_CBDIV];
      int sc = scale_at(a.ls4 + (1 + ic) * 96, m6, 16, i * 4 + j);
      int d;
      if (t < 8) {                         // DC: 2x2 Hadamard (8.5.11)
        int q = t & 3, f = 0;
        for (int kk = 0; kk < 4; ++kk)
          f += kH22[q][kk] * w.dcs[16 + 4 * ic + kk];
        d = wshl(wmul(f, sc), div) >> 5;
      } else {
        d = dequant(wmul(cc[t], sc), div, 4);
      }
      cc[t] = d;
    }
    __syncwarp();
    {                                      // rows: (i, q), in place
      int i2 = lane >> 3, q = lane & 7, dd[4], o[4];
      for (int jj = 0; jj < 4; ++jj) dd[jj] = cc[32 * jj + 8 * i2 + q];
      idct4(dd, o);
      for (int x = 0; x < 4; ++x) cc[32 * x + 8 * i2 + q] = o[x];
    }
    __syncwarp();
    {                                      // columns: (x, q)
      int x = lane >> 3, q = lane & 7, dd[4], o[4];
      for (int ii = 0; ii < 4; ++ii) dd[ii] = cc[32 * x + 8 * ii + q];
      idct4(dd, o);
      int ic = q >> 2, blk = q & 3;
      for (int y = 0; y < 4; ++y)
        S.resc[64 * ic + 8 * (4 * (blk >> 1) + y) + 4 * (blk & 1) + x] =
            (o[y] + 32) >> 6;
    }
  }
}

// producer warp p handles MBs c = p, p + PRODUCERS, ...; STAGES is a
// multiple of PRODUCERS, so each stage always has the same producer
__device__ void producer(const Args& a, Smem& sm, int b, int r, int p,
                         int lane) {
  Scratch& w = sm.work[p];
  for (int c = p; c < a.wmb; c += PRODUCERS) {
    const int s = c % STAGES;
    PHASES_AT(a, b, r, c);
    PHASE(11, clock64());
    if (c >= STAGES) bar_sync(BAR_EMPTY + s);
    PHASE(12, clock64());
    Stage& S = sm.st[s];
    const int wv = 2 * r + c;
    const int k = min(wv / 2, a.hmb - 1) - r;
    const size_t slot = (size_t)b * a.W + wv;
    for (int i = lane; i < META_ROWS; i += 32)
      S.meta[i] = __ldg(a.meta + (slot * META_ROWS + i) * a.maxw + k);
    __syncwarp();
    PHASE(13, clock64());
    if (S.meta[R_PARSED] > 0) produce(a, w, S, slot, k, lane);
    PHASE(14, clock64());
    __syncwarp();
    bar_arrive(BAR_FULL + s);
  }
}

// ---- consumer: prediction chain of one MB ----------------------------------

// 4x4 block positions in decoding order (spec 6.4.3) and whether the
// top-right samples of block b lie inside the MB and are already decoded.
// The I4x4 schedule computes both (blk_of, kTrInMask); the tables check
// it when this file compiles.
constexpr int kBlkX[16] = {0, 4, 0, 4, 8, 12, 8, 12,
                           0, 4, 0, 4, 8, 12, 8, 12};
constexpr int kBlkY[16] = {0, 0, 4, 4, 0, 0, 4, 4,
                           8, 8, 12, 12, 8, 8, 12, 12};
constexpr int kTrIn[16] = {0, 0, 1, 0, 0, 0, 1, 0,
                           1, 1, 1, 0, 1, 0, 1, 0};
constexpr int kTrInMask = 0x5744;   // kTrIn as bits

// decoding-order index of the 4x4 block in row i, column j of the MB
__host__ __device__ constexpr int blk_of(int i, int j) {
  return 8 * (i >> 1) + 4 * (j >> 1) + 2 * (i & 1) + (j & 1);
}

constexpr bool schedule_matches_tables() {
  for (int b = 0; b < 16; ++b)
    if (blk_of(kBlkY[b] / 4, kBlkX[b] / 4) != b
        || ((kTrInMask >> b) & 1) != kTrIn[b])
      return false;
  return true;
}
static_assert(schedule_matches_tables(),
              "blk_of / kTrInMask disagree with the block tables");

// I4x4: the 16 4x4 blocks in 10 dependent steps.  Block (i, j) (row i,
// column j of the MB's 4x4 grid) needs only blocks of earlier steps
// w = 2i + j (its left, top, top-left and top-right neighbours), so each
// step predicts up to two blocks, one per half-warp.  In a half, lane
// h < 13 loads reference s[h] of s = [corner, top 0..7, left 0..3] (with
// the availability rules of spec 8.3.1.2) and lane h predicts pixel h.
__device__ __forceinline__ void luma_i4x4(Smem& sm, const int* m, int al,
                                          int at, int atl, int atr,
                                          const int* resl, int lane) {
  const int h = lane >> 4, hl = lane & 15, y = hl >> 2, x = hl & 3;
#pragma unroll
  for (int w = 0; w < 10; ++w) {
    // the first half takes block (0, w) for w < 4, then (w/2 - 1,
    // 2 + w%2); the second half block (w/2, w%2) for 2 <= w < 8
    const int on = h == 0 || (w >= 2 && w < 8);
    const int bi = h ? w >> 1 : w < 4 ? 0 : (w >> 1) - 1;
    const int bj = h ? w & 1 : w < 4 ? w : 2 + (w & 1);
    const int blk = blk_of(bi, bj);
    const int tr_in = (kTrInMask >> blk) & 1;
    const int bx = 4 * bj, by = 4 * bi;
    const int al_b = bj == 0 ? al : 1;
    const int at_b = bi == 0 ? at : 1;
    const int tr_b = bi == 0 ? (bj < 3 ? at : atr) : tr_in;
    const int ac_b = bi == 0 ? (bj == 0 ? atl : at) : (bj == 0 ? al : 1);
    const int mode = m[R_MODES4 + blk];
    const int o = (by + y) * 16 + bx + x;
    const int res = resl[o];
    const int dir = mode >= 0 && mode <= 8 && mode != 2;
    const uint2 tap = dir ? *reinterpret_cast<const uint2*>(
                                sm.tap4 + (mode * 16 + hl) * 8)
                          : make_uint2(0, 0);
    int off = 0, use = 0;
    if (hl == 0) {
      off = by * YP + 15 + bx;
      use = ac_b;
    } else if (hl <= 4) {
      off = by * YP + 15 + bx + hl;
      use = at_b;
    } else if (hl <= 8) {                  // top-right, else top[3]
      off = tr_b ? by * YP + 15 + bx + hl : by * YP + 19 + bx;
      use = at_b;
    } else if (hl <= 12) {
      off = (by + hl - 8) * YP + 15 + bx;
      use = al_b;
    }
    const int ref = use && on ? sm.yi[off] : 0;
    // DC: the top and left sums of both halves, each half in 16 bits
    const int sh = 16 * h;
    const int st = __reduce_add_sync(FULL, hl >= 1 && hl <= 4 ? ref << sh
                                                               : 0);
    const int sl = __reduce_add_sync(FULL, hl >= 9 && hl <= 12 ? ref << sh
                                                                : 0);
    const int pt = pred_taps(tap, ref, h << 4);    // every lane shuffles
    const int p = mode == 2 ? dc_pred((sl >> sh) & 0xffff,
                                      (st >> sh) & 0xffff, al_b, at_b, 2)
                  : dir ? pt : 0;
    if (on) sm.yi[(by + y + 1) * YP + 16 + bx + x] = (uint8_t)clip255(p + res);
    __syncwarp();
  }
}

// I8x8: 4 dependent 8x8 steps; lane j < 25 holds reference s[j] of
// s = [corner, top 0..15, left 0..7], filtered with its neighbours' taps
// by shuffles (spec 8.3.2.2.1); two pixels per lane
__device__ __forceinline__ void luma_i8x8(Smem& sm, const int* m, int al,
                                          int at, int atl, int atr,
                                          const int* resl, int lane) {
  const int y = lane >> 3, x = lane & 7;
  // neighbours in s: the corner's are top[0] and left[0]; left[0]'s
  // upper neighbour is the corner
  const int srcA = lane == 0 ? 1 : lane == 17 ? 0 : lane - 1;
  const int srcB = lane == 0 ? 17 : (lane + 1) & 31;
  const int is_c = lane == 0;
  const int is_t = lane >= 1 && lane <= 16, is_l = lane >= 17 && lane <= 24;
  const int first = lane == 1 || lane == 17, last = lane == 16 || lane == 24;
#pragma unroll
  for (int b8 = 0; b8 < 4; ++b8) {
    const int bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
    const int al_b = bx == 0 ? al : 1;
    const int at_b = by == 0 ? at : 1;
    const int tr_b = by == 0 ? (bx == 0 ? at : atr) : b8 == 2;
    const int ac_b = by == 0 ? (bx == 0 ? atl : at) : (bx == 0 ? al : 1);
    const int mode = m[R_MODES8 + b8];
    const int dir = mode >= 0 && mode <= 8 && mode != 2;
    const uint2 tap0 = dir ? *reinterpret_cast<const uint2*>(
                                 sm.tap8 + (mode * 64 + lane) * 8)
                           : make_uint2(0, 0);
    const uint2 tap1 = dir ? *reinterpret_cast<const uint2*>(
                                 sm.tap8 + (mode * 64 + lane + 32) * 8)
                           : make_uint2(0, 0);
    const int o0 = (by + y) * 16 + bx + x, o1 = o0 + 4 * 16;
    const int res0 = resl[o0], res1 = resl[o1];
    int off = 0, use = 0;
    if (lane == 0) {
      off = by * YP + 15 + bx;
      use = ac_b;
    } else if (lane <= 8) {
      off = by * YP + 15 + bx + lane;
      use = at_b;
    } else if (lane <= 16) {               // top-right, else top[7]
      off = tr_b ? by * YP + 15 + bx + lane : by * YP + 23 + bx;
      use = at_b;
    } else if (lane <= 24) {
      off = (by + lane - 16) * YP + 15 + bx;
      use = al_b;
    }
    const int R = use ? sm.yi[off] : 0;
    const int A = __shfl_sync(FULL, R, srcA);
    const int Bn = __shfl_sync(FULL, R, srcB);
    // filtered references, every case computed and one selected
    const int mid = (A + 2 * R + Bn + 2) >> 2;
    const int edge0 = ac_b ? mid : (3 * R + Bn + 2) >> 2;
    const int edge1 = (A + 3 * R + 2) >> 2;
    const int corner = !ac_b ? R
                       : (at_b && al_b) ? mid
                       : at_b ? (3 * R + A + 2) >> 2
                       : al_b ? (3 * R + Bn + 2) >> 2 : R;
    const int side = first ? edge0 : last ? edge1 : mid;
    const int F = is_c ? corner
                  : (is_t && at_b) || (is_l && al_b) ? side : R;
    int p0 = 0, p1 = 0;
    if (mode == 2) {
      int st = __reduce_add_sync(FULL, (lane >= 1 && lane <= 8) ? F : 0);
      int sl = __reduce_add_sync(FULL, is_l ? F : 0);
      p0 = p1 = dc_pred(sl, st, al_b, at_b, 3);
    } else if (dir) {
      p0 = pred_taps(tap0, F, 0);
      p1 = pred_taps(tap1, F, 0);
    }
    uint8_t* row = sm.yi + (by + y + 1) * YP + 16 + bx + x;
    row[0] = (uint8_t)clip255(p0 + res0);
    row[4 * YP] = (uint8_t)clip255(p1 + res1);
    __syncwarp();
  }
}

// sum of the four bytes of v weighted by the four bytes of w
__device__ __forceinline__ int dot4(uint32_t v, uint32_t w) {
  return (int)__dp4a(v, w, 0u);
}
constexpr uint32_t kOnes = 0x01010101u, kRamp = 0x04030201u,
                   kRamp2 = 0x08070605u;

// I16x16 (and PCM, predicted as 0): the DC and plane sums from the
// packed top row and left column (byte dot products); lane l predicts
// pixels l + 32 i (column l % 16)
__device__ __forceinline__ void luma_i16(Smem& sm, const int* m, int al,
                                         int at, int ispcm, const int* resl,
                                         int lane) {
  uint8_t* yi = sm.yi;
  const uint4 tw = *reinterpret_cast<const uint4*>(yi + 16);
  const uint4 lw = *reinterpret_cast<const uint4*>(sm.yl);
  const uint32_t corner = yi[15];
  const int st = dot4(tw.x, kOnes) + dot4(tw.y, kOnes) + dot4(tw.z, kOnes)
                 + dot4(tw.w, kOnes);
  const int sl = dot4(lw.x, kOnes) + dot4(lw.y, kOnes) + dot4(lw.z, kOnes)
                 + dot4(lw.w, kOnes);
  // sum over x < 8 of (x + 1)(p[8 + x] - p[6 - x]), p[-1] the corner
  const int acc_h = dot4(tw.z, kRamp) + dot4(tw.w, kRamp2)
                    - dot4(__byte_perm(tw.y, tw.x, 0x7012), kRamp)
                    - dot4(__byte_perm(tw.x, corner, 0x4012), kRamp2);
  const int acc_v = dot4(lw.z, kRamp) + dot4(lw.w, kRamp2)
                    - dot4(__byte_perm(lw.y, lw.x, 0x7012), kRamp)
                    - dot4(__byte_perm(lw.x, corner, 0x4012), kRamp2);
  const int dc = dc_pred(sl, st, al, at, 4);
  const int pa = 16 * (sm.yl[15] + yi[31]);
  const int pb = (5 * acc_h + 32) >> 6;
  const int pc = (5 * acc_v + 32) >> 6;
  const int mode = m[R_I16M];
  const int x = lane & 15, top = yi[16 + x];
  // the reads above (row 0, column 15) and the writes below (rows 1-16,
  // columns 16-31) never meet
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = lane + 32 * i, y = t >> 4;
    int p;
    if (ispcm) p = 0;
    else if (mode == 0) p = top;
    else if (mode == 1) p = sm.yl[y];
    else if (mode == 2) p = dc;
    else p = clip255((pa + pb * (x - 7) + pc * (y - 7) + 16) >> 5);
    yi[(y + 1) * YP + 16 + x] = (uint8_t)clip255(p + resl[t]);
  }
}

// chroma prediction + reconstruction: DC and plane sums from the packed
// top rows and left columns; lane l predicts pixels l + 32 i (component
// i / 2, row l / 8 + 4 (i % 2), column l % 8)
__device__ __forceinline__ void chroma(Smem& sm, const int* m, int al,
                                       int at, int ispcm, const int* resc,
                                       int lane) {
  const int cmode = m[R_CMODE];
  const int x = lane & 7, xq = x >> 2;
#pragma unroll
  for (int ic = 0; ic < 2; ++ic) {
    uint8_t* c = sm.ci[ic];
    const uint2 tw = *reinterpret_cast<const uint2*>(c + 8);
    const uint2 lw = *reinterpret_cast<const uint2*>(sm.cl[ic]);
    const uint32_t corner = c[7];
    const int st0 = dot4(tw.x, kOnes), st1 = dot4(tw.y, kOnes);
    const int sl0 = dot4(lw.x, kOnes), sl1 = dot4(lw.y, kOnes);
    // sum over x < 4 of (x + 1)(p[4 + x] - p[2 - x]), p[-1] the corner
    const int acc_h = dot4(tw.y, kRamp)
                      - dot4(__byte_perm(tw.x, corner, 0x4012), kRamp);
    const int acc_v = dot4(lw.y, kRamp)
                      - dot4(__byte_perm(lw.x, corner, 0x4012), kRamp);
    const int both0 = (st0 + sl0 + 4) >> 3, both1 = (st1 + sl1 + 4) >> 3;
    const int t0 = (st0 + 2) >> 2, t1 = (st1 + 2) >> 2;
    const int l0 = (sl0 + 2) >> 2, l1 = (sl1 + 2) >> 2;
    // quadrants: 00 prefers both, 01 top, 10 left, 11 both
    const int dc_top = xq == 0 ? ((al && at) ? both0 : at ? t0 : al ? l0
                                                                   : 128)
                               : (at ? t1 : al ? l0 : 128);
    const int dc_bot = xq == 0 ? (al ? l1 : at ? t0 : 128)
                               : ((al && at) ? both1 : at ? t1 : al ? l1
                                                                   : 128);
    const int pa = 16 * (sm.cl[ic][7] + c[15]);
    const int pb = (17 * acc_h + 16) >> 5;
    const int pc = (17 * acc_v + 16) >> 5;
    const int top = c[8 + x];
    // reads (row 0, the left copy) and writes (rows 1-8, columns 8-15)
    // never meet
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = (lane >> 3) + 4 * half;
      int p;
      if (ispcm) p = 0;
      else if (cmode == 0) p = half ? dc_bot : dc_top;
      else if (cmode == 1) p = sm.cl[ic][y];
      else if (cmode == 2) p = top;
      else p = clip255((pa + pb * (x - 3) + pc * (y - 3) + 16) >> 5);
      c[(y + 1) * CPITCH + 8 + x] =
          (uint8_t)clip255(p + resc[64 * ic + 8 * y + x]);
    }
  }
}

__device__ void consumer(const Args& a, Smem& sm, int b, int r, int lane) {
  const int pw = 16 * a.wmb, ph = 16 * a.hmb;
  const int cw = 8 * a.wmb, ch = 8 * a.hmb;
  uint8_t* Yp = a.Y + (size_t)b * ph * pw;
  uint8_t* Cp[2] = {a.Cb + (size_t)b * ch * cw, a.Cr + (size_t)b * ch * cw};
  int* prog = a.ctr + b * a.hmb + r;
  int* err = a.ctr + a.B * a.hmb + 1;
  int seen = 0;                     // lane 0: last progress read of row r-1
  // store roles: lanes 0-15 luma row j, lanes 16-31 chroma row (ic, cy)
  const int j = lane & 15, sic = j >> 3, cy = j & 7;
  // neighbour-load roles: lanes 0-24 the luma row above from column
  // 16c-1, lanes 0-17 the chroma rows above from column 8c-1
  const int nic = lane < 9 ? 0 : 1, ni = lane - 9 * nic;
  const uint8_t* yabove = Yp + (size_t)max(16 * r - 1, 0) * pw - 1 + lane;
  const uint8_t* cabove =
      Cp[nic] + (size_t)max(8 * r - 1, 0) * cw - 1 + ni;

  for (int c = 0; c < a.wmb; ++c) {
    const int s = c % STAGES;
    PHASES_AT(a, b, r, c);
    PHASE(0, clock64());
    bar_sync(BAR_FULL + s);
    PHASE(1, clock64());
    const Stage& S = sm.st[s];
    const int* m = S.meta;
    uint8_t* yrow = Yp + (size_t)(16 * r + j) * pw + 16 * c;
    uint8_t* crow = Cp[sic] + (size_t)(8 * r + cy) * cw + 8 * c;

    if (m[R_PARSED] <= 0) {                // unparsed MB: zero pixels
      if (lane < 16) {
        *reinterpret_cast<uint4*>(yrow) = make_uint4(0, 0, 0, 0);
        sm.lcol[j] = 0;
      } else {
        *reinterpret_cast<uint2*>(crow) = make_uint2(0, 0);
        sm.lcolc[j] = 0;
      }
    } else {
      const int kind = m[R_KIND];
      const int al = m[R_AL] > 0, at = m[R_AT] > 0;
      const int atl = m[R_ATL] > 0, atr = m[R_ATR] > 0;
      const int is8 = kind == KIND_I8x8 && a.has8x8;
      const int ispcm = kind == KIND_IPCM && a.haspcm;

      // ---- wait for the row above, then read its neighbours ----
      if (r > 0 && (at || atl || atr)) {
        const int target = min(c + 2, a.wmb);
        if (lane == 0 && seen < target)
          seen = wait_at_least(prog - 1, target, err);
        __syncwarp();
      }
      PHASE(2, clock64());
      const int up = r > 0, hasl = al && c > 0;
      const int yuse = up && (lane == 0 ? atl && c > 0
                              : lane <= 16 ? at
                              : lane <= 24 && atr && c + 1 < a.wmb);
      const int cuse = up && lane < 18 && (ni == 0 ? atl && c > 0 : at);
      const int yv = yuse ? __ldcg(yabove + 16 * c) : 0;
      const int cv = cuse ? __ldcg(cabove + 8 * c) : 0;
      if (lane < 25) sm.yi[15 + lane] = (uint8_t)yv;
      if (lane < 18) sm.ci[nic][7 + ni] = (uint8_t)cv;
      if (lane < 16) {
        const uint8_t v = hasl ? sm.lcol[lane] : 0;
        sm.yi[(lane + 1) * YP + 15] = v;
        sm.yl[lane] = v;
      } else {
        sm.cl[sic][cy] = hasl ? sm.lcolc[j] : 0;
      }
      __syncwarp();

      PHASE(3, clock64());
      PHASE(10, kind);
      // ---- prediction + reconstruction into the images ----
      if (kind == KIND_I4x4) {
        luma_i4x4(sm, m, al, at, atl, atr, S.resl, lane);
      } else if (is8) {
        luma_i8x8(sm, m, al, at, atl, atr, S.resl, lane);
      } else if (kind == KIND_I16x16 || ispcm) {
        luma_i16(sm, m, al, at, ispcm, S.resl, lane);
      } else {
        *reinterpret_cast<uint2*>(sm.yi + ((lane >> 1) + 1) * YP + 16
                                  + (lane & 1) * 8) = make_uint2(0, 0);
      }
      PHASE(4, clock64());
      chroma(sm, m, al, at, ispcm, S.resc, lane);
      PHASE(5, clock64());
      __syncwarp();

      // ---- rows out: 16-byte luma rows, 8-byte chroma rows ----
      if (lane < 16) {
        const uint8_t* src = sm.yi + (j + 1) * YP + 16;
        *reinterpret_cast<uint4*>(yrow) =
            *reinterpret_cast<const uint4*>(src);
        sm.lcol[j] = src[15];
      } else {
        const uint8_t* src = sm.ci[sic] + (cy + 1) * CPITCH + 8;
        *reinterpret_cast<uint2*>(crow) =
            *reinterpret_cast<const uint2*>(src);
        sm.lcolc[j] = src[7];
      }
    }

    // ---- publish MB (r, c); hand the stage back ----
    PHASE(6, clock64());
#ifdef MVT_HOLD_ROW
    if (lane == 0 && b == 0 && r == 0 && c == 0) {
      const long long t0 = clock64();
      while (clock64() - t0 < 2 * TIMEOUT_CYCLES) {
      }
    }
#endif
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(prog, c + 1);
    PHASE(7, clock64());
    if (c + STAGES < a.wmb) bar_arrive(BAR_EMPTY + s);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wave_kernel(Args a) {
  __shared__ Smem sm;
  const int t = threadIdx.x;
  if (t == 0) sm.ticket = atomicAdd(a.ctr + a.B * a.hmb, 1);
  for (int i = t; i < TAP4_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(sm.tap4)[i] =
        __ldg(reinterpret_cast<const uint4*>(a.taps4) + i);
  for (int i = t; i < TAP8_BYTES / 16; i += THREADS)
    reinterpret_cast<uint4*>(sm.tap8)[i] =
        __ldg(reinterpret_cast<const uint4*>(a.taps8) + i);
  __syncthreads();
  const int r = sm.ticket / a.B, b = sm.ticket % a.B;
  const int lane = t & 31;
  if (t < 32) consumer(a, sm, b, r, lane);
  else producer(a, sm, b, r, (t >> 5) - 1, lane);
}

}  // namespace

// Reconstruct a batch in one launch on `stream`; `ctr` is B*hmb + 2 zeroed
// int32 (row progress, the ticket, the error word).  Returns the launch
// error (cudaGetLastError), or 0.
extern "C" int mvt_wave_run(
    const void* meta, const void* luma, const void* chroma, const void* dc,
    const void* ls4, const void* ls8, const void* taps4, const void* taps8,
    void* Y, void* Cb, void* Cr, void* ctr, int B, int W, int maxw, int wmb,
    int hmb, int has8x8, int haspcm, void* stream) {
  Args a;
  a.meta = (const int*)meta;
  a.luma = (const int16_t*)luma;
  a.chroma = (const int16_t*)chroma;
  a.dc = (const int16_t*)dc;
  a.ls4 = (const int*)ls4;
  a.ls8 = (const int*)ls8;
  a.taps4 = (const uint8_t*)taps4;
  a.taps8 = (const uint8_t*)taps8;
  a.Y = (uint8_t*)Y;
  a.Cb = (uint8_t*)Cb;
  a.Cr = (uint8_t*)Cr;
  a.ctr = (int*)ctr;
  a.B = B;
  a.W = W;
  a.maxw = maxw;
  a.wmb = wmb;
  a.hmb = hmb;
  a.has8x8 = has8x8;
  a.haspcm = haspcm;
  wave_kernel<<<B * hmb, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef MVT_PHASES
// Where the kernel records its phase marks (nullptr: nowhere).
extern "C" int mvt_set_phases(void* p) {
  long long* q = (long long*)p;
  return (int)cudaMemcpyToSymbol(g_phases, &q, sizeof(q));
}
#endif
