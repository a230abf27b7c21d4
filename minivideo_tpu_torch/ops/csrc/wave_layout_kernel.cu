// The device staging mode's MB-major records laid out into the wave
// kernel's per-wave feeds, on Hopper.
//
// The native parser writes one int16 record of REC_LEN elements per
// macroblock, in raster order (native/__init__.py REC_*: luma 256,
// chroma 128, DC 32, meta rows 0..33, zero padding).  wave_kernel.cu reads
// the feeds [B, W, S, maxw] (luma, chroma, DC int16; meta int32 with 40
// rows), where lane k of wave w holds MB idx[w, k]
// (ops/recon_wave.skew_tables) and padded lanes (idx -1) hold zeros:
//
//   feed[b, w, s, k] = idx[w, k] >= 0 ? rec[b, idx[w, k], s] : 0
//
// Every element of the four feeds is written, padding included, so they
// need no memset.  The plain version is ops/wave_layout.wave_layout_plain.
//
// Design.  One block per (wave, frame, chunk of CHUNK record elements).
// It stages the chunk of each of the wave's maxw records in shared memory
// with 4-byte loads (each record's chunk is contiguous), then writes the
// chunk's CHUNK feed rows, consecutive threads taking consecutive lanes,
// so each row of maxw lanes is one contiguous run.
//
// Bound.  Every record is read once and every feed element written once:
// at 1080p with B = 16, 121,159,680 B read and 245,920,768 B written,
// 0.110 ms at 3.35 TB/s.  No arithmetic: bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int REC_LEN = 464, REC_LUMA = 0, REC_CHROMA = 256, REC_DC = 384,
              REC_META = 416, REC_META_ROWS = 34, META_ROWS = 40;
constexpr int CHUNKS = 8, CHUNK = REC_LEN / CHUNKS;   // 58 elements
constexpr int CHUNK_WORDS = CHUNK / 2;
static_assert(CHUNK * CHUNKS == REC_LEN && CHUNK % 2 == 0, "chunking");
// the largest maxw whose chunks fit the default 48 KiB of shared memory
constexpr int MAX_LANES = 48 * 1024 / (CHUNK * 2);

struct Args {
  const uint32_t* rec;     // [B, n, REC_LEN] int16, as pairs
  const int* idx;          // [W, maxw] MB of each lane, -1 for padding
  int* meta;               // [B, W, META_ROWS, maxw]
  int16_t* luma;           // [B, W, 256, maxw]
  int16_t* chroma;         // [B, W, 128, maxw]
  int16_t* dc;             // [B, W, 32, maxw]
  int n, W, maxw;
};

__global__ void __launch_bounds__(THREADS)
mb_layout_kernel(Args a) {
  extern __shared__ uint32_t tile[];     // [maxw][CHUNK_WORDS]
  const int w = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int maxw = a.maxw;
  const int* idx = a.idx + (size_t)w * maxw;
  for (int i = threadIdx.x; i < maxw * CHUNK_WORDS; i += THREADS) {
    const int k = i / CHUNK_WORDS, j = i - k * CHUNK_WORDS;
    const int mb = idx[k];
    tile[i] = mb < 0 ? 0u
                     : __ldcs(a.rec + ((size_t)b * a.n + mb) * (REC_LEN / 2)
                              + c * CHUNK_WORDS + j);
  }
  __syncthreads();
  const int16_t* t16 = reinterpret_cast<const int16_t*>(tile);
  const size_t bw = (size_t)b * a.W + w;
  for (int i = threadIdx.x; i < CHUNK * maxw; i += THREADS) {
    const int j = i / maxw, k = i - j * maxw;
    const int s = c * CHUNK + j;
    const int16_t v = t16[k * CHUNK + j];
    if (s < REC_CHROMA) {
      a.luma[(bw * 256 + (s - REC_LUMA)) * maxw + k] = v;
    } else if (s < REC_DC) {
      a.chroma[(bw * 128 + (s - REC_CHROMA)) * maxw + k] = v;
    } else if (s < REC_META) {
      a.dc[(bw * 32 + (s - REC_DC)) * maxw + k] = v;
    } else if (s < REC_META + META_ROWS) {
      a.meta[(bw * META_ROWS + (s - REC_META)) * maxw + k] =
          s < REC_META + REC_META_ROWS ? (int)v : 0;
    }
  }
}

}  // namespace

// Lay out a batch of records in one launch on `stream`.  Returns the
// launch error (cudaGetLastError), or cudaErrorInvalidValue where maxw
// lanes do not fit the block's shared memory.
extern "C" int mvt_layout_run(const void* rec, const void* idx, void* meta,
                              void* luma, void* chroma, void* dc, int B,
                              int n, int W, int maxw, void* stream) {
  if (maxw < 1 || maxw > MAX_LANES) return (int)cudaErrorInvalidValue;
  Args a;
  a.rec = (const uint32_t*)rec;
  a.idx = (const int*)idx;
  a.meta = (int*)meta;
  a.luma = (int16_t*)luma;
  a.chroma = (int16_t*)chroma;
  a.dc = (int16_t*)dc;
  a.n = n;
  a.W = W;
  a.maxw = maxw;
  const size_t smem = (size_t)maxw * CHUNK * sizeof(int16_t);
  mb_layout_kernel<<<dim3(W, B, CHUNKS), THREADS, smem,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
