// MB tiles to raster planes on Hopper.
//
// Replaces the TPU kernel tools/probe_interleave.py::dma_kernel, which
// turns MB tiles [B, hmb*wmb, 256] u8 (each 16x16, row-major) into raster
// [B, 16*hmb, 16*wmb] u8 with 16 strided HBM-to-HBM DMAs per MB row
// (grid (hmb,)).
//
// Design.  One block per (MB row, frame).  Each 16-byte run of a raster
// row is one uint4 move: thread i writes run c = i % wmb of raster row
// y = i / wmb, so consecutive threads write consecutive 16-byte runs and
// each warp stores 512 contiguous bytes; it reads row y of MB c's tile.
//
// Bound.  The kernel reads every tile byte once and writes every plane
// byte once: at 1080p with B = 16, 33,423,360 bytes each way, 0.0200 ms at
// 3.35 TB/s.  No arithmetic: bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
interleave_kernel(const uint4* __restrict__ tiles, uint4* __restrict__ out,
                  int wmb, int hmb) {
  const int r = blockIdx.x, b = blockIdx.y;
  const uint4* src = tiles + ((size_t)b * hmb + r) * wmb * 16;
  uint4* dst = out + ((size_t)b * hmb + r) * 16 * wmb;
  for (int i = threadIdx.x; i < 16 * wmb; i += THREADS) {
    const int y = i / wmb, c = i - y * wmb;
    dst[i] = __ldcs(src + c * 16 + y);
  }
}

}  // namespace

// Interleave a batch in one launch on `stream`; returns the launch error
// (cudaGetLastError), or 0.
extern "C" int mvt_interleave_run(const void* tiles, void* out, int B,
                                  int wmb, int hmb, void* stream) {
  interleave_kernel<<<dim3(hmb, B), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)tiles, (uint4*)out, wmb, hmb);
  return (int)cudaGetLastError();
}
