"""minivideo_tpu_torch: the PyTorch/CUDA port of minivideo_tpu.

H.264 intra (IDR) decoding of Annex-B streams: native C++ entropy parse
into device-layout slab staging, then the fused wavefront reconstruction
as a hand-written CUDA kernel on an NVIDIA Hopper card
(ops/csrc/wave_kernel.cu), or its plain PyTorch version on the CPU.
Entry point: models.h264.decoder.decode_annexb.
"""
