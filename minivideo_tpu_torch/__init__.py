"""minivideo_tpu_torch: the PyTorch/CUDA port of minivideo_tpu.

H.264 intra (IDR) decoding of media files and Annex-B streams: container
probe and demux on the host (native C++ or Python), native C++ entropy
parse into device-layout slab staging, then the fused wavefront
reconstruction as a hand-written CUDA kernel on an NVIDIA Hopper card
(ops/csrc/wave_kernel.cu), or its plain PyTorch version on the CPU, with
optional RGB888 conversion on the same device.
Entry points: api.mv_open / mv_parse / mv_decode for files, and
models.h264.decoder.decode_annexb for Annex-B bytes.
"""
