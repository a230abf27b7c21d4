"""The benchmark of minivideo_tpu_torch, the PyTorch and CUDA port: its
harness (run.py), inputs, drivers, trace arithmetic, per-layer metrics and
the plain reference that decides `correct`.  See PERF.md."""
