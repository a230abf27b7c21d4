"""Frozen copies of minivideo_tpu_torch's Python H.264 parsers and numpy
oracle (bitio, trace, models/h264/*), their imports made local."""
