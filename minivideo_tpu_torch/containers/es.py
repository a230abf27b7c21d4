"""H.264 Annex-B elementary stream scanner.

Reference: minivideo/src/demuxer/esparser/esparser.c — byte-aligned
00 00 01 start-code scan classifying SPS/PPS/IDR samples, sizes inferred
from the next start offset.  Improvements over the reference: 3-byte start
codes are recognised (the reference requires >=3 zero bytes,
esparser.c:77), the scan covers the whole file (the reference stops 32
bytes early, esparser.c:65), non-IDR slices are indexed too, and the
sample table is exactly sized (no hardcoded 999999-entry map).
"""

from __future__ import annotations

import numpy as np

from ..codecs import Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace

_IDR = 5
_SLICE = 1
_SPS = 7
_PPS = 8
_SEI = 6


def es_parse(media: MediaFile, codec: Codec = Codec.H264) -> bool:
    """Scan an H.264 Annex-B file into a single video track."""
    from ..bufio import FileWindow
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51); the
    # parse logic below is byte-identical to in-memory operation
    data = FileWindow(fh, media.file_size)
    types, sizes, offsets = [], [], []
    n = len(data)
    i = data.find(b"\x00\x00\x01")
    starts = []
    while i != -1:
        # extend start code backwards over extra zero bytes
        payload = i + 3
        if payload < n:
            starts.append(payload)
        i = data.find(b"\x00\x00\x01", payload)
    for k, off in enumerate(starts):
        nal_type = data[off] & 0x1F
        end = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # the next start code may be 4 bytes (preceded by a zero)
        while end > off and data[end - 1] == 0 and k + 1 < len(starts):
            end -= 1
        size = end - off
        if nal_type == _IDR:
            st = SampleType.VIDEO_SYNC
        elif nal_type in (_SPS, _PPS):
            st = SampleType.VIDEO_PARAM
        elif nal_type in (_SLICE, 2, 3, 4):
            st = SampleType.VIDEO
        else:
            st = SampleType.OTHER
        types.append(int(st))
        sizes.append(size)
        offsets.append(off)
    if not types:
        trace.error("ES", "no NAL units found")
        return False
    t = Track(stream_type=StreamType.VIDEO, stream_codec=codec)
    t.set_samples(types, sizes, offsets)
    t.compute_stats()
    media.add_track(t)
    trace.info("ES", "indexed %d NAL units (%d IDR)",
               t.sample_count, t.frame_count_idr)
    return True
