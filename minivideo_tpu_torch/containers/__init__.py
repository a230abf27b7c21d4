"""Demuxer dispatch by container format.

Reference: the parse switch in minivideo.c:215-242.
"""

from __future__ import annotations

from ..codecs import Codec, Container
from ..media import MediaFile
from .. import trace


def demux(media: MediaFile) -> bool:
    """Parse the opened media file's container into track sample tables.

    Prefers the native C++ demuxer (native/src/demux.cc, built at first
    use; a failed build raises) and uses the Python demuxers where it
    fails on a file; MINIVIDEO_TPU_NO_NATIVE=1 forces the Python
    demuxers.  Both produce identical tables
    (tests/test_torch_demux.py)."""
    import os
    c = media.container
    if os.environ.get("MINIVIDEO_TPU_NO_NATIVE") != "1":
        from .native import native_demux, native_demux_available
        if native_demux_available(c):
            if native_demux(media):
                return True
            trace.t1("DEMUX", "native demux failed; falling back to Python")
    if c == Container.MP4:
        from .mp4 import mp4_parse
        return mp4_parse(media)
    if c == Container.AVI:
        from .avi import avi_parse
        return avi_parse(media)
    if c == Container.WAVE:
        from .wave import wave_parse
        return wave_parse(media)
    if c == Container.MPEG_PS:
        from .mpeg_ps import ps_parse
        return ps_parse(media)
    if c == Container.MKV:
        from .mkv import mkv_parse
        return mkv_parse(media)
    if c == Container.MPEG_TS:
        from .ts import ts_parse
        return ts_parse(media)
    if c == Container.ES:
        from .es import es_parse
        return es_parse(media, Codec.H264)
    if c == Container.ES_MP3:
        from .mp3 import mp3_parse
        return mp3_parse(media)
    trace.error("DEMUX", "container %s not supported", c.name)
    return False
