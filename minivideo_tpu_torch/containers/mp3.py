"""MP3 / MPEG-audio elementary stream parser.

Reference: minivideo/src/demuxer/mp3/mp3.c — syncword walk with full
header decode (version/layer/bitrate/samplerate tables :148-241), ID3v1/
ID3v2 (syncsafe) and APE/Lyrics3 tag skipping (:425-473).  Improvement
over the reference: every frame is indexed into the sample table (the
reference computes stream-level stats only, mp3.c:249 TODO).
"""

from __future__ import annotations

import numpy as np

from ..codecs import BitrateMode, Codec, SampleType, StreamType
from ..media import MediaFile, Track
from .. import trace

# bitrate tables [kbps], index 1..14 (ISO 11172-3 / 13818-3)
_BITRATE = {
    # (version_group, layer): tuple
    (1, 1): (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384,
             416, 448),
    (1, 2): (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
             320, 384),
    (1, 3): (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224,
             256, 320),
    (2, 1): (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
             224, 256),
    (2, 2): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160),
    (2, 3): (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
             160),
}

_SAMPLERATE = {
    3: (44100, 48000, 32000),    # MPEG-1
    2: (22050, 24000, 16000),    # MPEG-2
    0: (11025, 12000, 8000),     # MPEG-2.5
}


def _parse_frame_header(b0, b1, b2, b3):
    """Returns (frame_size, samplerate, bitrate_bps, layer, channels)
    or None."""
    if b0 != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version_id = (b1 >> 3) & 3        # 0: 2.5, 2: MPEG-2, 3: MPEG-1
    layer_id = (b1 >> 1) & 3          # 1: III, 2: II, 3: I
    if version_id == 1 or layer_id == 0:
        return None
    layer = 4 - layer_id              # 1, 2, 3
    vgroup = 1 if version_id == 3 else 2
    br_idx = (b2 >> 4) & 0xF
    sr_idx = (b2 >> 2) & 3
    if br_idx in (0, 15) or sr_idx == 3:
        return None
    bitrate = _BITRATE[(vgroup, layer)][br_idx] * 1000
    samplerate = _SAMPLERATE[version_id][sr_idx]
    padding = (b2 >> 1) & 1
    channels = 1 if ((b3 >> 6) & 3) == 3 else 2
    if layer == 1:
        size = (12 * bitrate // samplerate + padding) * 4
        spf = 384
    else:
        spf = 1152 if (layer == 3 and vgroup == 1) or layer == 2 else 576
        size = spf * bitrate // (8 * samplerate) + padding
    return size, samplerate, bitrate, layer, channels, spf


def _skip_tags(data: bytes) -> int:
    """Skip leading ID3v2 (syncsafe size; reference mp3.c:425-447)."""
    pos = 0
    while data[pos:pos + 3] == b"ID3" and pos + 10 <= len(data):
        sz = ((data[pos + 6] & 0x7F) << 21) | ((data[pos + 7] & 0x7F) << 14) \
            | ((data[pos + 8] & 0x7F) << 7) | (data[pos + 9] & 0x7F)
        pos += 10 + sz
    return pos


def mp3_parse(media: MediaFile) -> bool:
    from ..bufio import FileWindow
    fh = media.file_handle
    # bounded-memory sliding window (reference bitstream.c:51); the
    # parse logic below is byte-identical to in-memory operation
    data = FileWindow(fh, media.file_size)
    n = len(data)
    pos = _skip_tags(data)

    offsets, sizes = [], []
    samplerate = bitrate0 = layer = channels = spf = 0
    bitrates = []
    while pos + 4 <= n:
        h = _parse_frame_header(data[pos], data[pos + 1], data[pos + 2],
                                data[pos + 3])
        if h is None:
            # resync: find next syncword
            nxt = data.find(b"\xff", pos + 1)
            if nxt == -1:
                break
            if data[pos:pos + 3] in (b"TAG", b"APE") or \
               data[pos:pos + 3] == b"LYR":
                break                      # trailing tags
            pos = nxt
            continue
        size, sr, br, ly, ch, spf_ = h
        if size <= 0:
            break
        if not offsets:
            samplerate, layer, channels, spf = sr, ly, ch, spf_
            bitrate0 = br
        offsets.append(pos)
        sizes.append(min(size, n - pos))
        bitrates.append(br)
        pos += size

    if not offsets:
        trace.error("MP3", "no MPEG audio frames found")
        return False

    codec = {1: Codec.MPEG_L1, 2: Codec.MPEG_L2, 3: Codec.MPEG_L3}[layer]
    t = Track(stream_type=StreamType.AUDIO, stream_codec=codec,
              sampling_rate=samplerate, channel_count=channels,
              sample_per_frames=spf)
    frame_ns = int(spf * 1e9 / samplerate)
    pts = (np.arange(len(offsets)) * frame_ns).astype(np.int64)
    t.set_samples([int(SampleType.AUDIO)] * len(offsets), sizes, offsets,
                  pts, pts)
    t.compute_stats()
    uniq = set(bitrates)
    t.bitrate_mode = BitrateMode.CBR if len(uniq) == 1 else BitrateMode.VBR
    t.bitrate = int(np.mean(bitrates))
    media.add_track(t)
    media.parsed = True
    trace.info("MP3", "layer %d, %d frames, %d Hz, %s", layer,
               len(offsets), samplerate, t.bitrate_mode.name)
    return True
