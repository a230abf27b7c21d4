"""Media file and track model: columnar sample tables.

TPU-native equivalent of the reference's track model
(reference: minivideo/src/bitstream_map_struct.h:46-129 `BitstreamMap_t`,
mediafile_struct.h:39-73 `MediaFile_t`, bitstream_map.c).  Instead of C
parallel arrays, samples live in numpy columnar arrays (type/size/offset/
pts/dts) so demux output is directly batchable onto device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .codecs import (BitrateMode, Codec, Container, FramerateMode,
                     SampleType, StreamType, codec_from_fourcc)
from . import trace


@dataclass
class Track:
    """Per-track sample index + stream metadata.

    Mirrors `BitstreamMap_t` (bitstream_map_struct.h:46-129): stream-level
    metadata plus five parallel per-sample arrays.
    """
    stream_type: StreamType = StreamType.UNKNOWN
    stream_fcc: int = 0
    stream_codec: Codec = Codec.UNKNOWN

    # stream-level stats (computed post-parse)
    stream_size: int = 0
    stream_duration_ms: float = 0.0
    bitrate: int = 0           # gross bitrate, bit/s
    bitrate_mode: BitrateMode = BitrateMode.UNKNOWN

    # video metadata
    width: int = 0
    height: int = 0
    color_depth: int = 8
    par_h: int = 1             # pixel aspect ratio
    par_v: int = 1
    dar: float = 0.0           # display aspect ratio (0 = derive from size)
    color_matrix: int = 0      # ColorMatrix enum (mp4 colr / PS defaults)
    color_full_range: int = -1  # 1 full / 0 studio / -1 unknown
    crop_width: int = 0        # clean-aperture display size (mp4 clap)
    crop_height: int = 0
    interlaced: int = -1       # 1 interlaced / 0 progressive / -1 unknown
    bitrate_max: int = 0       # declared max/avg bitrate (mp4 btrt)
    bitrate_avg: int = 0
    framerate: float = 0.0
    framerate_num: int = 0     # rational framerate (0 = unknown)
    framerate_base: int = 0
    framerate_mode: FramerateMode = FramerateMode.UNKNOWN
    frame_count: int = 0
    frame_count_idr: int = 0

    # audio metadata
    channel_count: int = 0
    sampling_rate: int = 0
    bit_per_sample: int = 0
    sample_per_frames: int = 0

    # codec private data (e.g. SPS/PPS from avcC), list of bytes objects
    parameter_sets: list = field(default_factory=list)
    nal_length_size: int = 4   # AVCC NALU length prefix size (from avcC)
    length_prefixed: bool = False  # samples carry AVCC length prefixes

    # columnar per-sample arrays (the "bitstream map")
    sample_type: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int32))
    sample_size: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    sample_offset: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    sample_pts: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))  # nanoseconds
    sample_dts: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))  # nanoseconds

    track_id: int = 0
    timescale: int = 0
    duration_units: int = 0

    @property
    def sample_count(self) -> int:
        return int(self.sample_type.shape[0])

    def set_samples(self, types, sizes, offsets, pts=None, dts=None) -> None:
        n = len(sizes)
        self.sample_type = np.asarray(types, dtype=np.int32)
        self.sample_size = np.asarray(sizes, dtype=np.int64)
        self.sample_offset = np.asarray(offsets, dtype=np.int64)
        self.sample_pts = (np.asarray(pts, dtype=np.int64) if pts is not None
                           else np.full(n, -1, dtype=np.int64))
        self.sample_dts = (np.asarray(dts, dtype=np.int64) if dts is not None
                           else np.full(n, -1, dtype=np.int64))

    def idr_indices(self) -> np.ndarray:
        return np.nonzero(self.sample_type == int(SampleType.VIDEO_SYNC))[0]

    def param_indices(self) -> np.ndarray:
        return np.nonzero(self.sample_type == int(SampleType.VIDEO_PARAM))[0]

    # -- post-parse derivations (reference: bitstream_map.c:215-436) --------

    def compute_codec(self) -> None:
        """Derive codec from fourcc if unset (bitstream_map.c:311-335)."""
        if self.stream_codec == Codec.UNKNOWN and self.stream_fcc:
            self.stream_codec = codec_from_fourcc(self.stream_fcc)

    def compute_stats(self) -> None:
        """Frame counts, stream size, duration, gross bitrate, CBR/VBR
        detection (bitstream_map.c:215-306,412-436)."""
        if self.sample_count == 0:
            return
        media_mask = np.isin(self.sample_type,
                             (int(SampleType.VIDEO), int(SampleType.VIDEO_SYNC),
                              int(SampleType.AUDIO)))
        sizes = self.sample_size[media_mask]
        self.stream_size = int(self.sample_size.sum())
        self.frame_count = int(media_mask.sum())
        self.frame_count_idr = int(
            (self.sample_type == int(SampleType.VIDEO_SYNC)).sum())
        pts = self.sample_pts[media_mask]
        valid = pts[pts >= 0]
        if valid.size >= 2:
            dur_ns = int(valid.max() - valid.min())
            if self.framerate > 0:
                dur_ns += int(1e9 / self.framerate)
            self.stream_duration_ms = dur_ns / 1e6
        if self.stream_duration_ms > 0:
            self.bitrate = int(self.stream_size * 8 * 1000.0
                               / self.stream_duration_ms)
        if sizes.size > 1:
            # CBR if all media samples have (nearly) equal size
            if np.all(np.abs(sizes.astype(np.int64) - sizes[0]) <= 1):
                self.bitrate_mode = BitrateMode.CBR
            else:
                self.bitrate_mode = BitrateMode.VBR

    # per-sample fragment lists [(offset, size), ...] for transport
    # containers whose payloads are scattered (MPEG-TS); None = contiguous
    fragments: list = None

    def read_sample(self, fh, index: int) -> bytes:
        if self.fragments is not None:
            frags = self.fragments[index]
            if frags is not None:
                lo = min(off for off, _ in frags)
                hi = max(off + sz for off, sz in frags)
                if hi - lo <= 2 * sum(sz for _, sz in frags):
                    # close fragments (a TS packet's payload every 188 or
                    # 192 bytes): one read of the span they cover
                    fh.seek(int(lo))
                    span = fh.read(int(hi - lo))
                    return b"".join(span[off - lo:off - lo + sz]
                                    for off, sz in frags)
                parts = []
                for off, sz in frags:
                    fh.seek(int(off))
                    parts.append(fh.read(int(sz)))
                return b"".join(parts)
        fh.seek(int(self.sample_offset[index]))
        return fh.read(int(self.sample_size[index]))


@dataclass
class MediaFile:
    """Open media file handle + parse results.

    Mirrors `MediaFile_t` (mediafile_struct.h:39-73).
    """
    file_path: str = ""
    file_directory: str = ""
    file_name: str = ""
    file_extension: str = ""
    file_size: int = 0
    container: Container = Container.UNKNOWN
    file_handle: object = None

    tracks_audio: list = field(default_factory=list)
    tracks_video: list = field(default_factory=list)
    tracks_subtitles: list = field(default_factory=list)
    tracks_others: list = field(default_factory=list)

    parsed: bool = False

    @property
    def tracks(self) -> list:
        return (self.tracks_video + self.tracks_audio
                + self.tracks_subtitles + self.tracks_others)

    def add_track(self, t: Track) -> None:
        if t.stream_type == StreamType.VIDEO:
            self.tracks_video.append(t)
        elif t.stream_type == StreamType.AUDIO:
            self.tracks_audio.append(t)
        elif t.stream_type == StreamType.TEXT:
            self.tracks_subtitles.append(t)
        else:
            self.tracks_others.append(t)

    def close(self) -> None:
        if self.file_handle is not None:
            try:
                self.file_handle.close()
            finally:
                self.file_handle = None


def open_media(path: str) -> MediaFile:
    """Open a media file and probe its container.

    Reference: import_fileOpen (import.c:510-568) — path decomposition
    (import.c:49-146), size (import.c:154-174), container detection
    (import.c:472-491).
    """
    from .probe import detect_container
    m = MediaFile()
    m.file_path = os.path.abspath(path)
    m.file_directory = os.path.dirname(m.file_path)
    base = os.path.basename(m.file_path)
    m.file_name, dot, ext = base.rpartition(".")
    if not dot:
        m.file_name, ext = base, ""
    m.file_extension = ext.lower()
    m.file_handle = open(m.file_path, "rb")
    m.file_handle.seek(0, os.SEEK_END)
    m.file_size = m.file_handle.tell()
    m.file_handle.seek(0)
    m.container = detect_container(m.file_handle, m.file_extension)
    trace.info("IO", "opened %s (%d bytes, container=%s)",
               m.file_path, m.file_size, m.container.name)
    return m
