"""tvid-analyse: terminal media inspector.

Replaces the reference's Qt GUI mini_analyser (reference
mini_analyser/src/: track tables, sample explorer, bitrate stats) with a
terminal/JSON analyser exposing the same data: container info, per-track
metadata, sample tables with offsets, bitrate statistics.

Port of minivideo_tpu/apps/analyser.py: host code, imports no torch.

    python -m minivideo_tpu_torch.apps.analyser clip.mp4 --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..api import mv_close, mv_open, mv_parse
from ..codecs import SampleType, codec_name, container_name


def analyse(path: str) -> dict:
    media = mv_open(path)
    try:
        parsed = mv_parse(media)
        info = {
            "file": media.file_path,
            "size_bytes": media.file_size,
            "container": container_name(media.container),
            "container_long": container_name(media.container, long=True),
            "parsed": bool(parsed),
            "tracks": [],
        }
        for t in media.tracks:
            entry = {
                "id": int(t.track_id),
                "type": t.stream_type.name,
                "codec": codec_name(t.stream_codec),
                "codec_long": codec_name(t.stream_codec, long=True),
                "sample_count": int(t.sample_count),
                "stream_size": int(t.stream_size),
                "duration_ms": round(float(t.stream_duration_ms), 3),
                "bitrate_bps": int(t.bitrate),
                "bitrate_mode": t.bitrate_mode.name,
            }
            if t.stream_type.name == "VIDEO":
                entry.update(width=int(t.width), height=int(t.height),
                             framerate=round(float(t.framerate), 3),
                             idr_count=int(t.frame_count_idr))
                dar = float(t.dar) if t.dar else (
                    t.width * t.par_h / (t.height * t.par_v)
                    if t.height else 0.0)
                entry["dar"] = round(dar, 4)
                if (t.par_h, t.par_v) != (1, 1):
                    entry["par"] = f"{t.par_h}:{t.par_v}"
                if t.framerate_num:
                    entry["framerate_num"] = int(t.framerate_num)
                    entry["framerate_base"] = int(t.framerate_base)
                if t.color_matrix:
                    from ..codecs import ColorMatrix
                    entry["color_matrix"] = ColorMatrix(
                        t.color_matrix).name
                if t.color_full_range >= 0:
                    entry["color_full_range"] = bool(t.color_full_range)
                if t.crop_width:
                    entry["clean_aperture"] = (f"{t.crop_width}x"
                                               f"{t.crop_height}")
                if t.interlaced >= 0:
                    entry["interlaced"] = bool(t.interlaced)
                if t.bitrate_max:
                    entry["bitrate_max"] = int(t.bitrate_max)
                    entry["bitrate_avg"] = int(t.bitrate_avg)
            elif t.stream_type.name == "AUDIO":
                entry.update(channels=int(t.channel_count),
                             sample_rate=int(t.sampling_rate),
                             bits_per_sample=int(t.bit_per_sample))
                if t.sample_per_frames:
                    entry["samples_per_frame"] = int(t.sample_per_frames)
                # WAVE fmt extension + cue points (wave.c:46-222)
                fmt = getattr(t, "wave_fmt", None)
                if fmt and "channel_mask" in fmt:
                    entry["channel_mask"] = hex(fmt["channel_mask"])
                cues = getattr(t, "wave_cue_points", None)
                if cues:
                    entry["cue_points"] = [c["sample_offset"]
                                           for c in cues]
            info["tracks"].append(entry)
        return info
    finally:
        mv_close(media)


def sample_table(path: str, track_index: int, limit: int):
    media = mv_open(path)
    try:
        mv_parse(media)
        tracks = media.tracks
        if track_index >= len(tracks):
            raise IndexError(f"track {track_index} out of range "
                             f"({len(tracks)} tracks)")
        t = tracks[track_index]
        rows = []
        for i in range(min(t.sample_count, limit)):
            rows.append({
                "index": i,
                "type": SampleType(int(t.sample_type[i])).name,
                "offset": int(t.sample_offset[i]),
                "size": int(t.sample_size[i]),
                "pts_ms": (round(int(t.sample_pts[i]) / 1e6, 3)
                           if t.sample_pts[i] >= 0 else None),
            })
        return rows
    finally:
        mv_close(media)


def bitrate_graph(path: str, track_index: int, buckets: int = 40):
    """Text bitrate-over-samples graph (analyser's QCustomPlot equivalent,
    reference mainwindow_datas.cpp:1042-1050)."""
    media = mv_open(path)
    try:
        mv_parse(media)
        t = media.tracks[track_index]
        sizes = t.sample_size.astype(np.float64)
        if len(sizes) < 2:
            return []
        chunks = np.array_split(sizes, min(buckets, len(sizes)))
        means = np.array([c.mean() for c in chunks])
        peak = means.max() or 1
        lines = []
        for m in means:
            bar = "#" * max(1, int(40 * m / peak))
            lines.append(f"{int(m):>9d} B |{bar}")
        return lines
    finally:
        mv_close(media)


def hex_dump(path: str, track_index: int, sample_index: int,
             max_bytes: int = 256):
    """Hexdump of one sample's bytes (the CLI equivalent of
    mini_analyser's QHexEdit2 pane, hexeditor.cpp)."""
    media = mv_open(path)
    try:
        mv_parse(media)
        t = media.tracks[track_index]
        raw = t.read_sample(media.file_handle, sample_index)[:max_bytes]
        lines = []
        for off in range(0, len(raw), 16):
            chunk = raw[off:off + 16]
            hexs = " ".join(f"{b:02x}" for b in chunk)
            txt = "".join(chr(b) if 32 <= b < 127 else "." for b in chunk)
            lines.append(f"{off:08x}  {hexs:<47}  |{txt}|")
        return lines
    finally:
        mv_close(media)


def fourcc_info(token: str) -> dict:
    """FourCC helper (mini_analyser's fourcchelper.cpp): accepts a
    4-char code or 0x hex value; prints every representation + the
    codec mapping."""
    from ..codecs import codec_from_fourcc, codec_name
    if token.lower().startswith("0x"):
        v = int(token, 16)
        chars = v.to_bytes(4, "big").decode("latin-1")
    else:
        chars = (token + "    ")[:4]
        v = int.from_bytes(chars.encode("latin-1"), "big")
    codec = codec_from_fourcc(chars)
    return {
        "fourcc": chars,
        "hex_be": f"0x{v:08X}",
        "hex_le": "0x" + "".join(
            f"{b:02X}" for b in v.to_bytes(4, "little")),
        "decimal": v,
        "codec": codec_name(codec),
        "codec_long": codec_name(codec, long=True),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tvid-analyse",
        description="Inspect media files: container, tracks, samples")
    p.add_argument("inputs", nargs="*", help="media file(s)")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--samples", type=int, metavar="TRACK", default=None,
                   help="print the sample table of track N")
    p.add_argument("--limit", type=int, default=30,
                   help="max samples to print")
    p.add_argument("--bitrate", type=int, metavar="TRACK", default=None,
                   help="print a bitrate graph for track N")
    p.add_argument("--hex", metavar="TRACK:SAMPLE[:BYTES]", default=None,
                   help="hexdump a sample's bytes")
    p.add_argument("--fourcc", metavar="CODE", default=None,
                   help="FourCC helper: 4-char code or 0x hex value")
    args = p.parse_args(argv)

    if args.fourcc is not None:
        info = fourcc_info(args.fourcc)
        if args.json:
            print(json.dumps(info, indent=2))
        else:
            for k, v in info.items():
                print(f"{k:>11}: {v}")
        return 0
    if not args.inputs:
        p.error("media file(s) required")

    for path in args.inputs:
        if not os.path.isfile(path):
            print(f"error: '{path}' not found", file=sys.stderr)
            return 1
        if args.samples is not None:
            rows = sample_table(path, args.samples, args.limit)
            if args.json:
                print(json.dumps(rows, indent=2))
            else:
                print(f"{'idx':>5} {'type':<12} {'offset':>10} "
                      f"{'size':>8} {'pts_ms':>10}")
                for r in rows:
                    print(f"{r['index']:>5} {r['type']:<12} "
                          f"{r['offset']:>10} {r['size']:>8} "
                          f"{str(r['pts_ms']):>10}")
            continue
        if args.bitrate is not None:
            for line in bitrate_graph(path, args.bitrate):
                print(line)
            continue
        if args.hex is not None:
            parts = [int(x) for x in args.hex.split(":")]
            tr, si = parts[0], parts[1]
            nb = parts[2] if len(parts) > 2 else 256
            for line in hex_dump(path, tr, si, nb):
                print(line)
            continue
        info = analyse(path)
        if args.json:
            print(json.dumps(info, indent=2))
        else:
            print(f"== {info['file']}")
            print(f"   container: {info['container_long']} "
                  f"({info['size_bytes']} bytes)")
            for t in info["tracks"]:
                extra = ""
                if "width" in t:
                    extra = (f" {t['width']}x{t['height']} "
                             f"@{t['framerate']}fps {t['idr_count']} IDR")
                elif "channels" in t:
                    extra = (f" {t['channels']}ch {t['sample_rate']}Hz")
                print(f"   track {t['id']}: {t['type']} {t['codec']}"
                      f"{extra}, {t['sample_count']} samples, "
                      f"{t['bitrate_bps'] // 1000} kb/s "
                      f"{t['bitrate_mode']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
