"""tvid-extract: CLI track extractor.

Feature parity with mini_extractor (reference
mini_extractor/src/main.cpp:197-264): -i/-o/-a/-v/--es/--pes flags,
open -> parse -> extract.

Port of minivideo_tpu/apps/extractor.py: host code, imports no torch.

    python -m minivideo_tpu_torch.apps.extractor -i clip.mp4 -o outdir -v
"""

from __future__ import annotations

import argparse
import os
import sys

from ..api import mv_close, mv_extract, mv_open, mv_parse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tvid-extract",
        description="Extract tracks from media files as ES/PES streams")
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", default=".",
                   help="output directory")
    p.add_argument("-a", dest="audio", action="store_true",
                   help="extract audio tracks")
    p.add_argument("-v", dest="video", action="store_true",
                   help="extract video tracks")
    p.add_argument("-s", dest="subs", action="store_true",
                   help="extract subtitle tracks")
    p.add_argument("--pes", action="store_true",
                   help="write PES packets instead of raw ES")
    args = p.parse_args(argv)

    if not os.path.isfile(args.input):
        print(f"error: input file '{args.input}' not found",
              file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    if not (args.audio or args.video or args.subs):
        args.audio = args.video = True      # reference default: both

    media = mv_open(args.input)
    try:
        if not mv_parse(media):
            print("error: could not parse container", file=sys.stderr)
            return 1
        fmt = "pes" if args.pes else "es"
        todo = []
        if args.video:
            todo += media.tracks_video
        if args.audio:
            todo += media.tracks_audio
        if args.subs:
            todo += media.tracks_subtitles
        if not todo:
            print("error: no matching tracks", file=sys.stderr)
            return 1
        for t in todo:
            path = mv_extract(media, t, args.output, fmt)
            print(path)
        return 0
    finally:
        mv_close(media)


if __name__ == "__main__":
    sys.exit(main())
