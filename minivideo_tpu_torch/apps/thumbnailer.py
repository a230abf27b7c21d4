"""tvid-thumbnail: CLI thumbnail extractor.

Feature parity with mini_thumbnailer (reference
mini_thumbnailer/src/main.cpp:72-286): -i/-o/-f/-q/-n/-e flags, open ->
parse(video) -> decode -> export.

Port of minivideo_tpu/apps/thumbnailer.py.  `--engine` takes the
engines of settings.ENGINES: "fused" (the port's default; the JAX app's
is "np"), "wave" or "np"; `--device` names where it runs: the card by
default (raising where there is none), or "cpu", as
mv_decode(device=...).  With "fused" and "wave", BMP, TGA and PNG are
converted to RGB on that device before the readback (want_rgb), as the
JAX app does with a device engine; "np" leaves the conversion to the
host.  The decoder is imported only when a picture is decoded.

    python -m minivideo_tpu_torch.apps.thumbnailer -i clip.mp4 -o out -f png
"""

from __future__ import annotations

import argparse
import os
import sys

from ..api import mv_close, mv_decode, mv_open, mv_parse
from ..codecs import PictureFormat, PictureRepartition
from ..settings import ENGINES
from .. import trace

_FMT = {"jpg": PictureFormat.JPG, "png": PictureFormat.PNG,
        "bmp": PictureFormat.BMP, "tga": PictureFormat.TGA,
        "yuv420": PictureFormat.YUV420, "yuv444": PictureFormat.YUV444}
_MODE = {"unfiltered": PictureRepartition.UNFILTERED,
         "ordered": PictureRepartition.ORDERED,
         "distributed": PictureRepartition.DISTRIBUTED}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tvid-thumbnail",
        description="Extract thumbnails from video files (PyTorch/CUDA "
                    "port of the TPU-native MiniVideo rebuild)")
    p.add_argument("-i", dest="input", required=True,
                   help="filepath of the input video")
    p.add_argument("-o", dest="output", default=".",
                   help="directory where picture(s) will be saved")
    p.add_argument("-f", dest="format", default="png",
                   choices=sorted(_FMT), help="picture export format")
    p.add_argument("-q", dest="quality", type=int, default=75,
                   help="export quality (1-100)")
    p.add_argument("-n", dest="number", type=int, default=1,
                   help="number of pictures to export (1-999)")
    p.add_argument("-e", dest="mode", default="unfiltered",
                   choices=sorted(_MODE), help="picture extraction mode")
    p.add_argument("--engine", default="fused", choices=ENGINES,
                   help="reconstruction engine (fused: the CUDA wave "
                        "kernel on the card, its plain PyTorch version "
                        "on the CPU; wave: the wave loop as torch ops "
                        "on the device; np: the numpy oracle on the "
                        "host)")
    p.add_argument("--device", default=None,
                   help="torch device to decode on (default: the CUDA "
                        "card; 'cpu' runs the plain engine)")
    args = p.parse_args(argv)

    if not os.path.isfile(args.input):
        print(f"error: input file '{args.input}' not found",
              file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)

    from ..export.image import export_picture
    fmt = _FMT[args.format]
    # RGB formats on a device engine: convert on the decode's device
    # before the readback (ops/color.py) — no host conversion pass
    want_rgb = fmt in (PictureFormat.BMP, PictureFormat.TGA,
                       PictureFormat.PNG) and args.engine != "np"
    media = mv_open(args.input)
    try:
        if not mv_parse(media, audio=False, video=True, subs=False):
            print("error: could not parse container", file=sys.stderr)
            return 1
        pics = mv_decode(media, picture_number=max(1, min(args.number, 999)),
                         mode=_MODE[args.mode], engine=args.engine,
                         device=args.device, want_rgb=want_rgb)
        if not pics:
            print("error: no pictures decoded", file=sys.stderr)
            return 1
        base = os.path.join(args.output, media.file_name)
        for i, pic in enumerate(pics):
            suffix = f"_{i}" if len(pics) > 1 else ""
            y, cb, cr = pic.cropped()
            rgb = pic.cropped_rgb() if (want_rgb
                                        and pic.rgb is not None) else None
            path = export_picture(f"{base}{suffix}", fmt,
                                  y, cb, cr, args.quality, rgb=rgb)
            print(path)
        return 0
    finally:
        mv_close(media)


if __name__ == "__main__":
    sys.exit(main())
