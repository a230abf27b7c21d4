"""IDR sample filtering for thumbnail selection.

Reference: minivideo/src/demuxer/filter.c (idr_filtering :52-217): drop
frames below ~33% of the average IDR size, trim 3% borders when >48 IDRs,
then pick `picture_number` frames unfiltered / ordered / distributed.
Unlike the reference (which rewrites the sample map in place and assumes
the map is laid out as "all SPS/PPS first", filter.c:95-96), this returns
the selected sample indices.
"""

from __future__ import annotations

import math

import numpy as np

from ..codecs import PictureRepartition, SampleType
from ..media import Track
from .. import trace


def idr_filtering(track: Track, picture_number: int,
                  mode: PictureRepartition = PictureRepartition.UNFILTERED
                  ) -> np.ndarray:
    """Select up to `picture_number` IDR sample indices from the track."""
    idr = track.idr_indices()
    n = len(idr)
    if n == 0:
        trace.warning("FILTER", "no IDR samples in stream")
        return idr
    picture_number = min(picture_number, n)
    if mode == PictureRepartition.UNFILTERED:
        return idr[:picture_number]

    sizes = track.sample_size[idr]
    threshold = sizes.mean() / 1.66          # ~33% cut (filter.c:110)
    borders = int(math.ceil(n * 0.03)) if n > 48 else 0
    keep = idr[borders:n - borders if borders else n]
    keep = keep[track.sample_size[keep] > threshold]
    if len(keep) == 0:
        keep = idr
    picture_number = min(picture_number, len(keep))

    if mode == PictureRepartition.ORDERED or picture_number <= 1:
        sel = keep[:picture_number]
    else:  # DISTRIBUTED (filter.c:139-187)
        step = (len(keep) - 1) / (picture_number - 1)
        sel = keep[np.round(np.arange(picture_number) * step).astype(int)]
    trace.t1("FILTER", "selected %d/%d IDRs (mode %s)", len(sel), n,
             mode.name)
    return sel
