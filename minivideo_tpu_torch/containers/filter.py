"""IDR sample filtering for thumbnail selection.

Reference: minivideo/src/demuxer/filter.c (idr_filtering :52-217): drop
frames below ~33% of the average IDR size, trim 3% borders when >48 IDRs,
then pick `picture_number` frames unfiltered / ordered / distributed.
Unlike the reference (which rewrites the sample map in place and assumes
the map is laid out as "all SPS/PPS first", filter.c:95-96), this returns
the selected sample indices.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..codecs import Container, PictureRepartition, SampleType
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


def select_pictures(media, track: Track, picture_number: int,
                    mode: PictureRepartition = PictureRepartition.UNFILTERED
                    ) -> np.ndarray:
    """Sample indices of up to `picture_number` IDR pictures of `track`.

    A sample of a raw Annex-B file (Container.ES) is one NAL unit, so a
    picture of several slices is several VIDEO_SYNC samples, which the
    reference counts as pictures: picture_number=3 of a 4-slice stream
    selects 3 slices of one picture.  Here, a difference by design, an
    IDR slice whose first_mb_in_slice is not 0 continues the picture of
    the IDR sample before it: idr_filtering runs over the pictures (each
    sized by its slices), and each picture it selects brings all its
    slices.  Every other container's sample is a whole picture, so
    there this is idr_filtering.  The grouping lives here, not in
    es_parse, because the ES tables equal the JAX package's attribute
    for attribute (ROADMAP §C): it reads the byte after each IDR
    sample's NAL header, where first_mb_in_slice begins."""
    if media.container != Container.ES:
        return idr_filtering(track, picture_number, mode)
    fh = media.file_handle
    pictures = []                 # [[sample index, ...]] per picture
    for i in track.idr_indices():
        fh.seek(int(track.sample_offset[i]) + 1)
        head = fh.read(1)
        # first_mb_in_slice is ue(v): 0 codes as a leading '1' bit
        if pictures and head and not head[0] & 0x80:
            pictures[-1].append(int(i))
        else:
            pictures.append([int(i)])
    types = track.sample_type.copy()
    sizes = track.sample_size.copy()
    for p in pictures:
        types[p[1:]] = int(SampleType.VIDEO)
        sizes[p[0]] = track.sample_size[p].sum()
    view = dataclasses.replace(track, sample_type=types, sample_size=sizes)
    slices = {p[0]: p for p in pictures}
    sel = [i for s in idr_filtering(view, picture_number, mode)
           for i in slices[int(s)]]
    return np.asarray(sel, dtype=np.int64)
