"""H.264 intra decoder: Annex-B stream -> decoded pictures.

Port of minivideo_tpu/models/h264/decoder.py, with its three
reconstruction engines (settings.ENGINES):
  "fused" (the default) - every IDR picture is entropy-parsed by the
      native parser into slab staging (the records or the device layout,
      settings.staging_mode) and each group of pictures sharing an
      SPS/PPS is reconstructed in one batch by ops/recon_fused (the CUDA
      kernel on a GPU, its plain PyTorch version on the CPU);
  "wave" - the same batches in raster staging through the wave loop
      (ops/recon_wave.py), torch ops on the decoder's device;
  "np" - picture by picture through the numpy oracle
      (models/h264/recon_np.py) on the host, as the JAX package's
      default engine.
Under MINIVIDEO_TPU_NO_NATIVE=1 the Python CAVLC/CABAC parsers fill
raster staging instead; a part whose slab parse fails is parsed again
picture by picture into raster staging, dropping the pictures that fail,
as the reference drops bad IDR pictures.  With want_rgb the batched
engines also convert the planes to RGB888 on the decode's device
(ops/color.py) before they are read back; under "np" the RGB is left to
the host (DecodedPicture.cropped_rgb).

Reference: h264_decode (minivideo/src/decoder/h264/h264.c:41-206) — NALU
loop dispatching on nal_unit_type {5 IDR, 6 SEI, 7 SPS, 8 PPS}, with its
tolerance for per-NALU errors.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ... import trace
from ...bitio import BitReader, BitstreamError
from ...device import resolve_device
from ...native import (parse_slice_native, parse_slice_native_slab,
                       parse_slice_native_slab2)
from ...ops.recon import (make_slab_staging, make_slab_staging2,
                          pack_frames, pack_frames_slots, pack_frames_slots2,
                          zero_uncovered)
from ...ops.color import yuv420_to_rgb_device
from ...ops.recon_fused import reconstruct_frames_fused, to_device
from ...ops.recon_wave import reconstruct_frames_wave
from ...profiling import span
from ...settings import ENGINES, staging_mode as _staging_mode
from .cabac import CabacSliceParser
from .expgolomb import read_ue
from .nalu import Nalu, NaluType, parse_nalu, split_annexb
from .params import UnsupportedStream, parse_pps, parse_sei, parse_sps
from .recon_np import reconstruct_frame
from .slicehdr import parse_slice_header
from .syntax import CavlcSliceParser, FrameSyntax

MAX_CONSECUTIVE_ERRORS = 64  # reference: h264.c:181-187


def resolve_engine(engine: str) -> str:
    """Map the user-facing engine name to a backend of the port:
    "fused", "wave" or "np" (settings.ENGINES).  "jax", the JAX package's
    production alias, is "fused" on every device (the JAX package maps it
    to "wave" on a CPU backend); an unknown name raises."""
    if engine == "jax":
        return "fused"
    if engine in ENGINES:
        return engine
    raise ValueError(f"unknown engine {engine!r} (one of {ENGINES} or "
                     f"'jax')")


@dataclass
class DecodedPicture:
    """One decoded IDR picture: 4:2:0 planes + display crop."""
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    width: int          # cropped display width
    height: int
    idr_index: int = 0
    syntax: object = None    # FrameSyntax (kept for tests)
    rgb: np.ndarray = None   # RGB888 of the uncropped planes, converted
    #                          on the decode's device (ops/color.py),
    #                          set when the decode requested RGB output

    def cropped(self):
        return (self.y[:self.height, :self.width],
                self.cb[:self.height // 2, :self.width // 2],
                self.cr[:self.height // 2, :self.width // 2])

    def cropped_rgb(self):
        """Display-cropped RGB888: the device-converted plane when the
        decode produced one, else the host conversion of the cropped
        planes (the same bytes at even crops)."""
        if self.rgb is not None:
            return self.rgb[:self.height, :self.width]
        from ...export.image import yuv420_to_rgb_py
        return yuv420_to_rgb_py(*self.cropped())


class H264Decoder:
    """Stateful NALU-stream decoder (SPS/PPS context + IDR decoding)."""

    def __init__(self, engine: str = "fused", device=None,
                 want_rgb: bool = False):
        self.sps_map: dict = {}
        self.pps_map: dict = {}
        self.engine = resolve_engine(engine)
        self.device = resolve_device(device)
        self.idr_count = 0
        # convert to RGB888 on the device, before the readback
        self.want_rgb = want_rgb

    # -- NALU feed -----------------------------------------------------------

    def feed_nalu(self, nalu: Nalu):
        """Process one NALU; returns a DecodedPicture for an IDR slice
        (a one-slice picture), else None."""
        t = nalu.nal_unit_type
        if t == NaluType.SPS:
            sps = parse_sps(nalu.rbsp)
            self.sps_map[sps.seq_parameter_set_id] = sps
            return None
        if t == NaluType.PPS:
            pps = parse_pps(nalu.rbsp, self.sps_map)
            self.pps_map[pps.pic_parameter_set_id] = pps
            return None
        if t == NaluType.SEI:
            parse_sei(nalu.rbsp)
            return None
        if t == NaluType.SLICE_IDR:
            return self._decode_idr([nalu])
        if t == NaluType.SLICE:
            trace.t1("H264", "skipping non-IDR slice NALU")
            return None
        if t in (NaluType.PREFIX, NaluType.SLICE_SVC):
            raise UnsupportedStream("SVC/MVC NALUs")
        trace.t2("NALU", "ignoring NALU type %d", int(t))
        return None

    # -- picture decoding ----------------------------------------------------

    def parse_idr_syntax(self, nalus) -> tuple:
        """Entropy-decode the slices of one IDR picture into a (full)
        FrameSyntax.  `nalus` is a list of SLICE_IDR Nalu objects covering
        the picture.  Returns (FrameSyntax, SPS, PPS, slice_of_mb)."""
        fs = None
        sps = pps = None
        slice_of_mb = None
        for snum, nalu in enumerate(nalus):
            sh, sps, pps = parse_slice_header(
                nalu.rbsp, nalu.nal_unit_type, nalu.nal_ref_idc,
                self.sps_map, self.pps_map)
            if fs is None:
                fs = FrameSyntax(sps.pic_width_in_mbs,
                                 sps.pic_height_in_map_units)
                slice_of_mb = np.full(fs.n_mbs, -1, dtype=np.int32)
            n = self._parse_slice(nalu, sh, sps, pps, fs)
            slice_of_mb[sh.first_mb_in_slice:sh.first_mb_in_slice + n] = snum
            trace.t1("SLICE", "decoded slice: %d MBs from %d",
                     n, sh.first_mb_in_slice)
        return fs, sps, pps, slice_of_mb

    def _parse_slice(self, nalu, sh, sps, pps, fs):
        """Entropy-decode one slice into fs: the native raster parse, or
        the Python parsers under MINIVIDEO_TPU_NO_NATIVE=1."""
        if os.environ.get("MINIVIDEO_TPU_NO_NATIVE") != "1":
            return parse_slice_native(
                fs, nalu.rbsp, sh.data_bit_offset,
                sh.first_mb_in_slice, sh.qp,
                bool(pps.entropy_coding_mode_flag),
                bool(pps.transform_8x8_mode_flag))
        if pps.entropy_coding_mode_flag:
            parser = CabacSliceParser(nalu.rbsp, sh, sps, pps, fs)
        else:
            r = BitReader(nalu.rbsp, start_bit=sh.data_bit_offset)
            parser = CavlcSliceParser(r, sh, sps, pps, fs)
        return parser.parse_slice_data()

    def parse_groups_slab(self, groups, sps, pps, staging_mode=None,
                          pool=None):
        """Entropy-parse many pictures straight into slab staging with the
        native parser, on the host only.  groups: list of NALU lists, all
        sharing sps/pps.

        Two staging layouts, chosen by settings.staging_mode():
          "records" - slot records: the parser's host writes are cheaper,
            the card builds the meta rows and transposes the slabs
            (ops/slab.py feeds);
          "device" - one MB-major record per macroblock, coefficients and
            meta rows, each written whole by the parser (the MBs no
            slice wrote are zeroed here); the card lays them out into
            the kernel's feeds (ops/wave_layout.py).

        `pool` (optional ThreadPoolExecutor) parses every (picture, slice)
        task concurrently: slices are entropy-independent and the native
        parse releases the GIL.
        Returns (PackedFrames, [(FrameSyntax, slice_of_mb), ...])."""
        mode = staging_mode or _staging_mode()
        wmb = sps.pic_width_in_mbs
        hmb = sps.pic_height_in_map_units
        if mode == "device":
            staging = make_slab_staging2(wmb, hmb, len(groups))
        else:
            staging = make_slab_staging(wmb, hmb, len(groups))

        def parse_one(i, fs, sh, nalu):
            if mode == "device":
                return parse_slice_native_slab2(
                    fs, staging, i, nalu.rbsp, sh.data_bit_offset,
                    sh.first_mb_in_slice, sh.qp,
                    bool(pps.entropy_coding_mode_flag),
                    bool(pps.transform_8x8_mode_flag),
                    cb_qp_off=pps.chroma_qp_index_offset,
                    cr_qp_off=pps.second_chroma_qp_index_offset)
            return parse_slice_native_slab(
                fs, staging, i, nalu.rbsp, sh.data_bit_offset,
                sh.first_mb_in_slice, sh.qp,
                bool(pps.entropy_coding_mode_flag),
                bool(pps.transform_8x8_mode_flag))

        frames = []
        tasks = []                # (future, slice_of_mb, snum, first_mb)
        for i, nalus in enumerate(groups):
            fs = FrameSyntax(wmb, hmb, lite=True)
            slice_of_mb = np.full(fs.n_mbs, -1, dtype=np.int32)
            for snum, nalu in enumerate(nalus):
                sh, _, _ = parse_slice_header(
                    nalu.rbsp, nalu.nal_unit_type, nalu.nal_ref_idc,
                    self.sps_map, self.pps_map)
                if pool is not None:
                    tasks.append((pool.submit(parse_one, i, fs, sh, nalu),
                                  slice_of_mb, snum,
                                  sh.first_mb_in_slice))
                else:
                    n = parse_one(i, fs, sh, nalu)
                    slice_of_mb[sh.first_mb_in_slice:
                                sh.first_mb_in_slice + n] = snum
            frames.append((fs, slice_of_mb))
        for fut, slice_of_mb, snum, first_mb in tasks:
            n = fut.result()
            slice_of_mb[first_mb:first_mb + n] = snum
        if mode == "device":
            zero_uncovered(staging, [som for _, som in frames])
            return pack_frames_slots2(staging, sps, pps), frames
        return pack_frames_slots(staging, frames, sps, pps), frames

    def stage_groups(self, groups, sps, pps, pool=None,
                     staging_mode=None):
        """Parse pictures sharing sps/pps into staging and copy it to the
        decoder's device.  `staging_mode`: "records" or "device" (slab
        staging, parse_groups_slab; default settings.staging_mode()), or
        "raster" (parse_idr_syntax per picture, then pack_frames).
        Returns (parsed_groups, PackedFrames with its arrays as tensors
        there), the arguments of reconstruct_batch.  Spans
        "decode.parse" and "decode.stage" (the copy, enqueued)."""
        with span("decode.parse", len(groups)):
            if staging_mode == "raster":
                parsed = [self.parse_idr_syntax(g) for g in groups]
                packed = pack_frames([(fs, som) for fs, _, _, som in parsed],
                                     sps, pps)
            else:
                packed, frames = self.parse_groups_slab(groups, sps, pps,
                                                        staging_mode, pool)
                parsed = [(fs, sps, pps, som) for fs, som in frames]
        with span("decode.stage", len(groups)):
            return parsed, to_device(packed, self.device)

    def reconstruct_batch(self, parsed_groups, packed=None):
        """Reconstruct MANY parsed pictures in one engine batch on the
        decoder's device: the fused engine, or the wave engine ("wave"
        and, as in the JAX package, any engine but "fused").
        parsed_groups: list of (fs, sps, pps, slice_of_mb) sharing one
        SPS/PPS; `packed` may be their prebuilt staging (parse_groups_slab
        or stage_groups; raster only for the wave engine), else they are
        packed in raster staging.  With want_rgb the uncropped planes are
        converted to RGB888 there and read back with them."""
        _, sps, pps, _ = parsed_groups[0]
        if packed is None:
            packed = pack_frames([(fs, som) for fs, _, _, som
                                  in parsed_groups], sps, pps)
        if self.engine == "fused":
            with span("decode.stage", len(parsed_groups)):
                packed = to_device(packed, self.device)
            planes = reconstruct_frames_fused(packed, self.device)
        else:
            planes = reconstruct_frames_wave(packed, self.device)
        rgbb = (yuv420_to_rgb_device(*planes).cpu().numpy()
                if self.want_rgb else None)
        yb, cbb, crb = (p.cpu().numpy() for p in planes)
        pics = []
        for i, (fs, _, _, _) in enumerate(parsed_groups):
            pics.append(DecodedPicture(
                y=yb[i], cb=cbb[i], cr=crb[i],
                width=sps.cropped_width, height=sps.cropped_height,
                idr_index=self.idr_count, syntax=fs,
                rgb=rgbb[i] if rgbb is not None else None))
            self.idr_count += 1
        return pics

    def _decode_idr(self, nalus):
        """Decode one IDR picture (its slice NALUs): the numpy oracle on
        the host under "np" (rgb left to the host), else a batch of one."""
        fs, sps, pps, slice_of_mb = self.parse_idr_syntax(nalus)
        if self.engine != "np":
            return self.reconstruct_batch([(fs, sps, pps, slice_of_mb)])[0]
        y, cb, cr = reconstruct_frame(fs, sps, pps, slice_of_mb)
        pic = DecodedPicture(
            y=y, cb=cb, cr=cr,
            width=sps.cropped_width, height=sps.cropped_height,
            idr_index=self.idr_count, syntax=fs)
        self.idr_count += 1
        return pic


def _partition(dec, group_iter, max_pictures, errors):
    """Partition consecutive picture groups by their (SPS, PPS)
    configuration, peeked from the first slice header of each group.
    Returns ([(sps, pps, groups), ...] holding at most max_pictures
    pictures (0: all), the error count)."""
    parts = []
    for group in group_iter:
        try:
            sh, sps, pps = parse_slice_header(
                group[0].rbsp, group[0].nal_unit_type,
                group[0].nal_ref_idc, dec.sps_map, dec.pps_map)
        except (ValueError, BitstreamError) as e:
            trace.warning("H264", "slice header error: %s", e)
            errors += 1
            if errors > MAX_CONSECUTIVE_ERRORS:
                break
            continue
        if parts and parts[-1][0] is sps and parts[-1][1] is pps:
            parts[-1][2].append(group)
        else:
            parts.append((sps, pps, [group]))
        if max_pictures and sum(len(p[2]) for p in parts) >= max_pictures:
            break
    if max_pictures:
        total = 0
        for k, (sps, pps, groups) in enumerate(parts):
            if total + len(groups) > max_pictures:
                parts[k] = (sps, pps, groups[:max_pictures - total])
                del parts[k + 1:]
                break
            total += len(groups)
    return parts, errors


def _decode_batched(dec, group_iter, max_pictures, errors):
    """The decode path of the batched engines: entropy-parse every
    selected picture first, then reconstruct groups sharing an SPS/PPS
    configuration in ONE engine batch.  Slab staging for the fused
    engine (unless MINIVIDEO_TPU_NO_NATIVE=1), raster for the wave
    engine."""
    use_slab = (dec.engine == "fused"
                and os.environ.get("MINIVIDEO_TPU_NO_NATIVE") != "1")
    parts, errors = _partition(dec, group_iter, max_pictures, errors)
    pictures = []
    pool = None
    if use_slab and (os.cpu_count() or 1) > 1:
        pool = ThreadPoolExecutor(max_workers=os.cpu_count())
    try:
        _decode_batched_parts(dec, parts, pictures, pool, use_slab, errors)
    finally:
        if pool is not None:
            pool.shutdown()
    return pictures


def _decode_batched_parts(dec, parts, pictures, pool, use_slab, errors):
    """Parse and reconstruct each (SPS, PPS) part as one batch.  Where the
    slab parse of a part fails, its pictures are parsed again one by one
    into raster staging, and those that fail are dropped, counted as
    errors (reference: h264.c:181-187).  Only the host parse is inside a
    `try`: the staging copy and the reconstruction raise."""
    for sps, pps, groups in parts:
        with span("decode.parse", len(groups)):
            packed = None
            parsed = None
            if use_slab:
                try:
                    packed, frames = dec.parse_groups_slab(groups, sps, pps,
                                                           pool=pool)
                    parsed = [(fs, sps, pps, som) for fs, som in frames]
                except (RuntimeError, ValueError, BitstreamError) as e:
                    trace.warning("H264", "slab parse failed (%s); "
                                  "falling back to raster", e)
                    packed = None
            if packed is None:
                parsed = []
                for group in groups:
                    try:
                        parsed.append(dec.parse_idr_syntax(group))
                    except UnsupportedStream:
                        raise
                    except (ValueError, BitstreamError) as e:
                        trace.warning("H264", "IDR parse error: %s", e)
                        errors += 1
                        if errors > MAX_CONSECUTIVE_ERRORS:
                            break
                if not parsed:
                    continue
        pictures.extend(dec.reconstruct_batch(parsed, packed=packed))


def group_idr_access_units(nalus):
    """Group consecutive SLICE_IDR NALUs into access units (pictures):
    a new picture starts where first_mb_in_slice == 0."""
    groups = []
    current = []
    for n in nalus:
        if n.nal_unit_type != NaluType.SLICE_IDR:
            continue
        first_mb = read_ue(BitReader(n.rbsp))
        if first_mb == 0 and current:
            groups.append(current)
            current = []
        current.append(n)
    if current:
        groups.append(current)
    return groups


def _open_stream(data: bytes, engine: str, device, want_rgb=False):
    """Split `data` into NALUs, feed every non-IDR NALU (parameter sets,
    SEI) to a new decoder and group the IDR slices into pictures.
    Returns (decoder, picture groups, error count); tolerates per-NALU
    errors as the reference's h264_decode() main loop (h264.c:76-188)."""
    with span("decode.nalu", nbytes=len(data)):
        dec = H264Decoder(engine=engine, device=device, want_rgb=want_rgb)
        errors = 0
        nalus = []
        for off, raw in split_annexb(data):
            try:
                nalus.append(parse_nalu(raw, off))
            except (ValueError, BitstreamError) as e:
                trace.warning("NALU", "bad NALU at %d: %s", off, e)
                errors += 1
                if errors > MAX_CONSECUTIVE_ERRORS:
                    break
        idr_groups = group_idr_access_units(nalus)
        for n in nalus:
            if n.nal_unit_type == NaluType.SLICE_IDR:
                continue
            try:
                dec.feed_nalu(n)
            except UnsupportedStream:
                raise
            except (ValueError, BitstreamError) as e:
                trace.warning("H264", "NALU decode error: %s", e)
                errors += 1
                if errors > MAX_CONSECUTIVE_ERRORS:
                    break
    return dec, idr_groups, errors


def stage_annexb(data: bytes, device=None, pool=None, staging_mode=None):
    """The front half of decode_annexb: every IDR picture of `data`
    parsed into staging (`staging_mode`, see H264Decoder.stage_groups) on
    `device`, one batch per (SPS, PPS) part.
    Returns [(parsed_groups, PackedFrames), ...], the arguments of
    H264Decoder.reconstruct_batch, the back half.  Staging does not
    depend on RGB output: pass want_rgb to the H264Decoder whose
    reconstruct_batch runs the back half."""
    dec, groups, errors = _open_stream(data, "fused", device)
    parts, _ = _partition(dec, iter(groups), 0, errors)
    return [dec.stage_groups(g, sps, pps, pool, staging_mode)
            for sps, pps, g in parts]


def decode_annexb(data: bytes, max_pictures: int = 0, engine: str = "fused",
                  device=None, want_rgb: bool = False):
    """Decode an Annex-B byte stream; returns a list of DecodedPicture.

    engine: "fused" (default), "wave" or "np" (see the module docstring).
    device=None decodes on the GPU and raises when there is none, for
    every engine; device="cpu" runs the batched engines' torch ops on the
    CPU ("np" computes on the host either way).  want_rgb: the batched
    engines also return RGB888 converted on that device
    (DecodedPicture.rgb)."""
    dec, idr_groups, errors = _open_stream(data, engine, device, want_rgb)
    if dec.engine != "np":
        return _decode_batched(dec, iter(idr_groups), max_pictures, errors)
    pictures = []
    for group in idr_groups:
        try:
            pictures.append(dec._decode_idr(group))
        except UnsupportedStream:
            raise
        except (ValueError, BitstreamError) as e:
            trace.warning("H264", "IDR decode error: %s", e)
            errors += 1
            if errors > MAX_CONSECUTIVE_ERRORS:
                break
        if max_pictures and len(pictures) >= max_pictures:
            break
    return pictures
