"""Batch thumbnailing, sharded across devices and processes: N clips ->
thumbnails.

Port of minivideo_tpu/parallel/batch.py.  This is the
batch equivalent of running the reference's mini_thumbnailer once per
file (SURVEY.md §2.6: the reference is single threaded; the workload is
embarrassingly parallel across clips).  The pipeline has four stages:

  host demux   — container parse + IDR selection + slice headers per
                 clip on a thread pool;
  host entropy — all selected frames of a geometry bucket entropy-
                 decode straight into ONE slab staging batch (the device
                 or records layout, settings.staging_mode), every
                 picture fanned across the pool (the native C++ parser
                 releases the GIL); per-frame parse failures zero that
                 frame (parsed=0 rows reconstruct as black) and fail
                 only the owning clip.  Under MINIVIDEO_TPU_NO_NATIVE=1
                 the clips are parsed with the Python parsers into
                 raster staging instead;
  device recon — the bucket batch is padded to the mesh size, split
                 into one contiguous run of frames per mesh entry and
                 copied to that entry's device (sharding.py), and each
                 shard runs the fused engine once there:
                 csrc/wave_kernel.cu on the card, its plain PyTorch
                 version on the CPU (the "wave" and "np"
                 engines: raster staging through the wave loop,
                 ops/recon_wave.py, as the JAX module runs its wave
                 engine for both); for RGB formats the planes are
                 converted there (ops/color.py, not under "np") and read
                 back with the RGB;
  host export  — image encode + write on a thread pool.

Failure isolation: any per-clip exception is caught, recorded in the
Manifest, and the batch continues (reference analogue: jumpy_* resync +
the 64-error tolerance, h264.c:181-187 — but scoped per clip, not
per NALU).  Resume: clips already marked done in the manifest are
skipped.

Where the port differs from the JAX module: a named `device` runs as a
1x1 mesh of that device, as mv_decode; a mesh may name one device more
than once (sharding.py), and its shards run from one thread per distinct
device of this process, a device's shards one after another; the
process index and count come from torch.distributed; the JAX compile
cache has no counterpart; and the RGB of RGB formats is converted on
each shard's device before the readback instead of after it.  The
decoder is imported only when the function is called, so importing this
module loads no torch.
"""

from __future__ import annotations

import os
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .. import trace
from ..codecs import PictureFormat, PictureRepartition
from ..profiling import carry, span
from .manifest import Manifest
from .sharding import Mesh, make_mesh, shard_frames

_RGB_FORMATS = (PictureFormat.PNG, PictureFormat.BMP, PictureFormat.TGA)


@dataclass
class ParsedClip:
    path: str
    frames: list            # [(FrameSyntax, slice_of_mb), ...]
    sps: object
    pps: object
    file_name: str


@dataclass
class DemuxedClip:
    path: str
    pictures: list          # [[(nalu, slice_header), ...], ...]
    sps: object
    pps: object
    file_name: str


@dataclass
class BatchResult:
    done: int = 0
    failed: int = 0
    skipped: int = 0
    frames: int = 0
    outputs: list = field(default_factory=list)
    errors: dict = field(default_factory=dict)


def _demux_groups(path: str, pictures: int, mode, device):
    """Demux one clip, select IDR pictures, return (decoder-with-
    paramsets, NALU groups, file_name)."""
    from ..api import mv_close, mv_open, mv_parse
    from ..containers.filter import select_pictures
    from ..containers.mp4 import avcc_to_annexb
    from ..codecs import Codec, Container
    from ..models.h264.decoder import H264Decoder, group_idr_access_units
    from ..models.h264.nalu import parse_nalu, split_annexb
    from ..models.h264.params import UnsupportedStream

    media = mv_open(path)
    try:
        if not mv_parse(media, audio=False, video=True, subs=False):
            raise ValueError("container parse failed")
        if not media.tracks_video:
            raise ValueError("no video track")
        track = media.tracks_video[0]
        if track.stream_codec not in (Codec.H264, Codec.UNKNOWN):
            raise UnsupportedStream(
                f"{track.stream_codec.name} (H.264 intra only)")
        selected = select_pictures(media, track, pictures, mode)
        if len(selected) == 0:
            raise ValueError("no IDR pictures found")

        fh = media.file_handle
        length_prefixed = (track.length_prefixed
                           or media.container == Container.MP4)
        out = bytearray()
        for ps in track.parameter_sets:
            out += b"\x00\x00\x00\x01" + ps
        for i in track.param_indices():
            raw = track.read_sample(fh, i)
            if not length_prefixed:
                out += (raw if raw.startswith((b"\x00\x00\x01",
                                               b"\x00\x00\x00\x01"))
                        else b"\x00\x00\x00\x01" + raw)
        for i in selected:
            raw = track.read_sample(fh, int(i))
            if length_prefixed:
                out += avcc_to_annexb(
                    raw, getattr(track, "nal_length_size", 4))
            else:
                out += (raw if raw.startswith((b"\x00\x00\x01",
                                               b"\x00\x00\x00\x01"))
                        else b"\x00\x00\x00\x01" + raw)

        # the decoder holds the parameter sets and parses on the host;
        # it never reconstructs (that is _Recon's, per bucket)
        dec = H264Decoder(device=device)
        nalus = [parse_nalu(r, off) for off, r in split_annexb(bytes(out))]
        for n in nalus:
            if n.nal_unit_type in (7, 8):      # SPS / PPS
                dec.feed_nalu(n)
        groups = group_idr_access_units(nalus)[:pictures]
        if not groups:
            raise ValueError("no decodable IDR access units")
        return dec, groups, media.file_name
    finally:
        mv_close(media)


def _parse_clip(path: str, pictures: int, mode, device) -> ParsedClip:
    """Demux + entropy-parse one clip's selected IDR pictures (host;
    raster path — the wave and np engines' and the
    MINIVIDEO_TPU_NO_NATIVE=1 route)."""
    with span("batch.demux_file", 1):
        dec, groups, file_name = _demux_groups(path, pictures, mode, device)
        frames = []
        sps = pps = None
        for group in groups:
            fs, sps, pps, som = dec.parse_idr_syntax(group)
            frames.append((fs, som))
    return ParsedClip(path, frames, sps, pps, file_name)


def _demux_clip(path: str, pictures: int, mode, device) -> DemuxedClip:
    """Demux one clip + parse its slice headers (no entropy decode —
    that happens bucket-wide, straight into slab staging)."""
    from ..models.h264.slicehdr import parse_slice_header
    with span("batch.demux_file", 1):
        dec, groups, file_name = _demux_groups(path, pictures, mode, device)
        pics = []
        sps = pps = None
        for group in groups:
            pic = []
            for nalu in group:
                sh, sps, pps = parse_slice_header(
                    nalu.rbsp, nalu.nal_unit_type, nalu.nal_ref_idc,
                    dec.sps_map, dec.pps_map)
                pic.append((nalu, sh))
            pics.append(pic)
    return DemuxedClip(path, pics, sps, pps, file_name)


def _parse_bucket_slab(dcs, pool, staging_mode):
    """Entropy-decode every selected frame of a geometry bucket into ONE
    slab staging batch.  Frames fan across `pool`; a parse failure
    ZEROES that frame's rows (parsed=0 reconstructs as black) and
    reports the owning clip instead of failing the bucket.  In the
    device mode the MBs no slice wrote are zeroed too (zero_uncovered).

    Returns (PackedFrames, owners=[(clip, frame_idx)], failed={path:
    error})."""
    from ..models.h264.syntax import FrameSyntax
    from ..native import (parse_slice_native_slab,
                          parse_slice_native_slab2)
    from ..ops.recon import (make_slab_staging, make_slab_staging2,
                             pack_frames_slots, pack_frames_slots2,
                             zero_uncovered)
    sps = dcs[0].sps
    wmb, hmb = sps.pic_width_in_mbs, sps.pic_height_in_map_units
    rows = [(dc, fi) for dc in dcs for fi in range(len(dc.pictures))]
    B = len(rows)
    mk = make_slab_staging2 if staging_mode == "device" else \
        make_slab_staging
    staging = mk(wmb, hmb, B)
    fss = [FrameSyntax(wmb, hmb, lite=True) for _ in range(B)]
    soms = [np.full(wmb * hmb, -1, np.int32) for _ in range(B)]
    failed: dict = {}

    def parse_frame(i):
        dc, fi = rows[i]
        pps = dc.pps
        with span("batch.parse_picture", 1, nbytes=sum(
                len(nalu.rbsp) for nalu, _ in dc.pictures[fi])):
            for snum, (nalu, sh) in enumerate(dc.pictures[fi]):
                with span("batch.parse_slice", 1, nbytes=len(nalu.rbsp)):
                    if staging_mode == "device":
                        n = parse_slice_native_slab2(
                            fss[i], staging, i, nalu.rbsp,
                            sh.data_bit_offset, sh.first_mb_in_slice, sh.qp,
                            bool(pps.entropy_coding_mode_flag),
                            bool(pps.transform_8x8_mode_flag),
                            cb_qp_off=pps.chroma_qp_index_offset,
                            cr_qp_off=pps.second_chroma_qp_index_offset)
                    else:
                        n = parse_slice_native_slab(
                            fss[i], staging, i, nalu.rbsp,
                            sh.data_bit_offset, sh.first_mb_in_slice, sh.qp,
                            bool(pps.entropy_coding_mode_flag),
                            bool(pps.transform_8x8_mode_flag))
                first = sh.first_mb_in_slice
                soms[i][first:first + n] = snum

    task = carry(parse_frame)
    futs = {pool.submit(task, i): i for i in range(B)}
    for fut, i in futs.items():
        try:
            fut.result()
        except Exception as e:             # noqa: BLE001 — isolation
            dc, fi = rows[i]
            failed[dc.path] = f"{type(e).__name__}: {e}"
            fss[i].parsed[:] = 0           # frame reconstructs as black
            soms[i][:] = -1

    owners = rows
    if staging_mode == "device":
        zero_uncovered(staging, soms)
        packed = pack_frames_slots2(staging, sps, dcs[0].pps)
    else:
        packed = pack_frames_slots(staging, [(fs, None) for fs in fss],
                                   sps, dcs[0].pps)
    return packed, owners, failed


class _Recon:
    """The bucket reconstruction over a mesh: the bucket padded to the
    mesh size and split into one contiguous run of frames per mesh entry
    (sharding.shard_frames, which pads on the entries' devices and is
    also the staging copy), then per
    entry, on its device: the fused engine (reconstruct_frames_fused:
    one wave_kernel.cu launch on the card, the plain loop on the CPU) or,
    for every other engine, the wave loop (reconstruct_frames_wave,
    raster staging), and the RGB conversion there when asked; then the
    readback, concatenated and trimmed to the real batch.  The JAX class
    caches one jitted, sharded function per (geometry, batch, features,
    layout); the port's reconstructors compile nothing per shape (the
    CUDA library is built once per checkout), so there is nothing to
    cache."""

    def __init__(self, mesh, engine: str):
        from ..models.h264.decoder import resolve_engine
        self.mesh = mesh
        self.engine = resolve_engine(engine)

    def __call__(self, packed, want_rgb: bool = False):
        """packed: PackedFrames (any staging layout) -> (Y, Cb, Cr,
        RGB or None) numpy, one row per real frame."""
        import dataclasses
        from ..ops import recon_fused
        from ..ops.color import yuv420_to_rgb_device
        from ..ops.recon_wave import reconstruct_frames_wave
        fused = self.engine == "fused"
        devs = list(self.mesh.devices.flat)
        shards = [None] * len(devs)

        def stage(entries):
            for i in entries:
                shards[i] = shard_frames(packed.arrays, i, len(devs),
                                         devs[i])

        # The shards of each device are copied by a thread of its own, so
        # the cards' copies overlap (entries that share a device, as a
        # 2x2 mesh of one card, are copied in mesh order by one thread).
        # Then every shard is launched from here, unchecked, so no card
        # waits on the host for another card's kernel, and one
        # check_waits() before the first readback raises for a row
        # timeout on any card.
        by_dev: dict = {}
        for i, d in enumerate(devs):
            by_dev.setdefault(d, []).append(i)
        with span("batch.stage", packed.batch), \
                ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
            for fut in [pool.submit(stage, e) for e in by_dev.values()]:
                fut.result()
        outs = []
        with span("batch.launch", packed.batch):
            for arrs, dev in zip(shards, devs):
                shard = dataclasses.replace(packed, arrays=arrs)
                shard.__dict__["haspcm"] = packed.haspcm  # the batch's flag
                planes = (recon_fused.reconstruct_frames_fused(
                    shard, dev, check=False) if fused
                    else reconstruct_frames_wave(shard, dev))
                rgb = yuv420_to_rgb_device(*planes) if want_rgb else None
                outs.append((*planes, rgb))
        # the kernels' waits, the blocking copies back, one array a plane
        with span("batch.readback", packed.batch):
            if fused:
                recon_fused.check_waits()
            host = [[p.cpu().numpy() for p in out if p is not None]
                    for out in outs]
            cols = [np.concatenate(c)[:packed.batch] for c in zip(*host)]
        return (*cols[:3], cols[3] if want_rgb else None)


def _mesh_of(mesh, device):
    """The mesh batch_thumbnail runs on: `mesh`; a named `device` as a
    1x1 mesh; else sharding.make_mesh() over every card (no card:
    raises)."""
    from ..device import resolve_device
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        return mesh
    if device is None:
        return make_mesh()
    return Mesh(np.array([[resolve_device(device)]], dtype=object),
                ("data", "seq"))


def _process_group():
    """(rank, world size) of the initialised torch.distributed process
    group, else (0, 1): the counterpart of jax.process_index() /
    jax.process_count()."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def batch_thumbnail(clips, outdir, *, pictures_per_clip: int = 1,
                    mode=PictureRepartition.UNFILTERED,
                    fmt=PictureFormat.PNG, quality: int = 75,
                    mesh=None, device=None, engine: str = "fused",
                    manifest_path: str | None = None,
                    process_index: int | None = None,
                    process_count: int | None = None,
                    parse_workers: int | None = None,
                    io_workers: int = 8) -> BatchResult:
    """Thumbnail a list of clips, sharded across the entries of `mesh`
    (sharding.make_mesh) and across processes.  Without a mesh it runs
    on a named `device` alone ("cpu" runs the engine's torch ops there),
    else, as the JAX module, over make_mesh(): every card, a 1x1 mesh of
    cuda:0 on a one-card host (no card raises); passing a mesh and a
    device raises.  engine: "fused"
    (default; one wave_kernel launch per mesh entry and bucket on the
    card), "wave" or "np" (both the wave loop, without device RGB under
    "np").  process_index / process_count default to the rank and world
    size of an initialised torch.distributed process group, else 0 / 1;
    each process takes every process_count-th clip."""
    from ..export.image import export_picture
    from ..ops.recon import pack_frames

    mesh = _mesh_of(mesh, device)        # no card: raises
    device = mesh.devices.flat[0]
    rank, world = _process_group()
    if process_index is None:
        process_index = rank
    if process_count is None:
        process_count = world
    my_clips = list(clips)[process_index::process_count]

    os.makedirs(outdir, exist_ok=True)
    if manifest_path is None:
        manifest_path = os.path.join(
            outdir, f"manifest.{process_index}.jsonl")
    if parse_workers is None:
        parse_workers = min(32, (os.cpu_count() or 4))

    from ..profiling import StageTimer, device_trace
    timer = StageTimer()
    result = BatchResult()

    # production path: entropy-parse whole buckets straight into the
    # slab staging the fused engine consumes; the wave and np engines and
    # MINIVIDEO_TPU_NO_NATIVE=1 keep the raster path
    recon = _Recon(mesh, engine)
    use_slab = (recon.engine == "fused"
                and os.environ.get("MINIVIDEO_TPU_NO_NATIVE") != "1")

    with Manifest(manifest_path) as man:
        with span("batch.manifest", len(my_clips)):
            todo = man.pending(my_clips)
        result.skipped = len(my_clips) - len(todo)

        pool = ThreadPoolExecutor(max_workers=parse_workers)

        # ---- stage 1: parallel host demux (failure-isolated) -------------
        parsed: list = []
        with timer.stage("parse", len(todo), "batch.demux"):
            stage1 = carry(_demux_clip if use_slab else _parse_clip)
            futs = {pool.submit(stage1, c, pictures_per_clip, mode,
                                device): c
                    for c in todo}
            for fut, clip in futs.items():
                try:
                    parsed.append(fut.result())
                except Exception as e:         # noqa: BLE001 — isolation
                    trace.warning("PARALLEL", "clip failed: %s: %s",
                                  clip, e)
                    man.failed(clip, error=f"{type(e).__name__}: {e}")
                    result.failed += 1
                    result.errors[clip] = traceback.format_exc()

        # ---- stage 2: bucket by geometry+config, device recon ------------
        def bucket_key(pc):
            sps, p = pc.sps, pc.pps
            return (sps.pic_width_in_mbs, sps.pic_height_in_map_units,
                    bool(p.transform_8x8_mode_flag),
                    p.chroma_qp_index_offset,
                    p.second_chroma_qp_index_offset,
                    bytes(np.asarray(p.scaling_list_4x4, np.uint8)),
                    bytes(np.asarray(p.scaling_list_8x8, np.uint8)))

        buckets: dict = {}
        for pc in parsed:
            buckets.setdefault(bucket_key(pc), []).append(pc)

        export_pool = ThreadPoolExecutor(max_workers=io_workers)
        pending_exports = []

        for pcs in buckets.values():
            if not pcs:
                continue
            owners = []
            if use_slab:
                from ..settings import staging_mode as _staging_mode
                with timer.stage("entropy",
                                 sum(len(pc.pictures) for pc in pcs),
                                 "batch.entropy"):
                    packed, owners, bad = _parse_bucket_slab(
                        pcs, pool, _staging_mode())
                for path, err in bad.items():
                    man.failed(path, error=f"entropy: {err}")
                    result.failed += 1
                    result.errors[path] = err
                # owners stays row-aligned with the staging batch;
                # failed clips are skipped at export time
                pcs = [pc for pc in pcs if pc.path not in bad]
                n_frames = len([1 for pc, _ in owners
                                if pc.path not in bad])
                bad_paths = set(bad)
            else:
                frames = []
                for pc in pcs:
                    for fi, f in enumerate(pc.frames):
                        frames.append(f)
                        owners.append((pc, fi))
                packed = pack_frames(frames, pcs[0].sps, pcs[0].pps)
                n_frames = len(frames)
            # RGB formats on a device engine: convert the whole batch on
            # the device before the readback (ops/color.py) — same wiring
            # as mv_decode(want_rgb=True)
            want_rgb = recon.engine != "np" and fmt in _RGB_FORMATS
            try:
                with timer.stage("recon", n_frames, "batch.recon"), \
                        device_trace():
                    ys, cbs, crs, rgbs = recon(packed, want_rgb=want_rgb)
            except Exception as e:             # noqa: BLE001 — isolation
                for pc in pcs:
                    man.failed(pc.path, error=f"recon: {e}")
                    result.failed += 1
                    result.errors[pc.path] = traceback.format_exc()
                continue
            result.frames += n_frames

            # ---- stage 3: async export + manifest -----------------------
            per_clip: dict = {}
            skip = bad_paths if use_slab else ()
            for bi, (pc, fi) in enumerate(owners):
                if pc.path in skip:
                    continue
                per_clip.setdefault(pc.path, []).append((pc, fi, bi))

            def export_clip(items, ys=ys, cbs=cbs, crs=crs, rgbs=rgbs):
                pc = items[0][0]
                sps = pc.sps
                outs = []
                for _, fi, bi in items:
                    y = ys[bi][:sps.cropped_height, :sps.cropped_width]
                    cb = cbs[bi][:sps.cropped_height // 2,
                                 :sps.cropped_width // 2]
                    cr = crs[bi][:sps.cropped_height // 2,
                                 :sps.cropped_width // 2]
                    rgb = (rgbs[bi][:sps.cropped_height,
                                    :sps.cropped_width]
                           if rgbs is not None else None)
                    suffix = f"_{fi}" if len(items) > 1 else ""
                    base = os.path.join(outdir, pc.file_name + suffix)
                    outs.append(export_picture(base, fmt, y, cb, cr,
                                               quality, rgb=rgb))
                return pc.path, outs

            task = carry(export_clip)
            for items in per_clip.values():
                pending_exports.append(export_pool.submit(task, items))

        with timer.stage("export", len(pending_exports), "batch.export"):
            for fut in pending_exports:
                try:
                    path, outs = fut.result()
                    with span("batch.manifest", 1):
                        man.done(path, outputs=outs)
                    result.done += 1
                    result.outputs.extend(outs)
                except Exception as e:         # noqa: BLE001 — isolation
                    trace.warning("PARALLEL", "export failed: %s", e)
                    result.failed += 1
            export_pool.shutdown()
        pool.shutdown()

    timer.report("PARALLEL")
    return result
