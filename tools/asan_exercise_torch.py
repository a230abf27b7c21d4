#!/usr/bin/env python
"""Native-library exercise of the PyTorch/CUDA port for its ASan gate.

The port's counterpart of tools/asan_exercise.py.  It drives every
native entry point of minivideo_tpu_torch (the entropy parser in the
raster, records and device staging layouts, the device layout from 8
threads at once, the demuxer over seven containers, every picture
encoder, the CABAC bin counter) over valid, truncated and byte-flipped
inputs.  A bad input may end in the bindings' BitstreamError, a nonzero
return code or a clean Python exception, never in a memory error.

It imports only the port's torch-free host layer, with torch, JAX and
the JAX package blocked before any import: run under an
AddressSanitizer build through tools/asan_check_torch.sh, which points
MINIVIDEO_TPU_TORCH_NATIVE_LIB at it.

Usage: python tools/asan_exercise_torch.py [rounds]
       python tools/asan_exercise_torch.py --self-check
`--self-check` hands mv_encode_bmp a buffer smaller than the cap it
states: under ASan that run must abort with a heap-buffer-overflow.
"""

import os
import sys

for _name in ("torch", "jax", "jaxlib", "minivideo_tpu"):
    sys.modules[_name] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402

from minivideo_tpu_torch import native  # noqa: E402
from minivideo_tpu_torch.bitio import BitstreamError  # noqa: E402

META_ROWS = 40          # ops/slab.py's meta rows (ops/ imports torch)
THREADS = 8             # the decoder's and the bench's parse pools
WMB, HMB = 11, 7


def slab_geometry(wmb, hmb):
    n_waves = 2 * (hmb - 1) + wmb
    maxw = min(hmb, (wmb + 1) // 2 + 1)
    return n_waves, maxw


def make_stagings(wmb, hmb, batch=1):
    """Numpy stagings of ops/recon.py's records (v1) and device (v2)
    layouts for `batch` pictures."""
    W, maxw = slab_geometry(wmb, hmb)
    v1 = {"luma_slab": np.zeros((batch, W * maxw, 256), np.int16),
          "chroma_slab": np.zeros((batch, W * maxw, 128), np.int16),
          "dc_slab": np.zeros((batch, W * maxw, 32), np.int16),
          "maxw": maxw}
    v2 = {"luma_slab": np.zeros((batch, W, 256, maxw), np.int16),
          "chroma_slab": np.zeros((batch, W, 128, maxw), np.int16),
          "dc_slab": np.zeros((batch, W, 32, maxw), np.int16),
          "meta_slab": np.zeros((batch, W, META_ROWS, maxw), np.int32),
          "maxw": maxw}
    return v1, v2


def idr_slices(data):
    """(rbsp, slice header, pps) of every IDR slice of `data`."""
    from minivideo_tpu_torch.models.h264.nalu import parse_nalu, split_annexb
    from minivideo_tpu_torch.models.h264.params import parse_pps, parse_sps
    from minivideo_tpu_torch.models.h264.slicehdr import parse_slice_header
    sps_map, pps_map, out = {}, {}, []
    for off, raw in split_annexb(data):
        n = parse_nalu(raw, off)
        if n.nal_unit_type == 7:
            sps = parse_sps(n.rbsp)
            sps_map[sps.seq_parameter_set_id] = sps
        elif n.nal_unit_type == 8:
            pps = parse_pps(n.rbsp, sps_map)
            pps_map[pps.pic_parameter_set_id] = pps
        elif n.nal_unit_type == 5:
            sh, _, pps = parse_slice_header(n.rbsp, n.nal_unit_type,
                                            n.nal_ref_idc, sps_map, pps_map)
            out.append((n.rbsp, sh, pps))
    return out


def variants(rbsp, rng):
    """The valid payload, six truncations and eight byte-flipped copies."""
    out = [rbsp]
    out += [rbsp[:cut] for cut in (1, 2, 5, len(rbsp) // 3, len(rbsp) // 2,
                                   max(1, len(rbsp) - 2))]
    for _ in range(8):
        mut = bytearray(rbsp)
        for _ in range(rng.integers(1, 4)):
            mut[rng.integers(0, len(mut))] ^= int(rng.integers(1, 256))
        out.append(bytes(mut))
    return out


def parse(mode, rbsp, sh, pps, stagings=None, row=0):
    """One parse of `rbsp` in staging layout `mode`; True where it parsed,
    False where it raised the bindings' BitstreamError."""
    from minivideo_tpu_torch.models.h264.syntax import FrameSyntax
    v1, v2 = stagings or make_stagings(WMB, HMB)
    fs = FrameSyntax(WMB, HMB, lite=(mode != "raster"))
    args = (rbsp, sh.data_bit_offset, sh.first_mb_in_slice, sh.qp,
            bool(pps.entropy_coding_mode_flag),
            bool(pps.transform_8x8_mode_flag))
    try:
        if mode == "raster":
            native.parse_slice_native(fs, *args)
        elif mode == "records":
            native.parse_slice_native_slab(fs, v1, row, *args)
        else:
            native.parse_slice_native_slab2(
                fs, v2, row, *args, cb_qp_off=pps.chroma_qp_index_offset,
                cr_qp_off=pps.second_chroma_qp_index_offset)
        return True
    except BitstreamError:
        return False


def round_streams(rnd):
    """Both entropy coders, each as a stream with 8x8 transforms and I_PCM
    and as one with escape-range levels (8x8 on odd rounds)."""
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    for entropy in ("cavlc", "cabac"):
        yield make_stream2(width_mbs=WMB, height_mbs=HMB, n_pictures=1,
                           seed=300 + rnd, mb_kinds=("i16", "i4", "i8"),
                           density=0.4, entropy=entropy, transform_8x8=True,
                           allow_pcm=True)
        t8 = bool(rnd % 2)
        yield make_stream2(width_mbs=WMB, height_mbs=HMB, n_pictures=1,
                           seed=400 + rnd,
                           mb_kinds=("i16", "i4", "i8") if t8
                           else ("i16", "i4"),
                           density=0.9, entropy=entropy, transform_8x8=t8,
                           max_level=700)


def exercise_entropy(rounds):
    rng = np.random.default_rng(0)
    counts = {"ok": 0, "err": 0, "threaded_ok": 0, "threaded_err": 0}
    for rnd in range(rounds):
        for data in round_streams(rnd):
            for rbsp, sh, pps in idr_slices(data):
                todo = variants(rbsp, rng)
                for v in todo:
                    for mode in ("raster", "records", "device"):
                        ok = parse(mode, v, sh, pps)
                        counts["ok" if ok else "err"] += 1
                # the device layout from THREADS threads at once, each
                # into its own row of one shared staging set
                stagings = make_stagings(WMB, HMB, THREADS)
                with ThreadPoolExecutor(max_workers=THREADS) as pool:
                    for start in range(0, len(todo), THREADS):
                        futs = [pool.submit(parse, "device", v, sh, pps,
                                            stagings, row)
                                for row, v in enumerate(
                                    todo[start:start + THREADS])]
                        for f in futs:
                            ok = f.result()
                            counts["threaded_ok" if ok
                                   else "threaded_err"] += 1
    bins = native.cabac_bins_total()
    if counts["ok"] == 0 or counts["err"] == 0 or bins == 0:
        raise SystemExit(f"entropy: nothing exercised ({counts}, "
                         f"{bins} CABAC bins)")
    print(f"entropy: {counts['ok']} clean parses, {counts['err']} clean "
          f"errors; from {THREADS} threads: {counts['threaded_ok']} clean "
          f"parses, {counts['threaded_err']} clean errors; "
          f"cabac_bins_total {bins}")


def exercise_demux(rounds):
    import tempfile
    from minivideo_tpu_torch.containers.native import native_demux
    from minivideo_tpu_torch.media import open_media
    from minivideo_tpu_torch.testing import containers as C
    from minivideo_tpu_torch.testing.h264enc2 import make_stream2
    rng = np.random.default_rng(1)
    es = make_stream2(width_mbs=4, height_mbs=3, n_pictures=2, seed=9,
                      mb_kinds=("i16",), density=0.3, entropy="cavlc")
    builders = {
        "mp4": lambda: C.write_mp4(es, 64, 48),
        "avi": lambda: C.write_avi(es, 64, 48),
        "wav": lambda: C.write_wav(
            rng.integers(-3000, 3000, 4000).astype(np.int16)),
        "mkv": lambda: C.write_mkv(es, 64, 48),
        "ts": lambda: C.write_ts(es),
        "mpg": lambda: C.write_ps(es),
        "264": lambda: es,
    }
    counts = {"parsed": 0, "refused": 0, "errors": 0}
    missed = []                 # valid files the native demuxer refused
    with tempfile.TemporaryDirectory(prefix="asan_demux_") as tmpd:
        for rnd in range(rounds):
            for ext, build in builders.items():
                blob = build()
                todo = [blob] + [blob[:cut] for cut in
                                 (4, 16, len(blob) // 2,
                                  max(8, len(blob) - 3))]
                for _ in range(6):
                    mut = bytearray(blob)
                    for _ in range(rng.integers(1, 6)):
                        mut[rng.integers(0, len(mut))] ^= \
                            int(rng.integers(1, 256))
                    todo.append(bytes(mut))
                for i, v in enumerate(todo):
                    path = os.path.join(tmpd, f"r{rnd}_{i}.{ext}")
                    with open(path, "wb") as f:
                        f.write(v)
                    ok = False
                    try:
                        media = open_media(path)
                    except Exception:   # noqa: BLE001 - a clean refusal
                        counts["errors"] += 1
                    else:
                        try:
                            ok = native_demux(media)
                            counts["parsed" if ok else "refused"] += 1
                        except Exception:   # noqa: BLE001 - clean error
                            counts["errors"] += 1
                        finally:
                            media.close()
                    if i == 0 and not ok:
                        missed.append(ext)
    if missed:
        raise SystemExit(f"demux: valid files not demuxed: {missed}")
    print(f"demux: {counts['parsed']} native demuxes, {counts['refused']} "
          f"refused, {counts['errors']} clean Python errors over "
          f"{len(builders)} containers ({', '.join(builders)}), valid and "
          f"mutated")


def exercise_export():
    rng = np.random.default_rng(2)
    dims = [(1, 1), (1, 9), (7, 1), (2, 3), (8, 8), (15, 17), (33, 31),
            (64, 128), (255, 257)]
    sizes = {}
    for h, w in dims:
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        cb = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)
                          ).astype(np.uint8)
        cr = rng.integers(0, 256, cb.shape).astype(np.uint8)
        rgb = native.yuv420_to_rgb_native(y, cb, cr)
        out = [len(native.encode_jpeg_native(y, cb, cr, q))
               for q in (1, 50, 100)]
        out += [len(native.encode_png_native(rgb, lvl, th))
                for lvl in (0, 1, 6, 9) for th in (1, 3)]
        out += [len(native.encode_bmp_native(rgb)),
                len(native.encode_tga_native(rgb))]
        sizes[f"{h}x{w}"] = out
    print(f"export: {len(dims)} sizes through yuv420_to_rgb, JPEG q1/50/100, "
          f"PNG levels 0/1/6/9 on 1 and 3 threads, BMP, TGA; bytes "
          f"{sizes}")


def self_check():
    """mv_encode_bmp on a 64x64 picture, told its 4 KiB buffer holds
    1 MiB: under ASan this aborts with a heap-buffer-overflow."""
    lib = native.load_export()
    rgb = np.zeros((64, 64, 3), np.uint8)
    small = np.empty(4096, np.uint8)
    n = lib.mv_encode_bmp(native._u8p(rgb), 64, 64, native._u8p(small),
                          1 << 20)
    print(f"self-check: mv_encode_bmp wrote {n} bytes into a 4096-byte "
          f"buffer and nothing stopped it")


def main(argv):
    if argv[:1] == ["--self-check"]:
        self_check()
        return
    rounds = int(argv[0]) if argv else 3
    exercise_entropy(rounds)
    exercise_demux(rounds)
    exercise_export()
    leaked = [n for n in ("torch", "jax", "minivideo_tpu")
              if sys.modules.get(n) is not None]
    if leaked:
        raise SystemExit(f"imported {leaked}")
    print("asan exercise: done")


if __name__ == "__main__":
    main(sys.argv[1:])
