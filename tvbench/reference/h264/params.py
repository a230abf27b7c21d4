"""H.264 parameter set parsing: SPS, PPS, SEI (spec 7.3.2).

Reference: minivideo/src/decoder/h264/h264_parameterset.c — decodeSPS
(:123), decodePPS (:812), decodeSEI (:1175), scaling_list readers
(:723-810).  Like the reference, chroma formats other than 4:2:0 and bit
depths other than 8 are rejected (h264_parameterset.c:175-218); unlike the
reference, default scaling matrices (spec Table 7-2 fall-back rules) are
applied correctly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitio import BitReader, BitstreamError
from . import trace
from .expgolomb import read_se, read_ue
from .tables import (DEFAULT_4x4_INTER, DEFAULT_4x4_INTRA, DEFAULT_8x8_INTER,
                     DEFAULT_8x8_INTRA, FLAT_16, FLAT_64, ZIGZAG_4x4,
                     ZIGZAG_8x8)

MAX_SPS = 32
MAX_PPS = 256

HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


class UnsupportedStream(Exception):
    """Stream feature outside the supported envelope (mirrors the
    reference's UNSUPPORTED return code, typedef.h:40-42)."""


@dataclass
class HRD:
    cpb_cnt_minus1: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value_minus1: list = field(default_factory=list)
    cpb_size_value_minus1: list = field(default_factory=list)
    cbr_flag: list = field(default_factory=list)
    initial_cpb_removal_delay_length_minus1: int = 23
    cpb_removal_delay_length_minus1: int = 23
    dpb_output_delay_length_minus1: int = 23
    time_offset_length: int = 24


@dataclass
class VUI:
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate_flag: int = 0
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    fixed_frame_rate_flag: int = 0
    nal_hrd: HRD = None
    vcl_hrd: HRD = None
    low_delay_hrd_flag: int = 0
    pic_struct_present_flag: int = 0
    motion_vectors_over_pic_boundaries_flag: int = 1
    max_bytes_per_pic_denom: int = 2
    max_bits_per_mb_denom: int = 1
    log2_max_mv_length_horizontal: int = 15
    log2_max_mv_length_vertical: int = 15
    num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 0


@dataclass
class SPS:
    profile_idc: int = 0
    constraint_flags: int = 0
    level_idc: int = 0
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    # ScalingList4x4[6][16] and ScalingList8x8[6][64] in zig-zag order;
    # flat 16s when absent.
    scaling_list_4x4: np.ndarray = None
    scaling_list_8x8: np.ndarray = None
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 4
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: list = field(default_factory=list)
    max_num_ref_frames: int = 0
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs: int = 0
    pic_height_in_map_units: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 0
    frame_cropping_flag: int = 0
    crop_left: int = 0
    crop_right: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    vui: VUI = None

    # derived (spec 7.4.2.1.1)
    @property
    def chroma_array_type(self) -> int:
        return 0 if self.separate_colour_plane_flag else self.chroma_format_idc

    @property
    def width(self) -> int:
        return self.pic_width_in_mbs * 16

    @property
    def height(self) -> int:
        return self.pic_height_in_map_units * 16 * (
            2 - self.frame_mbs_only_flag)

    @property
    def cropped_width(self) -> int:
        # 4:2:0 -> CropUnitX = 2 (spec 7.4.2.1.1)
        return self.width - 2 * (self.crop_left + self.crop_right)

    @property
    def cropped_height(self) -> int:
        return self.height - 2 * (2 - self.frame_mbs_only_flag) * (
            self.crop_top + self.crop_bottom)


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0
    bottom_field_pic_order_in_frame_present_flag: int = 0
    num_slice_groups: int = 1
    num_ref_idx_l0_default_active: int = 1
    num_ref_idx_l1_default_active: int = 1
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    # effective scaling lists for this PPS (after fall-back rules)
    scaling_list_4x4: np.ndarray = None
    scaling_list_8x8: np.ndarray = None
    second_chroma_qp_index_offset: int = 0


def _read_scaling_list(r: BitReader, size: int):
    """scaling_list() (spec 7.3.2.1.1.1).

    Returns (list_in_zigzag_order | None, use_default_flag).
    Reference: scaling_list_4x4/_8x8 (h264_parameterset.c:723-810).
    """
    last_scale, next_scale = 8, 8
    out = np.zeros(size, dtype=np.int32)
    use_default = False
    for j in range(size):
        if next_scale != 0:
            delta = read_se(r)
            next_scale = (last_scale + delta + 256) % 256
            if j == 0 and next_scale == 0:
                use_default = True
        out[j] = last_scale if next_scale == 0 else next_scale
        last_scale = int(out[j])
    return out, use_default


_DEFAULT_4x4 = (DEFAULT_4x4_INTRA, DEFAULT_4x4_INTER)
_DEFAULT_8x8 = (DEFAULT_8x8_INTRA, DEFAULT_8x8_INTER)


def _parse_scaling_matrices(r: BitReader, n_8x8: int, fallback_4x4,
                            fallback_8x8, use_default_fallback: bool):
    """Parse the seq/pic scaling matrix block and apply fall-back rule A/B
    (spec Table 7-2).  Returns (list4x4[6][16], list8x8[2..6][64]) zig-zag."""
    l4 = np.zeros((6, 16), dtype=np.int32)
    l8 = np.zeros((6, 64), dtype=np.int32)
    l8[:] = FLAT_64
    for i in range(6 + n_8x8):
        present = r.read_bit()
        if i < 6:
            if present:
                lst, use_def = _read_scaling_list(r, 16)
                l4[i] = _DEFAULT_4x4[i // 3] if use_def else lst
            else:
                if i in (0, 3):
                    # fall-back rule: default (rule A) or inherited (rule B)
                    l4[i] = (_DEFAULT_4x4[i // 3] if use_default_fallback
                             else fallback_4x4[i])
                else:
                    l4[i] = l4[i - 1]
        else:
            k = i - 6
            if present:
                lst, use_def = _read_scaling_list(r, 64)
                l8[k] = _DEFAULT_8x8[k % 2] if use_def else lst
            else:
                if k in (0, 1):
                    l8[k] = (_DEFAULT_8x8[k % 2] if use_default_fallback
                             else fallback_8x8[k])
                else:
                    l8[k] = l8[k - 2]
    return l4, l8


def zigzag_to_raster_4x4(zz: np.ndarray) -> np.ndarray:
    out = np.zeros(16, dtype=np.int32)
    out[ZIGZAG_4x4] = zz
    return out.reshape(4, 4)


def zigzag_to_raster_8x8(zz: np.ndarray) -> np.ndarray:
    out = np.zeros(64, dtype=np.int32)
    out[ZIGZAG_8x8] = zz
    return out.reshape(8, 8)


def parse_sps(rbsp: bytes) -> SPS:
    """Parse a seq_parameter_set_rbsp (spec 7.3.2.1.1).

    Reference: decodeSPS (h264_parameterset.c:123-437).
    """
    r = BitReader(rbsp)
    s = SPS()
    s.profile_idc = r.read_bits(8)
    s.constraint_flags = r.read_bits(6)
    if r.read_bits(2) != 0:
        raise BitstreamError("reserved_zero_2bits != 0")
    s.level_idc = r.read_bits(8)
    s.seq_parameter_set_id = read_ue(r)
    if s.seq_parameter_set_id >= MAX_SPS:
        raise BitstreamError("sps id out of range")

    s.scaling_list_4x4 = np.tile(FLAT_16, (6, 1))
    s.scaling_list_8x8 = np.tile(FLAT_64, (6, 1))

    if s.profile_idc in HIGH_PROFILES:
        s.chroma_format_idc = read_ue(r)
        if s.chroma_format_idc == 3:
            s.separate_colour_plane_flag = r.read_bit()
        s.bit_depth_luma = read_ue(r) + 8
        s.bit_depth_chroma = read_ue(r) + 8
        s.qpprime_y_zero_transform_bypass_flag = r.read_bit()
        s.seq_scaling_matrix_present_flag = r.read_bit()
        if s.seq_scaling_matrix_present_flag:
            n8 = 6 if s.chroma_format_idc == 3 else 2
            s.scaling_list_4x4, s.scaling_list_8x8 = _parse_scaling_matrices(
                r, n8, None, None, use_default_fallback=True)

    # supported envelope: 4:2:0, 8-bit, frame-coded
    # (reference rejects the same at h264_parameterset.c:175-218)
    if s.chroma_format_idc != 1:
        raise UnsupportedStream(
            f"chroma_format_idc={s.chroma_format_idc} (only 4:2:0)")
    if s.bit_depth_luma != 8 or s.bit_depth_chroma != 8:
        raise UnsupportedStream("only 8-bit streams supported")

    s.log2_max_frame_num = read_ue(r) + 4
    s.pic_order_cnt_type = read_ue(r)
    if s.pic_order_cnt_type == 0:
        s.log2_max_pic_order_cnt_lsb = read_ue(r) + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = r.read_bit()
        s.offset_for_non_ref_pic = read_se(r)
        s.offset_for_top_to_bottom_field = read_se(r)
        n = read_ue(r)
        s.offset_for_ref_frame = [read_se(r) for _ in range(n)]
    s.max_num_ref_frames = read_ue(r)
    s.gaps_in_frame_num_value_allowed_flag = r.read_bit()
    s.pic_width_in_mbs = read_ue(r) + 1
    s.pic_height_in_map_units = read_ue(r) + 1
    s.frame_mbs_only_flag = r.read_bit()
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = r.read_bit()
        raise UnsupportedStream("interlaced (non frame_mbs_only) streams")
    s.direct_8x8_inference_flag = r.read_bit()
    s.frame_cropping_flag = r.read_bit()
    if s.frame_cropping_flag:
        s.crop_left = read_ue(r)
        s.crop_right = read_ue(r)
        s.crop_top = read_ue(r)
        s.crop_bottom = read_ue(r)
    if r.read_bit():  # vui_parameters_present_flag
        s.vui = _parse_vui(r)
    trace.t1("PARAM", "SPS id=%d profile=%d %dx%d",
             s.seq_parameter_set_id, s.profile_idc, s.width, s.height)
    return s


def _parse_hrd(r: BitReader) -> HRD:
    """hrd_parameters() (spec E.1.2; reference decodeHRD
    h264_parameterset.c:1661)."""
    h = HRD()
    h.cpb_cnt_minus1 = read_ue(r)
    h.bit_rate_scale = r.read_bits(4)
    h.cpb_size_scale = r.read_bits(4)
    for _ in range(h.cpb_cnt_minus1 + 1):
        h.bit_rate_value_minus1.append(read_ue(r))
        h.cpb_size_value_minus1.append(read_ue(r))
        h.cbr_flag.append(r.read_bit())
    h.initial_cpb_removal_delay_length_minus1 = r.read_bits(5)
    h.cpb_removal_delay_length_minus1 = r.read_bits(5)
    h.dpb_output_delay_length_minus1 = r.read_bits(5)
    h.time_offset_length = r.read_bits(5)
    return h


def _parse_vui(r: BitReader) -> VUI:
    """vui_parameters() (spec E.1.1; reference decodeVUI
    h264_parameterset.c:1474)."""
    v = VUI()
    if r.read_bit():  # aspect_ratio_info_present
        v.aspect_ratio_idc = r.read_bits(8)
        if v.aspect_ratio_idc == 255:  # Extended_SAR
            v.sar_width = r.read_bits(16)
            v.sar_height = r.read_bits(16)
    if r.read_bit():  # overscan_info_present
        v.overscan_appropriate_flag = r.read_bit()
    if r.read_bit():  # video_signal_type_present
        v.video_format = r.read_bits(3)
        v.video_full_range_flag = r.read_bit()
        if r.read_bit():  # colour_description_present
            v.colour_primaries = r.read_bits(8)
            v.transfer_characteristics = r.read_bits(8)
            v.matrix_coefficients = r.read_bits(8)
    if r.read_bit():  # chroma_loc_info_present
        v.chroma_sample_loc_type_top_field = read_ue(r)
        v.chroma_sample_loc_type_bottom_field = read_ue(r)
    if r.read_bit():  # timing_info_present
        v.num_units_in_tick = r.read_bits(32)
        v.time_scale = r.read_bits(32)
        v.fixed_frame_rate_flag = r.read_bit()
    nal_hrd_present = r.read_bit()
    if nal_hrd_present:
        v.nal_hrd = _parse_hrd(r)
    vcl_hrd_present = r.read_bit()
    if vcl_hrd_present:
        v.vcl_hrd = _parse_hrd(r)
    if nal_hrd_present or vcl_hrd_present:
        v.low_delay_hrd_flag = r.read_bit()
    v.pic_struct_present_flag = r.read_bit()
    if r.read_bit():  # bitstream_restriction
        v.motion_vectors_over_pic_boundaries_flag = r.read_bit()
        v.max_bytes_per_pic_denom = read_ue(r)
        v.max_bits_per_mb_denom = read_ue(r)
        v.log2_max_mv_length_horizontal = read_ue(r)
        v.log2_max_mv_length_vertical = read_ue(r)
        v.num_reorder_frames = read_ue(r)
        v.max_dec_frame_buffering = read_ue(r)
    return v


def parse_pps(rbsp: bytes, sps_map: dict) -> PPS:
    """Parse a pic_parameter_set_rbsp (spec 7.3.2.2).

    Reference: decodePPS (h264_parameterset.c:812-970).  `sps_map` maps
    sps_id -> SPS, needed for scaling-matrix fall-back and chroma format.
    """
    r = BitReader(rbsp)
    p = PPS()
    p.pic_parameter_set_id = read_ue(r)
    if p.pic_parameter_set_id >= MAX_PPS:
        raise BitstreamError("pps id out of range")
    p.seq_parameter_set_id = read_ue(r)
    sps = sps_map.get(p.seq_parameter_set_id)
    if sps is None:
        raise BitstreamError(f"PPS references unknown SPS "
                             f"{p.seq_parameter_set_id}")
    p.entropy_coding_mode_flag = r.read_bit()
    p.bottom_field_pic_order_in_frame_present_flag = r.read_bit()
    p.num_slice_groups = read_ue(r) + 1
    if p.num_slice_groups > 1:
        # FMO — rejected like the reference (h264_slice.c:326-330)
        raise UnsupportedStream("FMO (num_slice_groups > 1)")
    p.num_ref_idx_l0_default_active = read_ue(r) + 1
    p.num_ref_idx_l1_default_active = read_ue(r) + 1
    p.weighted_pred_flag = r.read_bit()
    p.weighted_bipred_idc = r.read_bits(2)
    p.pic_init_qp = read_se(r) + 26
    p.pic_init_qs = read_se(r) + 26
    p.chroma_qp_index_offset = read_se(r)
    p.deblocking_filter_control_present_flag = r.read_bit()
    p.constrained_intra_pred_flag = r.read_bit()
    p.redundant_pic_cnt_present_flag = r.read_bit()

    # effective scaling lists start as the SPS's
    p.scaling_list_4x4 = sps.scaling_list_4x4.copy()
    p.scaling_list_8x8 = sps.scaling_list_8x8.copy()
    p.second_chroma_qp_index_offset = p.chroma_qp_index_offset

    if r.h264_more_rbsp_data():
        p.transform_8x8_mode_flag = r.read_bit()
        p.pic_scaling_matrix_present_flag = r.read_bit()
        if p.pic_scaling_matrix_present_flag:
            n8 = ((6 if sps.chroma_format_idc == 3 else 2)
                  if p.transform_8x8_mode_flag else 0)
            p.scaling_list_4x4, p.scaling_list_8x8 = _parse_scaling_matrices(
                r, n8, sps.scaling_list_4x4, sps.scaling_list_8x8,
                use_default_fallback=not sps.seq_scaling_matrix_present_flag)
        p.second_chroma_qp_index_offset = read_se(r)
    trace.t1("PARAM", "PPS id=%d entropy=%s 8x8=%d",
             p.pic_parameter_set_id,
             "CABAC" if p.entropy_coding_mode_flag else "CAVLC",
             p.transform_8x8_mode_flag)
    return p


def parse_sei(rbsp: bytes) -> list:
    """Parse SEI messages into (type, payload) pairs (spec 7.3.2.3).

    The reference treats SEI as a skip-stub (h264_parameterset.c:1175-1219);
    we at least split out the messages.
    """
    out = []
    i, n = 0, len(rbsp)
    while i < n and rbsp[i] != 0x80:
        ptype = 0
        while i < n and rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        if i >= n:
            break
        ptype += rbsp[i]
        i += 1
        psize = 0
        while i < n and rbsp[i] == 0xFF:
            psize += 255
            i += 1
        if i >= n:
            break
        psize += rbsp[i]
        i += 1
        out.append((ptype, rbsp[i:i + psize]))
        i += psize
    return out
