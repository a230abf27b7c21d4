"""H.264 slice header parsing (spec 7.3.3).

Reference: decodeSliceHeader (h264_slice.c:156-476).  Supported envelope is
the reference's: I/SI slices only — P/SP/B slice types raise
UnsupportedStream exactly where the reference returns UNSUPPORTED
(h264_slice.c:229-256).
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitio import BitReader
from . import trace
from .expgolomb import read_se, read_ue
from .params import PPS, SPS, UnsupportedStream
from .nalu import NaluType

# slice_type values (spec Table 7-6); values 5-9 are the "all slices in
# picture have this type" variants
SLICE_P = 0
SLICE_B = 1
SLICE_I = 2
SLICE_SP = 3
SLICE_SI = 4


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type: int = 2
    pic_parameter_set_id: int = 0
    frame_num: int = 0
    idr_pic_id: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    slice_alpha_c0_offset_div2: int = 0
    slice_beta_offset_div2: int = 0
    # derived
    qp: int = 26          # SliceQPY (spec 7-30)
    is_idr: bool = True
    # bit position in the RBSP where slice_data() starts
    data_bit_offset: int = 0


def parse_slice_header(rbsp: bytes, nalu_type: NaluType, nal_ref_idc: int,
                       sps_map: dict, pps_map: dict):
    """Parse slice_header(); returns (SliceHeader, SPS, PPS).

    Raises UnsupportedStream for non-I slice types, matching the
    reference's capability ceiling (h264_slice.c:229-262).
    """
    r = BitReader(rbsp)
    h = SliceHeader()
    h.is_idr = (nalu_type == NaluType.SLICE_IDR)

    h.first_mb_in_slice = read_ue(r)
    h.slice_type = read_ue(r)
    base_type = h.slice_type % 5
    if base_type not in (SLICE_I, SLICE_SI):
        names = {0: "P", 1: "B", 3: "SP"}
        raise UnsupportedStream(
            f"{names.get(base_type, '?')}-slice decoding not supported "
            f"(slice_type={h.slice_type})")
    h.pic_parameter_set_id = read_ue(r)
    pps = pps_map.get(h.pic_parameter_set_id)
    if pps is None:
        raise ValueError(f"slice references unknown PPS "
                         f"{h.pic_parameter_set_id}")
    sps = sps_map[pps.seq_parameter_set_id]
    if sps.separate_colour_plane_flag:
        r.read_bits(2)  # colour_plane_id
    h.frame_num = r.read_bits(sps.log2_max_frame_num)
    # frame_mbs_only_flag is enforced at SPS parse time; no field flags here
    if h.is_idr:
        h.idr_pic_id = read_ue(r)
    if sps.pic_order_cnt_type == 0:
        h.pic_order_cnt_lsb = r.read_bits(sps.log2_max_pic_order_cnt_lsb)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            h.delta_pic_order_cnt_bottom = read_se(r)
    elif (sps.pic_order_cnt_type == 1
          and not sps.delta_pic_order_always_zero_flag):
        read_se(r)  # delta_pic_order_cnt[0]
        if pps.bottom_field_pic_order_in_frame_present_flag:
            read_se(r)  # delta_pic_order_cnt[1]
    if pps.redundant_pic_cnt_present_flag:
        read_ue(r)  # redundant_pic_cnt
    # I/SI slice: no ref_pic_list_modification, no pred_weight_table
    if nal_ref_idc != 0:
        # dec_ref_pic_marking (spec 7.3.3.3)
        if h.is_idr:
            h.no_output_of_prior_pics_flag = r.read_bit()
            h.long_term_reference_flag = r.read_bit()
        else:
            if r.read_bit():  # adaptive_ref_pic_marking_mode_flag
                while True:
                    op = read_ue(r)
                    if op == 0:
                        break
                    if op in (1, 3):
                        read_ue(r)
                    if op == 2:
                        read_ue(r)
                    if op == 3:
                        read_ue(r)
                    if op == 4:
                        read_ue(r)
    if pps.entropy_coding_mode_flag and base_type not in (SLICE_I, SLICE_SI):
        h.cabac_init_idc = read_ue(r)
    h.slice_qp_delta = read_se(r)
    h.qp = pps.pic_init_qp + h.slice_qp_delta  # SliceQPY (h264_slice.c:292)
    if not (0 <= h.qp <= 51):
        raise ValueError(f"SliceQPY {h.qp} out of range")
    if base_type == SLICE_SI:
        raise UnsupportedStream("SI slices (sp_for_switch / slice_qs)")
    if pps.deblocking_filter_control_present_flag:
        h.disable_deblocking_filter_idc = read_ue(r)
        if h.disable_deblocking_filter_idc != 1:
            h.slice_alpha_c0_offset_div2 = read_se(r)
            h.slice_beta_offset_div2 = read_se(r)
    # num_slice_groups==1 enforced at PPS parse: no slice_group_change_cycle
    h.data_bit_offset = r.bit_position()
    trace.t2("SLICE", "slice hdr: first_mb=%d type=%d qp=%d",
             h.first_mb_in_slice, h.slice_type, h.qp)
    return h, sps, pps
