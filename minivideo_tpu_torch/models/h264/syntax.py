"""Per-picture syntax arrays filled by the native entropy parser.

Copy of the `FrameSyntax` container and the macroblock-kind constants of
minivideo_tpu/models/h264/syntax.py.  The port parses slices only through
the native parser (native/), which writes these arrays in place; the
Python CAVLC/CABAC parsers are not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# mb kinds (derived classification of I-slice mb_type, Table 7-11)
KIND_I4x4 = 0
KIND_I16x16 = 1
KIND_IPCM = 2
KIND_I8x8 = 3

MODE_DC = 2  # DC intra pred mode index (both 4x4 and 16x16 numbering)


@dataclass
class FrameSyntax:
    """Parsed syntax of one I picture: static-shaped arrays, nmb = wmb*hmb.

    lite=True skips the five large raster coefficient buffers: the
    native parser's slab mode writes coefficients into external staging
    instead (ops/recon.make_slab_staging2)."""
    width_mbs: int
    height_mbs: int
    lite: bool = False

    mb_kind: np.ndarray = None        # [nmb] int8
    qpy: np.ndarray = None            # [nmb] int32 (after delta chain)
    i16_mode: np.ndarray = None       # [nmb] int8
    chroma_mode: np.ndarray = None    # [nmb] int8
    luma4x4_modes: np.ndarray = None  # [nmb,16] int8 (resolved)
    luma8x8_modes: np.ndarray = None  # [nmb,4] int8 (resolved)
    cbp_luma: np.ndarray = None       # [nmb] int8 bits per 8x8
    cbp_chroma: np.ndarray = None     # [nmb] int8 0/1/2
    # coefficients, raster order within blocks:
    luma_dc: np.ndarray = None        # [nmb,4,4] int32 (I16x16 DC)
    luma_ac: np.ndarray = None        # [nmb,16,4,4] int32
    luma8x8_coeff: np.ndarray = None  # [nmb,4,8,8] int32
    chroma_dc: np.ndarray = None      # [nmb,2,2,2] int32
    chroma_ac: np.ndarray = None      # [nmb,2,4,4,4] int32
    pcm_y: dict = field(default_factory=dict)
    pcm_cb: dict = field(default_factory=dict)
    pcm_cr: dict = field(default_factory=dict)
    # parse state (CAVLC nC / CABAC ctx derivations)
    total_coeff_luma: np.ndarray = None    # [nmb,16] int16
    total_coeff_chroma: np.ndarray = None  # [nmb,2,4] int16
    cbf_luma_dc: np.ndarray = None    # [nmb]
    cbf_luma: np.ndarray = None       # [nmb,16]
    cbf_luma8x8: np.ndarray = None    # [nmb,4]
    cbf_chroma_dc: np.ndarray = None  # [nmb,2]
    cbf_chroma: np.ndarray = None     # [nmb,2,4]
    transform8x8: np.ndarray = None   # [nmb] int8
    parsed: np.ndarray = None         # [nmb] bool (true once decoded)

    def __post_init__(self):
        n = self.width_mbs * self.height_mbs
        self.mb_kind = np.zeros(n, dtype=np.int8)
        self.qpy = np.zeros(n, dtype=np.int32)
        self.i16_mode = np.zeros(n, dtype=np.int8)
        self.chroma_mode = np.zeros(n, dtype=np.int8)
        self.luma4x4_modes = np.full((n, 16), MODE_DC, dtype=np.int8)
        self.luma8x8_modes = np.full((n, 4), MODE_DC, dtype=np.int8)
        self.cbp_luma = np.zeros(n, dtype=np.int8)
        self.cbp_chroma = np.zeros(n, dtype=np.int8)
        cn = 1 if self.lite else n
        self.luma_dc = np.zeros((cn, 4, 4), dtype=np.int32)
        self.luma_ac = np.zeros((cn, 16, 4, 4), dtype=np.int32)
        self.luma8x8_coeff = np.zeros((cn, 4, 8, 8), dtype=np.int32)
        self.chroma_dc = np.zeros((cn, 2, 2, 2), dtype=np.int32)
        self.chroma_ac = np.zeros((cn, 2, 4, 4, 4), dtype=np.int32)
        self.total_coeff_luma = np.zeros((n, 16), dtype=np.int16)
        self.total_coeff_chroma = np.zeros((n, 2, 4), dtype=np.int16)
        self.cbf_luma_dc = np.zeros(n, dtype=np.int8)
        self.cbf_luma = np.zeros((n, 16), dtype=np.int8)
        self.cbf_luma8x8 = np.zeros((n, 4), dtype=np.int8)
        self.cbf_chroma_dc = np.zeros((n, 2), dtype=np.int8)
        self.cbf_chroma = np.zeros((n, 2, 4), dtype=np.int8)
        self.transform8x8 = np.zeros(n, dtype=np.int8)
        self.parsed = np.zeros(n, dtype=bool)

    @property
    def n_mbs(self) -> int:
        return self.width_mbs * self.height_mbs
