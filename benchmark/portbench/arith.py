"""The yardstick's arithmetic: the card's peaks and the work of a pair.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in f32 outside the tensor cores, 989 TFLOP/s in bf16,
1,979 TOP/s in int8, HBM at 3.35 TB/s.

The operations of a pair follow the paper's algorithm on the user's
pixels (H x W before the bucket's padding) and the real disparities
(``ndisp``, not the lanes the program pads them to), whatever implements a
stage, so the program's padding counts as no work:

* features: 5 VALID 3x3 convolutions of 64 maps on both images,
  ``2 * H * W * 2 * 9 * 64 * (1 + 4 * 64)`` FLOP (the port's bench,
  ``bench.py::_stage_profile``), f32;
* the band: one 64-term dot product per pixel and real disparity and side,
  ``2 * 64`` FLOP each, at the peak of the volume's type;
* CBCA: a round costs each volume element two integral-image differences
  (horizontal and vertical), two adds and one multiply by 1 / region:
  5 FLOP, f32;
* SGM: a sweep costs each element the neighbour minimum, the P1 add, two
  minima against the previous line and the P2 candidate, the two adds of
  the update and its share of the running minimum: 7 FLOP, f32;
* WTA: one compare an element of each volume, f32.

A bound counts each input byte read once and each output byte written
once, at HBM's rate (PERF.md, section 6).
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
LANE = 128

CBCA_FLOP_PER_ELEMENT = 5
SGM_FLOP_PER_ELEMENT = 7
SGM_SWEEPS = 4


def padded(size: int, bucket: int) -> int:
    return -(-size // bucket) * bucket


def d_pad(ndisp: int) -> int:
    return -(-ndisp // LANE) * LANE


def conv_flops(height: int, width: int) -> float:
    """Both images through the fast net's five convolutions."""
    return 2.0 * height * width * 2 * 9 * 64 * (1 + 4 * 64)


def pair_stage_flops(height: int, width: int, ndisp: int, rounds: int,
                     volume_dtype: str) -> dict:
    """{stage: (FLOP, operand type)} of one pair of the user's shape
    (height x width): two volumes of ``ndisp`` disparities."""
    volume = float(height) * width * ndisp
    return {
        "features": (conv_flops(height, width), "float32"),
        "band": (2.0 * height * width * ndisp * 64 * 2, volume_dtype),
        "cbca": (2 * rounds * CBCA_FLOP_PER_ELEMENT * volume, "float32"),
        "sgm": (2 * SGM_SWEEPS * SGM_FLOP_PER_ELEMENT * volume, "float32"),
        "wta": (2 * volume, "float32"),
    }


def ideal_pair_seconds(height: int, width: int, ndisp: int, rounds: int,
                       volume_dtype: str) -> float:
    """The least time a pair's operations take at each stage's peak."""
    return sum(flops / PEAK_FLOPS[kind] for flops, kind in pair_stage_flops(
        height, width, ndisp, rounds, volume_dtype).values())


def cbca_round_bytes(height: int, width: int, lanes: int,
                     element_bytes: int) -> float:
    """One CBCA round's launch: its volume (or chunk) in and out, the four
    int32 arm planes and the f32 1 / region plane read."""
    return (2.0 * height * width * lanes * element_bytes
            + 5.0 * height * width * 4)


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
