"""The yardstick's arithmetic: the card's peaks and the work of a pair.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in f32 outside the tensor cores, 989 TFLOP/s in bf16,
1,979 TOP/s in int8, HBM at 3.35 TB/s.

The operations of a pair follow the paper's algorithm on the user's
pixels (H x W before the bucket's padding) and the real disparities
(``ndisp``, not the lanes the program pads them to), whatever implements a
stage, so the program's padding counts as no work:

* features: the net's ``num_layers`` N VALID convolutions of
  ``num_maps`` maps (k x k, on ``input_channels`` channels) on both
  images, ``2 * H * W * 2 * k^2 * maps * (cin + (N - 1) * maps)`` FLOP;
  the fast net's 5 x 64 at 3 x 3 is ``bench.py::_stage_profile``'s
  ``2 * H * W * 2 * 9 * 64 * (1 + 4 * 64)``; f32;
* the band (fast net, no ``num_fc_layers``): one ``maps``-term dot
  product per pixel and real disparity and side, ``2 * maps`` FLOP each,
  at the peak of the volume's type;
* the decision network (accurate net, ``num_fc_layers`` L > 0 of
  ``num_fc_units`` U, in place of the band): only its matrix products.
  ``fc1`` splits into a left and a right half, each applied once per
  pixel of its image, ``2 * H * W * 2 * maps * U``; then once per pixel
  and real disparity the hidden and output layers, ``(L - 1) * 2 * U^2 +
  2 * U``, and ``2 * U`` for adding the halves and the bias. Counted once
  and not once a side: the right volume re-indexes the left one,
  ``C_R(x, d) = C_L(x + d, d)`` wherever both exist, so a program that
  runs the network for both sides reads half the share, never over 100%.
  At the peak of the volume's type, as the band;
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


# the fast net of the paper's Middlebury column; ``net`` left out means it
FAST_NET = {"num_layers": 5, "num_maps": 64, "kernel_size": 3,
            "input_channels": 1}


def conv_flops(height: int, width: int, net: dict | None = None) -> float:
    """Both images through the net's convolutions."""
    net = net or FAST_NET
    k, maps = net["kernel_size"], net["num_maps"]
    return 2.0 * height * width * 2 * k * k * maps * (
        net["input_channels"] + (net["num_layers"] - 1) * maps)


def decision_flops(height: int, width: int, ndisp: int, net: dict) -> float:
    """The accurate net's fully connected layers over one pair, counted
    once for both volumes (the module docstring)."""
    maps, units = net["num_maps"], net["num_fc_units"]
    per_pixel = 2.0 * height * width * 2 * maps * units
    per_element = ((net["num_fc_layers"] - 1) * 2 * units * units
                   + 2 * units + 2 * units)
    return per_pixel + float(height) * width * ndisp * per_element


def pair_stage_flops(height: int, width: int, ndisp: int, rounds: int,
                     volume_dtype: str, net: dict | None = None) -> dict:
    """{stage: (FLOP, operand type)} of one pair of the user's shape
    (height x width): two volumes of ``ndisp`` disparities. ``band`` for
    the fast net, ``decision`` for a net with fully connected layers."""
    net = net or FAST_NET
    volume = float(height) * width * ndisp
    stages = {"features": (conv_flops(height, width, net), "float32")}
    if net.get("num_fc_layers", 0):
        stages["decision"] = (decision_flops(height, width, ndisp, net),
                              volume_dtype)
    else:
        stages["band"] = (2.0 * height * width * ndisp * net["num_maps"] * 2,
                          volume_dtype)
    stages["cbca"] = (2 * rounds * CBCA_FLOP_PER_ELEMENT * volume, "float32")
    stages["sgm"] = (2 * SGM_SWEEPS * SGM_FLOP_PER_ELEMENT * volume,
                     "float32")
    stages["wta"] = (2 * volume, "float32")
    return stages


def ideal_pair_seconds(height: int, width: int, ndisp: int, rounds: int,
                       volume_dtype: str, net: dict | None = None) -> float:
    """The least time a pair's operations take at each stage's peak."""
    return sum(flops / PEAK_FLOPS[kind] for flops, kind in pair_stage_flops(
        height, width, ndisp, rounds, volume_dtype, net).values())


def cbca_round_bytes(height: int, width: int, lanes: int,
                     element_bytes: int) -> float:
    """One CBCA round's launch: its volume (or chunk) in and out, the four
    int32 arm planes and the f32 1 / region plane read."""
    return (2.0 * height * width * lanes * element_bytes
            + 5.0 * height * width * 4)


def bound_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
