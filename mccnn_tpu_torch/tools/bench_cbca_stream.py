"""Measure the memory-traffic floor of a CBCA round's tiling, compute removed
(the port of tools/bench_cbca_stream.py, on kernel K10).

A CBCA round kernel reads a haloed window per output tile and writes the
tile. ``cbca_stream`` moves a volume through on-chip memory with exactly
that traffic ((tile_h + 2 x 16) x (tile_w + 2 x 16) x tile_d in, tile_h x
tile_w x tile_d out, ``csrc/cbca_stream.cu``, by TMA box copies) and no
arithmetic: the output equals the input. Its time is the floor for any
round kernel with this tiling; a round kernel's distance above it is the
price of its sums, and the floor's distance above bytes / memory rate is
the price of the tiling itself. ``Tensor.clone()`` is timed beside it as the plain copy.

    python -m mccnn_tpu_torch.tools.bench_cbca_stream

Env: H, W, D, TILE_H, TILE_W, TILE_D, DTYPE (bf16|f32|i8), ITERS,
LAYOUT (flat|dsplit).

LAYOUT=dsplit stores the volume as (D/tile_d, H, W, tile_d), the d-chunk
axis major, so a window row is one contiguous (span_w * tile_d)-element run
instead of a short fibre per (row, col): it measures whether the flat
layout's small contiguity is what caps the floor.

Needs a CUDA device; one report line, with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess

import torch

from mccnn_tpu_torch.kernels.build import (
    LAUNCHES,
    check,
    library,
    require_cuda,
    stream_handle,
)

_HALO = 16
_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "i8": torch.int8}


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def cbca_stream_plain(volume: torch.Tensor) -> torch.Tensor:
    """K10's plain version: a copy."""
    return volume.clone()


def cbca_stream(volume: torch.Tensor, tile_h: int, tile_w: int, tile_d: int,
                dsplit: bool = False) -> torch.Tensor:
    """K10 wrapper: a copy of ``volume`` made tile by tile through haloed
    windows on CUDA; ``cbca_stream_plain`` on the CPU.

    ``volume`` is (H, W, D), or (D / tile_d, H, W, tile_d) with ``dsplit``;
    H, W and D must be multiples of the tile and hold one haloed window, a
    chunk (tile_d lanes) a multiple of 16 bytes, and the data 16-byte
    aligned (TMA's copies need all three).
    """
    if volume.device.type == "cpu":
        return cbca_stream_plain(volume)
    require_cuda("volume", volume, tuple(_DTYPES.values()))
    if dsplit:
        n_chunks, height, width, lanes = volume.shape
        depth = n_chunks * lanes
    else:
        height, width, depth = volume.shape
        n_chunks = depth // max(tile_d, 1)
    itemsize = volume.element_size()
    span_h, span_w = tile_h + 2 * _HALO, tile_w + 2 * _HALO
    if (tile_h < 1 or tile_w < 1 or tile_d < 1 or depth % tile_d
            or height % tile_h or width % tile_w or height < span_h
            or width < span_w or (tile_d * itemsize) % 16
            or (dsplit and lanes != tile_d)):
        raise ValueError(
            f"cbca_stream: {tuple(volume.shape)} does not tile by "
            f"({tile_h}, {tile_w}, {tile_d}) with a {_HALO}-pixel halo and "
            "16-byte chunks")
    if volume.data_ptr() % 16:
        raise ValueError("cbca_stream: the volume's data is not 16-byte "
                         "aligned (a view at an odd storage offset)")
    chunk_bytes = tile_d * itemsize
    if dsplit:
        pixel_stride, chunk_stride = chunk_bytes, height * width * chunk_bytes
    else:
        pixel_stride, chunk_stride = depth * itemsize, chunk_bytes
    out = torch.empty_like(volume)
    code = library().mccnn_cbca_stream(
        volume.data_ptr(), out.data_ptr(), height, width, n_chunks, tile_h,
        tile_w, chunk_bytes, pixel_stride, chunk_stride,
        stream_handle(volume),
    )
    check(code, "cbca_stream")
    LAUNCHES.add("cbca_stream")
    return out


def _time_ms(fn, iters: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> str:
    """Run the probe once from the environment; prints and returns its
    report line."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_cbca_stream needs a CUDA device")
    height = int(os.environ.get("H", "1000"))
    width = int(os.environ.get("W", "1504"))
    d_pad = int(os.environ.get("D", "256"))
    tile_h = int(os.environ.get("TILE_H", "64"))
    tile_w = int(os.environ.get("TILE_W", "128"))
    tile_d = int(os.environ.get("TILE_D", "128"))
    iters = int(os.environ.get("ITERS", "4"))
    dtype_name = os.environ.get("DTYPE", "bf16")
    dtype = _DTYPES[dtype_name]
    layout = os.environ.get("LAYOUT", "flat")
    dsplit = layout == "dsplit"

    hp = _round_up(height, tile_h)
    wp = _round_up(width, tile_w)
    n_chunks = d_pad // tile_d
    span_h, span_w = tile_h + 2 * _HALO, tile_w + 2 * _HALO
    shape = (n_chunks, hp, wp, tile_d) if dsplit else (hp, wp, d_pad)

    generator = torch.Generator(device="cuda").manual_seed(0)
    if dtype == torch.int8:
        vol = torch.randint(-100, 100, shape, dtype=torch.int8,
                            device="cuda", generator=generator)
    else:
        vol = torch.randn(shape, dtype=torch.float32, device="cuda",
                          generator=generator).to(dtype)

    out = cbca_stream(vol, tile_h, tile_w, tile_d, dsplit)
    same = torch.equal(out, vol)
    del out
    per_round = _time_ms(
        lambda: cbca_stream(vol, tile_h, tile_w, tile_d, dsplit), iters)
    clone_ms = _time_ms(lambda: cbca_stream_plain(vol), iters)

    bytes_moved = hp * wp * d_pad * vol.element_size()
    read_amp = (span_h / tile_h) * (span_w / tile_w)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    line = (
        f"stream-only round ({hp}x{wp}x{d_pad} {dtype_name} {layout}, "
        f"th{tile_h} tw{tile_w} td{tile_d}): {per_round:.4f} ms "
        f"(output equals input={same}); traffic "
        f"{(1 + read_amp) * bytes_moved / 1e9:.2f} GB/round -> "
        f"{(1 + read_amp) * bytes_moved / per_round / 1e6:.0f} GB/s achieved;"
        f" Tensor.clone() {clone_ms:.4f} ms "
        f"({2 * bytes_moved / clone_ms / 1e6:.0f} GB/s) [{card}]"
    )
    print(line, flush=True)
    if not same:
        raise AssertionError("cbca_stream: the output differs from the input")
    return line


if __name__ == "__main__":
    main()
