"""Time K10 (``csrc/cbca_stream.cu``) beside ring shapes it does not ship,
on one card.

    python -m mccnn_tpu_torch.tools.time_stream_variants [--against DIR]

K10 streams each block's haloed window through a ring of shared-memory
slots by TMA: ``kStages`` slots of at most ``kSlotBytes``, its tensor maps
asking L2 for ``kPromotion`` (0 none, 1 64 B, 2 128 B, 3 256 B) a request,
and where a pixel is one chunk a box's first dimension holding whole
window rows (``kRowRuns``; 0 keeps one run per pixel's chunk, as flat
volumes of several chunks always do). This tool compiles the source again
at other values of the four, by defining ``MCCNN_STREAM_STAGES``,
``_SLOT_BYTES``, ``_PROMOTION`` and ``_ROW_RUNS`` and renaming the C entry
point, one ``nvcc`` per variant, all started together.
``--against DIR`` adds another ``csrc`` directory's ``cbca_stream.cu`` (an
older tree's, with the same C entry) as one more variant, "against". Each
variant is checked against its input bit for bit and timed with the shipped
kernel (``cbca_stream``) and ``Tensor.clone()`` on the same bf16 volume
with CUDA events, in turns (forward through the list, then back), at the
tiling of K2 (256 x 32 x 16 lanes, flat and dsplit), at 32 x 32 x 8 and at
the probe's default 64 x 128 x 128, on 1024 x 1536 x 256 (1000 x 1504
padded to whole tiles, as ``chip_smoke.py`` phase 7 and the probe pad it).
Prints each variant's registers, a JSON line per case as it is timed, then
one with every case and the card's name and power limit; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
from pathlib import Path

import torch

from mccnn_tpu_torch.kernels.build import (
    BUILD_DIR,
    NVCC_FLAGS,
    SOURCE_DIR,
    build,
    nvcc,
    stream_handle,
)
from mccnn_tpu_torch.tools.bench_cbca_stream import cbca_stream

SHAPE = (1024, 1536, 256)
REPS = 20
# label -> (stages, slot bytes, L2 promotion, row runs); the shipped values
# (8, 16384, 2, 1) are timed through the port's own wrapper
VARIANTS = {
    "s6 16K p128": (6, 16384, 2, 1),
    "s10 16K p128": (10, 16384, 2, 1),
    "s13 16K p128": (13, 16384, 2, 1),
    "s8 24K p128": (8, 24576, 2, 1),
    "s8 8K p128": (8, 8192, 2, 1),
    "s16 8K p128": (16, 8192, 2, 1),
    "s8 16K p256": (8, 16384, 3, 1),
    "s8 16K p128 chunk runs": (8, 16384, 2, 0),
}
# case -> (tile_h, tile_w, tile_d, dsplit)
CASES = {
    "K2 tiling flat": (256, 32, 16, False),
    "K2 tiling dsplit": (256, 32, 16, True),
    "32x32x8 flat": (32, 32, 8, False),
    "default 64x128x128 flat": (64, 128, 128, False),
}
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 \
    + [ctypes.c_void_p]


def _tag(label: str) -> str:
    return label.replace(" ", "_")


def build_variants(against: Path | None = None) -> tuple[ctypes.CDLL, list]:
    """Compile every variant (one nvcc each, together) and load them as one
    library; prints each kernel's registers. Returns the library and the
    variants' labels."""
    out_dir = BUILD_DIR / "stream_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {label: ([f"-DMCCNN_STREAM_STAGES={stages}",
                       f"-DMCCNN_STREAM_SLOT_BYTES={slot}",
                       f"-DMCCNN_STREAM_PROMOTION={promotion}",
                       f"-DMCCNN_STREAM_ROW_RUNS={row_runs}"], SOURCE_DIR)
              for label, (stages, slot, promotion, row_runs)
              in VARIANTS.items()}
    if against is not None:
        builds["against"] = ([], against)
    procs, objects = [], []
    for label, (defines, source_dir) in builds.items():
        obj = out_dir / f"cbca_stream_{_tag(label)}.o"
        objects.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *defines,
             f"-Dmccnn_cbca_stream=cbca_stream_{_tag(label)}", "-c", "-o",
             str(obj), str(source_dir / "cbca_stream.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    (out_dir / "build.log").write_text("".join(logs))
    if any(proc.returncode for proc in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs)[-6000:])
    for label, log in zip(builds, logs):
        used = re.findall(r"Used \d+ registers[^\n]*", log)
        print(f"  {label}: {used}", flush=True)
    lib_path = out_dir / "libstream_variants.so"
    subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *objects], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for label in builds:
        getattr(lib, f"cbca_stream_{_tag(label)}").argtypes = _ARGS
    return lib, list(builds)


def _checked(code: int) -> None:
    if code:
        raise RuntimeError(f"variant launch failed: CUDA error {code}")


def _time_ms(fn) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="a csrc directory whose cbca_stream.cu is "
                        "timed as one more variant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_stream_variants needs a CUDA device")
    build()
    lib, labels = build_variants(args.against)
    height, width, depth = SHAPE
    generator = torch.Generator(device="cuda").manual_seed(0)
    flat = torch.randn(SHAPE, device="cuda", generator=generator).to(
        torch.bfloat16)
    results = {}
    for case, (tile_h, tile_w, tile_d, dsplit) in CASES.items():
        vol = flat
        if dsplit:
            vol = flat.reshape(height, width, depth // tile_d, tile_d).permute(
                2, 0, 1, 3).contiguous()
        out = torch.empty_like(vol)
        chunk = tile_d * vol.element_size()
        strides = ((chunk, height * width * chunk) if dsplit
                   else (depth * vol.element_size(), chunk))
        ints = (height, width, depth // tile_d, tile_h, tile_w, chunk,
                *strides)
        fns = {"shipped": lambda v=vol, t=(tile_h, tile_w, tile_d, dsplit):
               cbca_stream(v, *t),
               "clone": vol.clone}
        for label in labels:
            fns[label] = functools.partial(
                lambda e: _checked(e(vol.data_ptr(), out.data_ptr(), *ints,
                                     stream_handle(vol))),
                getattr(lib, f"cbca_stream_{_tag(label)}"))
        if not torch.equal(fns["shipped"](), vol):
            raise AssertionError(f"{case}: the shipped kernel differs")
        for label in labels:
            out.zero_()
            fns[label]()
            if not torch.equal(out, vol):
                raise AssertionError(f"{case} {label}: differs from the "
                                     "input")
        order = list(fns) + list(fns)[::-1]
        times = {label: [] for label in fns}
        for label in order:
            times[label].append(_time_ms(fns[label]))
        results[case] = {label: sum(t) / len(t) for label, t in times.items()}
        print(json.dumps({case: results[case]}), flush=True)
        del out, vol
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    report = {"card": card, "shape": list(SHAPE), "dtype": "bf16",
              "variants": {k: list(v) for k, v in VARIANTS.items()},
              "cases": {k: list(v) for k, v in CASES.items()},
              "ms": results}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
