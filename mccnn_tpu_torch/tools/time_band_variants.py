"""Time K1's f32 route (``csrc/band.cu``), K5 (``csrc/band_pair.cu``) and
K6 (``csrc/band_vpu.cu``) beside tile shapes of their block routine that
they do not ship, on one card.

    python -m mccnn_tpu_torch.tools.time_band_variants [--against DIR]

The three run one block routine (``csrc/band_tile.cuh``): K5 and K6 store
both bands off each tile, K1's f32 route one band in either direction.
Each ships its register tile and column tile (K5's and K6's
``ShippedTile``, K1's ``SideTile``). This tool compiles the three sources
again, all at one other shape -- a thread's columns x disparities (``Bw``
x ``Bd``) and the block's columns -- by defining ``MCCNN_BAND_TILE_BW``,
``_BD`` and ``_W`` and renaming the C entry points, one ``nvcc`` per
source and shape under the build directory, all started together. ``--against DIR`` adds the
three sources of another ``csrc`` directory (an older tree's) as one more
variant, "against". The variants are loaded with ``ctypes`` beside the
port's library, checked against the shipped kernels bit for bit, and timed
with the shipped kernels (``band_side``, ``band_pair``,
``band_pair_scores``) on the same operands with CUDA events, in turns
(forward through the list, then back). The operands are those of the main
path: unit descriptors at 1000 x 1504, ndisp 200, D_pad 256; K1 in f32 on
either side (paths E, halfexact), K5 in f32 (path T) and bf16, K6 with f32
and bf16 output. Prints the registers and spills of every variant, a JSON
line per case as it is timed, then one with every case and the card's name
and power limit; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from mccnn_tpu_torch.kernels.build import (
    BUILD_DIR,
    NVCC_FLAGS,
    SOURCE_DIR,
    build,
    nvcc,
)
from mccnn_tpu_torch.ops.cost_volume import (
    band_pair,
    band_pair_scores,
    band_side,
)

SHAPE = (1000, 1504)
NDISP, D_PAD = 200, 256
REPS = 10
# label -> (Bw, Bd, block columns); the shipped shapes (K1's 4 x 16, K5's
# and K6's 8 x 8, all at 64 columns) are timed through the port's own
# wrappers, and each is also a variant of the others
VARIANTS = {
    "8x8 w64": (8, 8, 64),
    "8x8 w128": (8, 8, 128),
    "8x8 w256": (8, 8, 256),
    "4x8 w32": (4, 8, 32),
    "4x8 w64": (4, 8, 64),
    "8x4 w64": (8, 4, 64),
    "4x16 w64": (4, 16, 64),
    "16x4 w128": (16, 4, 128),
}
# the sources and their C entries, renamed per variant
SOURCES = {"band.cu": ("mccnn_band_side", "mccnn_error_string"),
           "band_pair.cu": ("mccnn_band_pair",),
           "band_vpu.cu": ("mccnn_band_scores",)}
_SIDE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_PAIR_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SCORE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _tag(label: str) -> str:
    return label.replace(" ", "_")


def build_variants(against: Path | None = None) -> tuple[ctypes.CDLL, list]:
    """Compile every variant of both sources (one nvcc each, together) and
    load them as one library; prints each kernel's registers and spills.
    Returns the library and the variants' labels."""
    out_dir = BUILD_DIR / "band_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {label: ([f"-DMCCNN_BAND_TILE_BW={bw}",
                       f"-DMCCNN_BAND_TILE_BD={bd}",
                       f"-DMCCNN_BAND_TILE_W={tile_w}"], SOURCE_DIR)
              for label, (bw, bd, tile_w) in VARIANTS.items()}
    if against is not None:
        builds["against"] = ([], against)
    procs, objects, names = [], [], []
    for label, (defines, source_dir) in builds.items():
        tag = _tag(label)
        for source, entries in SOURCES.items():
            names.append(f"{label} {source}")
            obj = out_dir / f"{source[:-3]}_{tag}.o"
            objects.append(str(obj))
            renames = [f"-D{entry}={entry[len('mccnn_'):]}_{tag}"
                       for entry in entries]
            procs.append(subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, *defines, *renames, "-c", "-o",
                 str(obj), str(source_dir / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    (out_dir / "build.log").write_text("".join(logs))
    if any(proc.returncode for proc in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs)[-6000:])
    for name, log in zip(names, logs):
        # per instantiation (storage or output type), in the log's order
        registers = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"  {name}: registers {registers}, spill stores {spills} "
              "bytes", flush=True)
    lib_path = out_dir / "libband_variants.so"
    subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *objects], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for label in builds:
        tag = _tag(label)
        getattr(lib, f"band_side_{tag}").argtypes = _SIDE_ARGS
        getattr(lib, f"band_pair_{tag}").argtypes = _PAIR_ARGS
        getattr(lib, f"band_scores_{tag}").argtypes = _SCORE_ARGS
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
                        help="a csrc directory whose band.cu, "
                        "band_pair.cu and band_vpu.cu are timed as one more "
                        "variant")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_band_variants needs a CUDA device")
    build()
    lib, labels = build_variants(args.against)
    height, width = SHAPE
    rng = np.random.default_rng(0)
    feats = []
    for _ in "lr":
        f = rng.standard_normal((height, width, 64)).astype(np.float32)
        f /= np.linalg.norm(f, axis=-1, keepdims=True)
        feats.append(torch.from_numpy(f).cuda())
    stream = torch.cuda.current_stream().cuda_stream
    fl, fr = feats
    f32, bf16 = torch.float32, torch.bfloat16
    bl, br = (f.to(bf16) for f in feats)
    size = (height, width, 64, D_PAD)
    results = {}
    # case, operands, the shipped call, the entry and its integer arguments
    cases = (
        ("K1 f32 left", (fl, fr),
         lambda: (band_side(fl, fr, NDISP, D_PAD, "left", f32),),
         "band_side", (*size, NDISP, 0, 0)),
        ("K1 f32 right", (fr, fl),
         lambda: (band_side(fr, fl, NDISP, D_PAD, "right", f32),),
         "band_side", (*size, NDISP, 1, 0)),
        ("K5 f32", (fl, fr), lambda: band_pair(fl, fr, NDISP, D_PAD, f32),
         "band_pair", (*size, NDISP, 0)),
        ("K5 bf16", (bl, br), lambda: band_pair(bl, br, NDISP, D_PAD, bf16),
         "band_pair", (*size, NDISP, 1)),
        ("K6 f32 out", (fl, fr), lambda: band_pair_scores(fl, fr, D_PAD),
         "band_scores", (*size, 0)),
        ("K6 bf16 out", (fl, fr),
         lambda: band_pair_scores(fl, fr, D_PAD, bf16), "band_scores",
         (*size, 1)),
    )
    for case, operands, shipped, entry, ints in cases:
        want = shipped()
        outs = [torch.empty_like(w) for w in want]
        ptrs = [t.data_ptr() for t in (*operands, *outs)]
        fns = {"shipped": shipped}
        for label in labels:
            fns[label] = functools.partial(
                lambda e: _checked(e(*ptrs, *ints, stream)),
                getattr(lib, f"{entry}_{_tag(label)}"))
        for label, fn in fns.items():
            if label == "shipped":
                continue
            for out in outs:
                out.zero_()
            fn()
            if not all(torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{case} {label}: differs from the "
                                     "shipped kernel")
        del want
        order = list(fns) + list(fns)[::-1]
        times = {label: [] for label in fns}
        for label in order:
            times[label].append(_time_ms(fns[label]))
        results[case] = {label: sum(t) / len(t) for label, t in times.items()}
        print(json.dumps({case: results[case]}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    report = {"card": card, "shape": [*SHAPE, D_PAD], "ndisp": NDISP,
              "variants": {k: list(v) for k, v in VARIANTS.items()},
              "ms": results}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
