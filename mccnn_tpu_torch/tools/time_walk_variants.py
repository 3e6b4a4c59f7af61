"""Time K8 (``csrc/cbca_rolling.cu``) beside shapes of its walk that it
does not ship, on one card.

    python -m mccnn_tpu_torch.tools.time_walk_variants

K8 is one instantiation of the CBCA walk (``csrc/cbca_walk.cuh``). This
tool writes other instantiations of the same walk -- bands of 256 and 512
rows and of the whole height, K2's block shape (256 threads, 16-row steps)
and K7's lever (512 threads, 32-row steps) in f32 -- as C entry points with
K8's signature into one CUDA source per band under the build directory,
compiles them with ``nvcc`` in parallel, loads them with ``ctypes`` beside
the port's library, checks each against K8 bit for bit, and times all of
them and K8 itself (``cbca_rolling_round_cuda``) on the same operands with
CUDA events, in turns (forward through the list, then back). The operands
are those of the main path at R = 13: 1000 x 1504 x 256, distance 14, the
arms of a synthetic ``occlusion`` scene and of a constant image (every arm
at the radius); bf16 storage, f32 storage, and bf16 operands on f32
storage. Prints a JSON line per case as it is timed, then one with every
case and the card's name and power limit; needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess

import numpy as np
import torch

from mccnn_tpu_torch.kernels.build import (
    BUILD_DIR,
    NVCC_FLAGS,
    SOURCE_DIR,
    build,
    nvcc,
)
from mccnn_tpu_torch.ops.cbca import compute_arms, inverse_region_size
from mccnn_tpu_torch.ops.cbca_rolling import cbca_rolling_round_cuda
from mccnn_tpu_torch.ops.common import BIG_COST
from mccnn_tpu_torch.pipeline.match import standardize_image
from mccnn_tpu_torch.utils.config import MatchConfig
from mccnn_tpu_torch.utils.scenes import make_scene

SHAPE = (1000, 1504, 256)
NDISP = 200
DISTANCE = 14
REPS = 10
# band rows; 1 << 16 is one band over any image this tool makes
BANDS = {"256": 256, "512": 512, "whole": 1 << 16}
# (storage, threads, rows per step) at R = 13
SHAPES = (("bf16", 256, 16), ("f32", 256, 16), ("f32", 512, 32))
_CTYPE = {"bf16": "__nv_bfloat16", "f32": "float"}
_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _entry(storage: str, threads: int, band: str) -> str:
    return f"walk_{storage}_{threads}_{band}"


def _source(band: str) -> str:
    """One CUDA source with an entry per block shape at this band."""
    lines = ['#include "cbca_walk.cuh"']
    for storage, threads, batch in SHAPES:
        t = _CTYPE[storage]
        lines.append(
            f'extern "C" int {_entry(storage, threads, band)}('
            "const void* a, void* b, const int* l, const int* r, "
            "const int* u, const int* d, const float* inv, int h, int w, "
            "int dp, int radius, int rounded, void* s) {\n"
            f"  return static_cast<int>(launch_walk<{t}, 13, {threads}, "
            f"{batch}, kPixelBytes / sizeof({t}), {BANDS[band]}>(a, b, l, "
            "r, u, d, inv, h, w, dp, radius, rounded, "
            "static_cast<cudaStream_t>(s)));\n}")
    return "\n".join(lines) + "\n"


def build_variants() -> ctypes.CDLL:
    """Compile the variants (one nvcc per band, together) and load them."""
    out_dir = BUILD_DIR / "walk_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, objects = [], []
    for band in BANDS:
        src = out_dir / f"band_{band}.cu"
        src.write_text(_source(band))
        obj = out_dir / f"band_{band}.o"
        objects.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-I", str(SOURCE_DIR), "-c", "-o",
             str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    (out_dir / "build.log").write_text("".join(logs))
    if any(proc.returncode for proc in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs)[-6000:])
    lib_path = out_dir / "libwalk_variants.so"
    subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    *objects], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for storage, threads, _ in SHAPES:
        for band in BANDS:
            fn = getattr(lib, _entry(storage, threads, band))
            fn.argtypes, fn.restype = _ARGS, ctypes.c_int
    return lib


def _launcher(fn, vol, out, arms, inv, rounded):
    """A call of variant entry ``fn`` on these operands at R = 13."""
    height, width, d_pad = vol.shape
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = fn(vol.data_ptr(), out.data_ptr(), arms.left.data_ptr(),
                  arms.right.data_ptr(), arms.up.data_ptr(),
                  arms.down.data_ptr(), inv.data_ptr(), height, width, d_pad,
                  DISTANCE - 1, rounded, stream)
        if code:
            raise RuntimeError(f"variant launch failed: CUDA error {code}")
    return launch


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


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("time_walk_variants needs a CUDA device")
    build()
    lib = build_variants()
    rng = np.random.default_rng(0)
    scene = make_scene("occlusion", rng, *SHAPE[:2], 150)
    image = torch.from_numpy(standardize_image(scene["left"])).cuda()
    config = MatchConfig()
    values = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    values[..., NDISP:] = BIG_COST
    vol32 = torch.from_numpy(values).cuda()
    operands = {"bf16": vol32.to(torch.bfloat16), "f32": vol32}
    arm_sets = {}
    flat = torch.zeros_like(image)
    for name, img in (("scene", image), ("full arms", flat)):
        arms = compute_arms(img, config.cbca_intensity, DISTANCE)
        arm_sets[name] = (arms, inverse_region_size(arms, DISTANCE)
                          .contiguous())
    # (case, storage, arms, bf16 operands)
    cases = (("bf16", "bf16", "scene", 0),
             ("bf16 full arms", "bf16", "full arms", 0),
             ("f32", "f32", "scene", 0),
             ("f32 bf16 operands", "f32", "scene", 1))
    results = {}
    for case, storage, arm_name, rounded in cases:
        vol = operands[storage]
        arms, inv = arm_sets[arm_name]
        out = torch.empty_like(vol)
        compute = torch.bfloat16 if rounded else None
        fns = {"K8": functools.partial(cbca_rolling_round_cuda, vol, out,
                                       arms, inv, DISTANCE, compute)}
        for s, threads, batch in SHAPES:
            for band in BANDS:
                if s == storage:
                    fns[f"{threads} threads, {batch}-row steps, band "
                        f"{band}"] = _launcher(
                        getattr(lib, _entry(s, threads, band)), vol, out,
                        arms, inv, rounded)
        fns["K8"]()
        want = out.clone()
        for label, fn in fns.items():
            out.zero_()
            fn()
            if not torch.equal(out, want):
                raise AssertionError(f"{case} {label}: differs from K8")
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
    report = {"card": card, "shape": list(SHAPE), "distance": DISTANCE,
              "ms": results}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
