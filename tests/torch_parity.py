"""Shared inputs for the tests that hold mccnn_tpu_torch against mccnn_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX weights come from ``init_params(jax.random.key(0))`` and cross over
through ``params_from_numpy``. ``jitted`` compiles a JAX reference once per
shape and static arguments, where run op by op it would compile each of its
ops anew on every call.

Importing this module pins torch to one intra-op thread: the suite runs in
several worker processes at once, and torch's default of one thread per
core in each of them oversubscribes the machine (the pipeline tests then
take minutes instead of seconds).
"""

import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def jax_params(config=None):
    """The JAX package's seeded weights as a numpy tree."""
    import jax

    from mccnn_tpu.models.net import init_params

    args = (config,) if config is not None else ()
    return jax.tree.map(np.asarray, init_params(jax.random.key(0), *args))


@functools.lru_cache(maxsize=None)
def jitted(fn, *static):
    """``jax.jit(fn)`` with the arguments named in ``static`` static, made
    once per function and names, so a reference compiles once per shape and
    static values. Run op by op, the JAX functions compile each of their
    many small ops anew (every shift of a stencil, every fill of a border):
    most of the CPU time of the tests that compare the port with them."""
    import jax

    return jax.jit(fn, static_argnames=static)


# the static arguments of the JAX CBCA functions
_ROUND_STATIC = ("num_iterations", "distance_threshold", "tile_h",
                 "interpret", "compute_dtype", "ndisp", "choice")


def jitted_round(fn):
    """``jitted`` for a JAX CBCA function: static in those of its arguments
    that set the rounds, the radius, the tiling and the mode."""
    names = inspect.signature(fn).parameters
    return jitted(fn, *(name for name in _ROUND_STATIC if name in names))


def jax_arms(image, intensity_threshold, distance_threshold):
    """JAX ``compute_arms`` of an (H, W) image (integer results)."""
    import importlib

    # the module, not the function mccnn_tpu.ops re-exports under its name
    jcbca = importlib.import_module("mccnn_tpu.ops.cbca")
    return jitted(jcbca.compute_arms, "intensity_threshold",
                  "distance_threshold")(
        np.asarray(image, np.float32), intensity_threshold,
        distance_threshold)


def unit_features(rng, height, width, channels=64):
    """(H, W, C) random unit descriptors."""
    f = rng.standard_normal((height, width, channels)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def scene_pair(family="occlusion", height=48, width=64, seed=0,
               max_disparity=10):
    """Standardized (left, right, gt, ndisp) of a synthetic scene."""
    from mccnn_tpu_torch.pipeline.match import standardize_image
    from mccnn_tpu_torch.utils.scenes import make_scene

    s = make_scene(family, np.random.default_rng(seed), height, width,
                   max_disparity)
    return (standardize_image(s["left"]), standardize_image(s["right"]),
            s["gt"], s["ndisp"])


def require_card():
    """Skip unless a CUDA device is present (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def border_batch(rng, size=16, patch=11):
    """A (left, pos, neg) batch of (size, patch, patch, 1) patches in which
    some patches lie partly in the zero padding the sampler adds at the
    image borders: a 3 x 3 window wholly in it gives an activation of
    exactly 0 (a ReLU tie) while the biases are 0."""
    batch = [rng.standard_normal((size, patch, patch, 1)).astype(np.float32)
             for _ in range(3)]
    for x in batch:
        x[:size // 4, :4] = 0  # top border rows
        x[size // 4:size // 2, :, :3] = 0  # left border columns
        x[size // 2:size // 2 + 2, 7:, 8:] = 0  # a bottom-right corner
    return batch


def write_training_scenes(root, rng, count=2, height=32, width=40,
                          lists=("train", "val")):
    """``count`` random scenes in the Middlebury layout (im0.png, im1.png,
    disp0GT.pfm, calib.txt) under ``root/data`` and one list file per name
    in ``lists`` naming all of them; returns ``root``."""
    from PIL import Image

    from mccnn_tpu_torch.io.pfm import write_pfm

    lines = []
    for i in range(count):
        scene = root / "data" / f"s{i}"
        scene.mkdir(parents=True)
        for name in ("im0.png", "im1.png"):
            pixels = (rng.random((height, width)) * 255).astype(np.uint8)
            Image.fromarray(pixels, mode="L").save(scene / name)
        gt = rng.uniform(0, 12, (height, width)).astype(np.float32)
        gt[rng.random((height, width)) < 0.1] = np.inf  # unknown disparity
        write_pfm(gt, str(scene / "disp0GT.pfm"))
        (scene / "calib.txt").write_text(
            f"width={width}\nheight={height}\nndisp=16\n")
        lines.append(str(scene / "im0.png"))
    for name in lists:
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return root
