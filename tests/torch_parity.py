"""Shared inputs for the tests that hold mccnn_tpu_torch against mccnn_tpu.

Inputs are made with numpy from a seed and handed to both packages; the
JAX weights come from ``init_params(jax.random.key(0))`` and cross over
through ``params_from_numpy``.

Importing this module pins torch to one intra-op thread: the suite runs in
several worker processes at once, and torch's default of one thread per
core in each of them oversubscribes the machine (the pipeline tests then
take minutes instead of seconds).
"""

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
