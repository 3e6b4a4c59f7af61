"""Weight files, without JAX (mccnn_tpu/models/params.py).

The same on-disk layouts as the JAX package, so either package loads the
other's files: the flat npz of ``save_params`` (``conv{i}/w``,
``conv{i}/b``), training checkpoints (``params:conv{i}/w`` keys; optimizer
slots ignored), the legacy anonymous ``leaf_{i}`` training snapshots and
the reference's npy dict (``conv{i}/weights:0``, written by
``save_reference_npy_dict``). All return the numpy tree
``{"conv{i}": {"w": HWIO, "b": (maps,)}}``; turn it into a network with
``net.params_from_numpy``. TF1 checkpoints need tensorflow and are not read
here: convert them with the JAX package first.
"""

from __future__ import annotations

import re

import numpy as np

from mccnn_tpu_torch.models.net import NumpyParams


def save_params(params: NumpyParams, path: str) -> None:
    """Save a params tree as a flat npz (keys ``conv{i}/w``, ``conv{i}/b``)."""
    flat = {}
    for name, layer in params.items():
        flat[f"{name}/w"] = np.asarray(layer["w"])
        flat[f"{name}/b"] = np.asarray(layer["b"])
    np.savez(path, **flat)


def load_params(path: str) -> NumpyParams:
    """Load a params tree from any of the npz layouts.

    ``save_params`` output (``conv{i}/w`` keys), training checkpoints
    (``params:conv{i}/w`` keys plus ``opt_leaf_{i}`` momentum slots, which
    are ignored) and legacy flat training snapshots (anonymous ``leaf_{i}``
    keys).
    """
    with np.load(path) as data:
        params: NumpyParams = {}
        if any(k.startswith("params:") for k in data.files):
            for key in data.files:
                if not key.startswith("params:"):
                    continue  # optimizer slots
                name, _, kind = key[len("params:"):].partition("/")
                params.setdefault(name, {})[kind] = np.asarray(data[key])
        elif any(k.startswith("leaf_") for k in data.files):
            params = _params_from_legacy_leaves(data)
        else:
            for key in data.files:
                name, _, kind = key.partition("/")
                params.setdefault(name, {})[kind] = np.asarray(data[key])
    _validate(params)
    return params


def _params_from_legacy_leaves(data) -> NumpyParams:
    """Reconstruct params from a legacy flat ``leaf_{i}`` training snapshot.

    The legacy writer flattened ``{"opt_state": ..., "params": ...}`` (dict
    keys in sorted order, so momentum leaves come first and mirror the
    params leaves shape for shape) or just ``{"params": ...}``. Params
    flatten as (b, w) pairs per layer in sorted layer-name order ("conv1" <
    "conv10" < "conv2").

    The format is anonymous, so the mirror detection is a heuristic: a
    2-way shape mirror is momentum + params (drop the first half); a 3-way
    mirror is another optimizer's state, whose slots would parse into
    plausible but wrong layers, so it raises.
    """
    n = int(data["num_leaves"]) if "num_leaves" in data.files else len(
        [k for k in data.files if k.startswith("leaf_")]
    )
    leaves = [np.asarray(data[f"leaf_{i}"]) for i in range(n)]

    def mirrors(k: int) -> bool:
        """All k equal-length parts shape-identical (a k-way state mirror)."""
        part = n // k
        return n % k == 0 and part > 0 and all(
            leaves[j].shape == leaves[p * part + j].shape
            for p in range(1, k) for j in range(part)
        )

    if mirrors(3):
        raise ValueError(
            "legacy snapshot has a 3-way mirrored leaf layout (non-momentum "
            "optimizer state?); cannot identify the params half: re-save "
            "it with named keys"
        )
    if mirrors(2):
        leaves = leaves[n // 2:]  # drop the momentum mirror
    if len(leaves) % 2:
        raise ValueError(f"cannot split {len(leaves)} leaves into (b, w) pairs")
    # pair j belongs to the j-th layer name in sorted string order
    names = sorted(f"conv{i + 1}" for i in range(len(leaves) // 2))
    params: NumpyParams = {}
    for i in range(0, len(leaves), 2):
        b, w = leaves[i], leaves[i + 1]
        if b.ndim != 1 or w.ndim != 4:
            raise ValueError(
                f"legacy leaf pair {i // 2} has shapes {b.shape}/{w.shape}, "
                "expected 1-D bias + 4-D kernel"
            )
        params[names[i // 2]] = {"b": b, "w": w}
    return params


def load_reference_npy_dict(path: str) -> NumpyParams:
    """Convert the reference's npy weight dict (HWIO kernels, bias vectors)."""
    weights_dict = np.load(path, encoding="bytes", allow_pickle=True).item()
    params: NumpyParams = {}
    for raw_key, value in weights_dict.items():
        key = raw_key.decode() if isinstance(raw_key, bytes) else str(raw_key)
        match = re.match(r"(conv\d+)/(weights|biases)(:0)?$", key)
        if match is None:
            continue
        name, kind = match.group(1), match.group(2)
        params.setdefault(name, {})["w" if kind == "weights" else "b"] = (
            np.asarray(value, dtype=np.float32)
        )
    _validate(params)
    return params


def save_reference_npy_dict(params: NumpyParams, path: str) -> None:
    """Save a params tree as the reference's npy dict (keys
    ``conv{i}/weights:0``, ``conv{i}/biases:0``), which
    ``load_reference_npy_dict`` reads back unchanged."""
    weights_dict = {}
    for name, layer in params.items():
        weights_dict[f"{name}/weights:0"] = np.asarray(layer["w"])
        weights_dict[f"{name}/biases:0"] = np.asarray(layer["b"])
    np.save(path, weights_dict)


def load_any(path: str) -> NumpyParams:
    """Load weights from any of the npz layouts or a reference npy dict."""
    if path.endswith(".npz"):
        return load_params(path)
    if path.endswith(".npy"):
        return load_reference_npy_dict(path)
    raise ValueError(
        f"{path}: the PyTorch port reads .npz and reference .npy weights; a "
        "TF1 checkpoint needs tensorflow: convert it with the JAX package's "
        "mccnn_tpu.cli.convert first"
    )


def _validate(params: NumpyParams) -> None:
    if not params:
        raise ValueError("no conv layers found in weight file")
    layer_ids = sorted(int(n[4:]) for n in params)
    if layer_ids != list(range(1, len(layer_ids) + 1)):
        raise ValueError(f"non-contiguous conv layers: {layer_ids}")
    for name, layer in params.items():
        if "w" not in layer or "b" not in layer:
            raise ValueError(f"layer {name} missing weights or biases")
