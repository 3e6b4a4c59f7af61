"""Training checkpoints without JAX (mccnn_tpu/utils/checkpoint.py).

The same archive as the JAX package, so each package resumes from the
other's ``model_epoch{N}.npz``:

- ``params:conv{i}/w`` (HWIO) and ``params:conv{i}/b``;
- ``opt_leaf_{i}``: the leaves of ``jax.tree.flatten(optax_state)`` for
  ``optax.sgd(momentum=beta)``, which are the momentum traces in sorted
  dict-key order (``conv1/b``, ``conv1/w``, ``conv10/b``, ..., ``conv2/b``:
  a string sort), and ``num_opt_leaves``.

Legacy archives hold one flat ``leaf_{i}`` list over the whole state dict
(``opt_state`` leaves, then ``params``, each in that order) and are read as
the JAX package reads them. Here the state is two numpy trees
``{"conv{i}": {"w": HWIO, "b"}}``: the params and the momentum traces
(``pipeline/train.py::momentum_to_numpy``).

Unlike the JAX copy, which counts the ``opt_leaf_*`` keys and then reads
indices from 0, ``load_checkpoint`` reads each leaf by its index and
refuses an archive whose indices have a gap or whose ``num_opt_leaves``
differs from the leaves it holds.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from mccnn_tpu_torch.models.net import NumpyParams

_CKPT_RE = re.compile(r"model_epoch(\d+)\.npz$")
_OPT_LEAF_RE = re.compile(r"opt_leaf_(\d+)$")


def checkpoint_path(directory: str, epoch: int) -> str:
    return os.path.join(directory, f"model_epoch{epoch}.npz")


def _leaf_order(tree: NumpyParams) -> List[Tuple[str, str]]:
    """(layer, kind) pairs in the order ``jax.tree.flatten`` visits a dict
    tree: keys sorted as strings at every level."""
    return [(name, kind) for name in sorted(tree)
            for kind in sorted(tree[name])]


def save_checkpoint(
    directory: str,
    epoch: int,
    params: NumpyParams,
    momentum: Optional[NumpyParams] = None,
    max_to_keep: int = 10,
) -> str:
    """Write params (and the momentum traces) as ``model_epoch{epoch}.npz``;
    keep the newest ``max_to_keep`` checkpoints of the directory."""
    os.makedirs(directory, exist_ok=True)
    payload = {}
    for name, layer in params.items():
        for kind, value in layer.items():
            payload[f"params:{name}/{kind}"] = np.asarray(value)
    if momentum is not None:
        leaves = [momentum[name][kind] for name, kind in _leaf_order(momentum)]
        for i, leaf in enumerate(leaves):
            payload[f"opt_leaf_{i}"] = np.asarray(leaf)
        payload["num_opt_leaves"] = np.asarray(len(leaves))
    path = checkpoint_path(directory, epoch)
    np.savez(path, **payload)
    _prune(directory, max_to_keep)
    return path


def _prune(directory: str, max_to_keep: int) -> None:
    found: List[Tuple[int, str]] = []
    for name in os.listdir(directory):
        match = _CKPT_RE.match(name)
        if match:
            found.append((int(match.group(1)), os.path.join(directory, name)))
    found.sort()
    for _, path in found[:-max_to_keep] if max_to_keep > 0 else []:
        os.remove(path)


def latest_checkpoint(directory: str) -> Optional[str]:
    best: Optional[Tuple[int, str]] = None
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        match = _CKPT_RE.match(name)
        if match:
            entry = (int(match.group(1)), os.path.join(directory, name))
            if best is None or entry[0] > best[0]:
                best = entry
    return best[1] if best else None


def epoch_of(path: str) -> int:
    match = _CKPT_RE.search(os.path.basename(path))
    if not match:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(match.group(1))


def _opt_leaves(path: str, data) -> List[np.ndarray]:
    """The ``opt_leaf_{i}`` arrays by index; refuses gaps and a count that
    differs from ``num_opt_leaves``."""
    indices = sorted(int(m.group(1)) for m in map(_OPT_LEAF_RE.match,
                                                  data.files) if m)
    if indices != list(range(len(indices))):
        missing = sorted(set(range(max(indices) + 1)) - set(indices))
        raise ValueError(f"checkpoint {path}: optimizer leaves {missing} "
                         f"missing from opt_leaf_0..{max(indices)}")
    if ("num_opt_leaves" in data.files
            and int(data["num_opt_leaves"]) != len(indices)):
        raise ValueError(
            f"checkpoint {path}: num_opt_leaves is "
            f"{int(data['num_opt_leaves'])} but it holds {len(indices)} "
            "opt_leaf_* arrays")
    return [np.asarray(data[f"opt_leaf_{i}"]) for i in indices]


def _fill(like: NumpyParams, leaves: List[np.ndarray], path: str
          ) -> NumpyParams:
    """A tree of ``like``'s structure from its leaves in flatten order."""
    order = _leaf_order(like)
    if len(leaves) != len(order):
        raise ValueError(
            f"checkpoint {path} has {len(leaves)} optimizer leaves but the "
            f"restore template expects {len(order)} (different optimizer?)")
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for (name, kind), leaf in zip(order, leaves):
        tree.setdefault(name, {})[kind] = leaf
    return tree


def load_checkpoint(path: str, like: dict) -> dict:
    """Restore ``{"params": tree, "momentum": tree or None}`` in the
    structure of ``like`` (the same keys; ``like["momentum"]`` None restores
    params only). Reads the named archives of ``save_checkpoint`` (either
    package's) and the legacy flat ``leaf_{i}`` ones."""
    want_momentum = like.get("momentum") is not None
    with np.load(path) as data:
        if any(k.startswith("params:") for k in data.files):
            params: Dict[str, Dict[str, np.ndarray]] = {}
            for key in data.files:
                if key.startswith("params:"):
                    name, _, kind = key[len("params:"):].partition("/")
                    params.setdefault(name, {})[kind] = np.asarray(data[key])
            momentum = None
            if want_momentum:
                if not any(_OPT_LEAF_RE.match(k) for k in data.files):
                    raise ValueError(
                        f"checkpoint {path} carries no optimizer state "
                        "(saved without momentum: weights only), but the "
                        "restore template expects one; resume with a fresh "
                        "optimizer or load the weights with "
                        "models.params.load_any")
                momentum = _fill(like["momentum"], _opt_leaves(path, data),
                                 path)
        else:  # legacy: one flat leaf list, opt_state's leaves first
            opt_order = _leaf_order(like["momentum"]) if want_momentum else []
            order = _leaf_order(like["params"])
            leaves = [np.asarray(data[f"leaf_{i}"])
                      for i in range(len(opt_order) + len(order))]
            momentum = (_fill(like["momentum"], leaves[:len(opt_order)], path)
                        if want_momentum else None)
            params = _fill(like["params"], leaves[len(opt_order):], path)
    restored = {"params": params, "momentum": momentum}
    for key in ("params", "momentum"):
        if restored[key] is None:
            continue
        for name, kind in _leaf_order(like[key]):
            want = np.shape(like[key][name][kind])
            got = np.shape(restored[key].get(name, {}).get(kind))
            if got != want:
                raise ValueError(f"checkpoint leaf {key}:{name}/{kind} shape "
                                 f"{got} != expected {want}")
    return restored
