"""Weight-format converter CLI (mccnn_tpu/cli/convert.py).

Brings weights from the reference's npy dict (``conv{i}/weights:0``) into
the flat npz that the port and the JAX package load, and back out to the
npy dict for reference interop; npz to npz rewrites any of the npz layouts
(training checkpoints, legacy snapshots) as the flat one. NumPy only: it
touches no device. A TF1 checkpoint prefix needs tensorflow: the port's
loader refuses it and names the JAX package's converter.

    python -m mccnn_tpu_torch.cli.convert SOURCE DEST
"""

from __future__ import annotations

import argparse

from mccnn_tpu_torch.models.params import (
    load_any,
    save_params,
    save_reference_npy_dict,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="convert MC-CNN weights between formats"
    )
    parser.add_argument("source", help="input: .npz or .npy dict (a TF "
                        "ckpt prefix needs mccnn_tpu.cli.convert)")
    parser.add_argument("dest", help="output: .npz or .npy")
    args = parser.parse_args(argv)

    params = load_any(args.source)
    if args.dest.endswith(".npy"):
        save_reference_npy_dict(params, args.dest)
    elif args.dest.endswith(".npz"):
        save_params(params, args.dest)
    else:
        raise SystemExit("destination must end in .npz or .npy")
    layers = ", ".join(
        f"{name}:{tuple(layer['w'].shape)}"
        for name, layer in sorted(params.items())
    )
    print(f"converted {args.source} -> {args.dest} ({layers})")


if __name__ == "__main__":
    main()
