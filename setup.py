from setuptools import find_packages, setup

setup(
    name="mccnn-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) stereo-matching framework with the "
        "capabilities of MC-CNN-python"
    ),
    packages=find_packages(include=["mccnn_tpu", "mccnn_tpu.*",
                                    "mccnn_tpu_torch", "mccnn_tpu_torch.*"]),
    # the PyTorch port's CUDA sources, compiled at first use on the card
    package_data={"mccnn_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    entry_points={
        "console_scripts": [
            "mccnn-train=mccnn_tpu.cli.train:main",
            "mccnn-match=mccnn_tpu.cli.match:main",
            "mccnn-match-torch=mccnn_tpu_torch.cli.match:main",
            "mccnn-eval-torch=mccnn_tpu_torch.cli.eval:main",
            "mccnn-train-torch=mccnn_tpu_torch.cli.train:main",
        ]
    },
)
