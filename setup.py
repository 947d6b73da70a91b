"""Packaging (reference /root/reference/setup.py — no CUDA extensions to
build here: the device kernels are Pallas, compiled by XLA at runtime; the
native C++ components build via csrc/Makefile into a plain shared library
loaded with ctypes)."""

from setuptools import find_packages, setup

setup(
    name="unicore-tpu",
    version="0.0.1",
    description="TPU-native distributed training framework (Uni-Core capability parity)",
    packages=find_packages(
        exclude=["tests", "tests.*", "examples", "examples.*", "csrc", "csrc.*"]
    ),
    install_requires=[
        "numpy",
        "jax",
        "flax",
        "tqdm",
        "tokenizers",
    ],
    extras_require={
        "lmdb": ["lmdb"],
        "logging": ["tensorboardX", "wandb"],
    },
    entry_points={
        "console_scripts": [
            "unicore-tpu-train = unicore_tpu_cli.train:cli_main",
            "unicore-tpu-serve = unicore_tpu_cli.serve:cli_main",
            "unicore-tpu-router = unicore_tpu_cli.router:cli_main",
            "unicore-tpu-lint = unicore_tpu_cli.lint:main",
            "unicore-tpu-trace = unicore_tpu_cli.trace:main",
            "unicore-tpu-torch-serve = unicore_tpu_torch.cli.serve:cli_main",
            "unicore-tpu-torch-router = unicore_tpu_torch.cli.router:cli_main",
            "unicore-tpu-torch-train = unicore_tpu_torch.cli.train:cli_main",
            "unicore-tpu-torch-trace = unicore_tpu_torch.cli.trace:main",
        ],
    },
    python_requires=">=3.9",
    zip_safe=False,
)
