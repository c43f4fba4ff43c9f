from setuptools import find_packages, setup

setup(
    name="magma_tpu",
    version="0.1.0",
    description=(
        "TPU-native JAX/XLA/Pallas multimodal vision-language framework "
        "with the capabilities of Aleph-Alpha/magma"
    ),
    packages=find_packages(include=["magma_tpu", "magma_tpu.*",
                                    "magma_tpu_torch", "magma_tpu_torch.*"]),
    package_data={"magma_tpu.native": ["loader.cc"],
                  "magma_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "magma_tpu_torch.native": ["loader.cc"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "numpy",
        "pyyaml",
        "optax",
        "orbax-checkpoint",
        "Pillow",
    ],
    extras_require={
        "train": ["wandb"],
        "convert": ["torch"],
        "dev": ["pytest"],
    },
)
