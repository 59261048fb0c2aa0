"""pip packaging for the TPU-native analytics+AI framework.

ref ``pyzoo/setup.py`` (the reference ships `analytics-zoo` wheels with the
JVM jars vendored in); here the native pieces are two small C++ sources
compiled on first use with the system toolchain, so the sdist/wheel carries
the .cpp files, not binaries.
"""

import os

from setuptools import find_packages, setup

HERE = os.path.abspath(os.path.dirname(__file__))
VERSION = "0.1.0"


def readme() -> str:
    with open(os.path.join(HERE, "README.md"), encoding="utf-8") as f:
        return f.read()


setup(
    name="analytics-zoo-tpu",
    version=VERSION,
    description=("TPU-native unified analytics + AI platform: sharded data "
                 "pipelines, SPMD training over device meshes, streaming "
                 "inference serving"),
    long_description=readme(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["analytics_zoo_tpu",
                                    "analytics_zoo_tpu.*",
                                    "analytics_zoo_tpu_torch",
                                    "analytics_zoo_tpu_torch.*"]),
    package_data={"analytics_zoo_tpu.native": ["*.cpp"],
                  # the PyTorch / CUDA port builds its kernels from source
                  # with nvcc at first use
                  "analytics_zoo_tpu_torch.ops": ["csrc/*.cu",
                                                 "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "optax",
        "numpy",
        "einops",
    ],
    extras_require={
        "interop": ["tensorflow", "torch", "transformers"],
        # analytics_zoo_tpu_torch: the PyTorch / CUDA port (needs nvcc)
        "torch": ["torch"],
        "data": ["pandas", "pyarrow"],
        "serving": ["redis"],
        "test": ["pytest", "chex"],
    },
    scripts=[
        "scripts/zoo-cluster-serving-start",
        "scripts/zoo-cluster-serving-stop",
        "scripts/zoo-multihost-launch",
        "scripts/jupyter-with-zoo",
    ],
    classifiers=[
        "Programming Language :: Python :: 3",
        "License :: OSI Approved :: Apache Software License",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
    ],
)
