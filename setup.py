"""Build glue (parity: reference ``setup.py`` + ``CMakeLists.txt``, N31).

Installs the ``horovod_tpu`` package, compiles the native core
(``csrc/`` → ``horovod_tpu/native/libhvtcore.so``) through the existing
Makefile, and registers the ``hvdtpu-run`` launcher console script.
"""

import subprocess
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNativeCore(build_py):
    def run(self):
        root = Path(__file__).parent
        subprocess.check_call(["make", "-C", str(root / "csrc")])
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed deep-learning training framework with "
        "Horovod's capabilities (JAX/XLA/Pallas data plane, native C++ "
        "eager runtime)"
    ),
    packages=find_packages(include=[
        "horovod_tpu", "horovod_tpu.*",
        "horovod_tpu_torch", "horovod_tpu_torch.*",
    ]),
    package_data={
        "horovod_tpu.native": ["libhvtcore.so"],
        # The PyTorch/CUDA port builds its kernels from these at first use.
        "horovod_tpu_torch": ["csrc/*.cu"],
    },
    cmdclass={"build_py": BuildWithNativeCore},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pyyaml"],
    extras_require={
        "torch": ["torch"],
        "tensorflow": ["tensorflow"],
        "ray": ["ray"],
        "spark": ["pyspark"],
    },
    entry_points={
        "console_scripts": [
            "hvdtpu-run = horovod_tpu.runner.launch:main",
        ]
    },
)
