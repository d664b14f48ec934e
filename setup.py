"""Pip packaging for mxnet_tpu (reference: tools/pip_package/setup.py).

Build the native runtime first (`make -C cpp`) or install with
MXTPU_NO_NATIVE=1 for the pure-Python fallback paths.
"""
import os

from setuptools import find_packages, setup


def _read_version():
    init = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mxnet_tpu", "__init__.py")
    with open(init) as f:
        for line in f:
            if line.startswith("__version__"):
                return line.split("=")[1].strip().strip("\"'")
    return "0.0.0"


setup(
    name="mxnet-tpu",
    version=_read_version(),
    description="TPU-native deep learning framework with the MXNet API "
                "surface (JAX/XLA/Pallas compute, C++ host runtime)",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["../cpp/build/libmxtpu*.so"],
                  # the PyTorch port's CUDA kernels, compiled at first use
                  "mxnet_tpu_torch": ["ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"test": ["pytest"]},
)
