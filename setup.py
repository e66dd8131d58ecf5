"""Build for detectorch_tpu, including the native RLE extension.

  python setup.py build_ext --inplace
"""

import numpy as np
from setuptools import Extension, find_packages, setup

setup(
    name="detectorch_tpu",
    version="0.1.0",
    description="TPU-native Detectron (Fast/Faster/Mask R-CNN) in JAX/XLA/Pallas",
    packages=find_packages(include=["detectorch_tpu", "detectorch_tpu.*",
                                    "detectorch_tpu_torch", "detectorch_tpu_torch.*"]),
    # the port's CUDA sources, compiled by nvcc at first use
    package_data={"detectorch_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "detectorch_tpu_rle_native",
            sources=["native/rle_ext.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
    python_requires=">=3.10",
)
