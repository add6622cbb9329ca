from setuptools import find_packages, setup

setup(
    name="meshanything_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) framework for point-cloud-conditioned "
        "autoregressive artist-mesh generation"
    ),
    packages=find_packages(include=["meshanything_tpu", "meshanything_tpu.*",
                                    "meshanything_tpu_torch", "meshanything_tpu_torch.*"]),
    package_data={"meshanything_tpu.native": ["*.cpp", "*.sh", "*.so"],
                  "meshanything_tpu": ["data/*.json"],
                  # sources of the PyTorch port, compiled at first use: the CUDA kernels
                  # and the headers they include (nvcc), the native geometry (g++)
                  "meshanything_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp", "data/*.json"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "orbax-checkpoint",
        "safetensors",
        "scipy",
    ],
    extras_require={
        "serving": ["gradio"],
        "convert": ["torch"],
    },
)
