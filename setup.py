"""Packaging for transfer_em_tpu (reference setup.py ships transfer_em +
predict_service.py as a script)."""

from setuptools import find_packages, setup

setup(
    name="transfer_em_tpu",
    version="0.1.0",
    description=("TPU-native (JAX/XLA/Pallas) unpaired EM-to-EM style "
                 "transfer: CycleGAN training, tiled VALID-conv inference, "
                 "streaming EM data pipelines, serving shims"),
    packages=find_packages(exclude=("tests",)),
    package_data={"transfer_em_tpu.native": ["*.cpp"],
                  "transfer_em_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "transfer_em_tpu_torch.native": ["*.cpp"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
    extras_require={
        "data": ["requests", "tensorstore", "pillow"],
        "cloud": ["google-cloud-storage", "google-api-python-client"],
        "torch": ["torch", "numpy"],
    },
    entry_points={
        "console_scripts": [
            "tem-save-model=transfer_em_tpu.cli.save_model:main",
            "tem-data-service=transfer_em_tpu.serve.data_service:main",
            "tem-model-service=transfer_em_tpu.serve.model_service:main",
            "tem-torch-save-model=transfer_em_tpu_torch.cli.save_model:main",
            "tem-torch-data-service="
            "transfer_em_tpu_torch.serve.data_service:main",
            "tem-torch-model-service="
            "transfer_em_tpu_torch.serve.model_service:main",
        ],
    },
)
