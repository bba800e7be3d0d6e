"""Packaging for skypilot_tpu (reference analog: sky/setup_files/setup.py).

The `stpu` console script is the CLI entrypoint (reference installs `sky`,
setup.py:172). The optional C extension (gang-exec supervisor) is built by
skypilot_tpu/agent/native/Makefile and loaded via ctypes with a pure-Python
fallback, so this setup stays pure-Python.
"""
import os

from setuptools import find_packages, setup

setup(
    name='skypilot-tpu',
    version='0.1.0',
    packages=find_packages(exclude=['tests*', 'examples*']),
    include_package_data=True,
    package_data={
        'skypilot_tpu': [
            'catalog/data/**/*.csv',
            'templates/*.j2',
            'agent/native/*.cc',
            'agent/native/Makefile',
        ],
        # CUDA sources of the PyTorch port, compiled with nvcc at first use.
        'skypilot_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh'],
    },
    python_requires='>=3.10',
    install_requires=[
        'pyyaml', 'jinja2', 'networkx', 'pandas', 'filelock', 'click',
        'requests', 'aiohttp', 'psutil', 'rich',
        'cryptography',  # SSH keypair generation (authentication.py)
        'prometheus_client',  # /metrics histograms (server/metrics.py)
    ],
    extras_require={
        'tpu': ['jax', 'flax', 'optax', 'orbax-checkpoint', 'einops'],
    },
    entry_points={
        'console_scripts': [
            'stpu = skypilot_tpu.client.cli:cli',
        ],
    },
)
