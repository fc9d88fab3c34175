from setuptools import find_packages, setup

setup(
    name='hrfuser-tpu',
    version='0.1.0',
    description='TPU-native multi-modal sensor-fusion 2D detection '
                '(JAX/XLA/Pallas rebuild of the HRFuser capability surface)',
    packages=find_packages(include=['hrfuser_tpu', 'hrfuser_tpu.*',
                                    'hrfuser_tpu_torch',
                                    'hrfuser_tpu_torch.*']),
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy',
        'opencv-python-headless',
    ],
)
