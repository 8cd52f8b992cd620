"""ALADIN in PyTorch for an NVIDIA H100: the port of ``aladin_tpu``.

The package mirrors ``aladin_tpu`` module by module and imports nothing from
it (nor JAX): host-side modules it needs are kept as copies. Plain tensor
code is PyTorch; each TPU kernel on a ported path is a CUDA kernel written
for Hopper under ``aladin_torch/csrc/``, built with ``nvcc`` at first use.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from aladin_torch.config import ExperimentConfig, load_config  # noqa: F401
