"""PyTorch + CUDA port of srl_tpu.

The package mirrors the layout of ``srl_tpu`` (core, ops, envs, models,
agents, utils, experiments) and imports nothing from it: ``srl_tpu`` stays
the reference that every module here is tested against. Plain tensor code is
PyTorch; the TPU's Pallas kernels become hand-written CUDA kernels under
``csrc/``, each with a plain PyTorch twin beside its wrapper.
"""

__version__ = "0.1.0"
