"""mld_tpu_torch — the PyTorch/CUDA port of mld_tpu for NVIDIA Hopper.

Text-to-motion generation (``models.mld.MLD``) and its training
(``train/``, ``python -m mld_tpu_torch.train``) in PyTorch, with the TPU
package's Pallas kernels as hand-written CUDA kernels (``csrc/``). The JAX
package ``mld_tpu`` is the reference it is tested against; this package
imports ``torch`` and never ``jax``, and sets nothing globally at import.
"""

__version__ = "0.1.0"
