"""mld_tpu_torch — the PyTorch/CUDA port of mld_tpu for NVIDIA Hopper.

Text-to-motion generation (``models.mld.MLD``) in PyTorch, with the latent
denoiser's encoder stack as a hand-written CUDA kernel (``csrc/``). The JAX
package ``mld_tpu`` is the reference it is tested against; this package
imports ``torch`` and never ``jax``, and sets nothing globally at import.
"""

__version__ = "0.1.0"
