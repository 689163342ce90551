"""The plain-PyTorch reference of the served models: f32 with TF32 off, or
with every product's operands rounded to a narrower arithmetic (the
control). It imports nothing of ``mld_tpu_torch``, ``mld_tpu`` or JAX."""
