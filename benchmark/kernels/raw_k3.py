"""K3 in the raw-motion family (``families/mld_raw.py``): the same kernels
and the same count as ``k3.py``, under the name of the raw cell's own
metric (``raw_k3_roofline``), where K3 runs at Dh 128 over every frame of
the doubled batch and to the 2 memory tokens."""
from benchmark.kernels.k3 import PATTERNS, work  # noqa: F401
