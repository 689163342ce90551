"""The text-to-motion metric suite (``mld_tpu/metrics`` without the
action-to-motion classifiers' HUMANACTMetrics and UESTCMetrics, which wait
with action-to-motion)."""
from .compute import ComputeMetrics
from .mm import MMMetrics
from .mr import MRMetrics
from .tm2t import TM2TMetrics
from .uncond import UncondMetrics

__all__ = ["ComputeMetrics", "MMMetrics", "MRMetrics", "TM2TMetrics",
           "UncondMetrics"]
