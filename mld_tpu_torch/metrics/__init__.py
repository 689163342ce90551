"""The metric suite (``mld_tpu/metrics``): the text-to-motion metrics and
the action-to-motion classifiers' HUMANACTMetrics and UESTCMetrics."""
from .compute import ComputeMetrics
from .gru import HUMANACTMetrics
from .mm import MMMetrics
from .mr import MRMetrics
from .stgcn import UESTCMetrics
from .tm2t import TM2TMetrics
from .uncond import UncondMetrics

__all__ = ["ComputeMetrics", "HUMANACTMetrics", "MMMetrics", "MRMetrics",
           "TM2TMetrics", "UESTCMetrics", "UncondMetrics"]
