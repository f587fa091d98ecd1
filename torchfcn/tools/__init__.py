"""The label tools of the port (``tpufcn/tools``): dataset capture, boundary
refinement, proposal ranking and ROI classification over CNN codes that
VGG16 computes on the card (``features.py``); template matching
(``ncc.py``) and clustering (``cluster.py``) run on the host in numpy."""

from torchfcn.tools.capture import ImageRectWriter
from torchfcn.tools.features import CnnCodeExtractor
from torchfcn.tools.roi_classifier import (
    ROIClassifier, ROIClassifierNode)
from torchfcn.tools.boundary_refinement import (
    BoundaryRefiner, BoundaryRefinerNode)
from torchfcn.tools.rank_proposals import RankObjectProposals

__all__ = [
    "ImageRectWriter", "CnnCodeExtractor", "ROIClassifier",
    "ROIClassifierNode",
    "BoundaryRefiner", "BoundaryRefinerNode", "RankObjectProposals",
]
