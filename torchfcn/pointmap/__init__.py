"""The C++ point-map fusion node of the stream graph (sources here, built
with ``g++`` at first use)."""

from torchfcn.pointmap.node import PointMapLib, PointMapNode, build_library

__all__ = ["PointMapLib", "PointMapNode", "build_library"]
