"""ONNX import without onnxruntime (port of tpuserve/onnx): the wire-format
parser and writer (proto.py) and the graph -> PyTorch importer
(importer.py). Serves the reference's own model.onnx fixtures on the card
(≙ reference model.cpp ONNX Runtime backend)."""

from tpuserve_torch.onnx.importer import build
from tpuserve_torch.onnx.proto import Graph, Node, ValueInfo, load_model, save_model

__all__ = ["Graph", "Node", "ValueInfo", "load_model", "save_model", "build"]
