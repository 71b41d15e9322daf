"""Deterministic model fixtures for tests and demos (port of
tpuserve/fixtures.py).

Reference counterpart: scripts/create-test-model.py — builds a seed-42
3→5(ReLU)→2 MLP in raw ONNX (MatMul/Add/Relu, :19-99), writes a matching
config.json (:103-127), and self-verifies with an ORT session (:129-141).

The same np.random.seed(42) draws as the JAX package's fixtures (W1(3,5),
b1(5), W2(5,2), b2(2)), so outputs match them: a safetensors checkpoint
for the zoo backend (written by the port's own writer) and a raw
model.onnx for the ONNX backend, each self-verified through the same math.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.checkpoint import read_safetensors, write_safetensors


def make_test_model_weights(seed: int = 42) -> Dict[str, np.ndarray]:
    """Same draw order as the reference generator (create-test-model.py:24-29)
    so outputs are bit-comparable with the reference's ONNX fixture."""
    rng = np.random.RandomState(seed)
    return {
        "dense1/kernel": rng.randn(3, 5).astype(np.float32),
        "dense1/bias": rng.randn(5).astype(np.float32),
        "dense2/kernel": rng.randn(5, 2).astype(np.float32),
        "dense2/bias": rng.randn(2).astype(np.float32),
    }


def reference_mlp_forward(weights: Dict[str, np.ndarray], x: np.ndarray) -> np.ndarray:
    """Ground-truth numpy forward for verification."""
    h = np.maximum(x @ weights["dense1/kernel"] + weights["dense1/bias"], 0.0)
    return h @ weights["dense2/kernel"] + weights["dense2/bias"]


def create_test_model(output_dir: str, name: str = "test_model", version: str = "1") -> str:
    """Write `<output_dir>/<name>/<version>/{model.safetensors, config.json}`.
    Returns the version directory. Self-verifies like the reference
    (create-test-model.py:129-141)."""
    vdir = os.path.join(output_dir, name, version)
    os.makedirs(vdir, exist_ok=True)

    write_safetensors(os.path.join(vdir, "model.safetensors"), make_test_model_weights())
    config = {
        "name": name,
        "version": version,
        "platform": "jax",
        "architecture": "mlp",
        "inputs": [{"name": "input", "shape": [1, 3], "data_type": "FLOAT32"}],
        "outputs": [{"name": "output", "shape": [1, 2], "data_type": "FLOAT32"}],
        "model_params": {"features": [5, 2], "activation": "relu"},
    }
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)

    # self-verify: reload and run the ground-truth forward
    reloaded = {k: v.numpy() for k, v in
                read_safetensors(os.path.join(vdir, "model.safetensors")).items()}
    y = reference_mlp_forward(reloaded, np.ones((1, 3), np.float32))
    if y.shape != (1, 2):
        raise RuntimeError(f"fixture self-verify failed: output shape {y.shape}")
    ModelConfig.from_file(os.path.join(vdir, "config.json"))  # parses cleanly
    return vdir


def create_onnx_test_model(output_dir: str, name: str = "test_model_onnx",
                           version: str = "1") -> str:
    """Write the SAME seed-42 MLP as a raw model.onnx (MatMul/Add/Relu graph
    like the reference generator, create-test-model.py:34-99) + config.json,
    for the port's ONNX importer. Returns the version dir."""
    from tpuserve_torch.onnx import Graph, Node, ValueInfo, build, load_model, save_model
    from tpuserve_torch.onnx.proto import DT_FLOAT

    vdir = os.path.join(output_dir, name, version)
    os.makedirs(vdir, exist_ok=True)
    w = make_test_model_weights()
    graph = Graph(
        name=name,
        nodes=[
            Node("MatMul", ["input", "weight1"], ["matmul1"], "matmul1"),
            Node("Add", ["matmul1", "bias1"], ["hidden"], "add1"),
            Node("Relu", ["hidden"], ["relu"], "relu"),
            Node("MatMul", ["relu", "weight2"], ["matmul2"], "matmul2"),
            Node("Add", ["matmul2", "bias2"], ["output"], "add2"),
        ],
        initializers={
            "weight1": w["dense1/kernel"], "bias1": w["dense1/bias"],
            "weight2": w["dense2/kernel"], "bias2": w["dense2/bias"],
        },
        inputs=[ValueInfo("input", DT_FLOAT, [1, 3])],
        outputs=[ValueInfo("output", DT_FLOAT, [1, 2])],
    )
    path = os.path.join(vdir, "model.onnx")
    save_model(path, graph)
    config = {
        "name": name,
        "version": version,
        "platform": "onnx",
        "inputs": [{"name": "input", "shape": [1, 3], "data_type": "FLOAT32"}],
        "outputs": [{"name": "output", "shape": [1, 2], "data_type": "FLOAT32"}],
    }
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    # self-verify: round-trip through our own parser against ground truth
    params, apply, _, _ = build(load_model(path))
    x = np.ones((1, 3), np.float32)
    y = apply({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
              {"input": torch.from_numpy(x)})["output"].numpy()
    if not np.allclose(y, reference_mlp_forward(w, x), atol=1e-5):
        raise RuntimeError("onnx fixture self-verify failed")
    return vdir


def create_image_model_repo_entry(
    output_dir: str, name: str = "densenet_tpu", version: str = "1", num_classes: int = 1000
) -> str:
    """A densenet_onnx-equivalent repository entry: config + labels, weights
    optional (the reference ships its densenet the same way — config +
    labels, blob missing)."""
    vdir = os.path.join(output_dir, name, version)
    os.makedirs(vdir, exist_ok=True)
    config = {
        "name": name,
        "version": version,
        "platform": "jax",
        "architecture": "densenet121",
        "inputs": [{"name": "data_0", "shape": [-1, 224, 224, 3], "data_type": "FLOAT32"}],
        "outputs": [
            {
                "name": "logits",
                "shape": [-1, num_classes],
                "data_type": "FLOAT32",
                "label_filename": "labels.txt",
            }
        ],
        "quantization": {"weights": "int8"},
    }
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    with open(os.path.join(vdir, "labels.txt"), "w") as f:
        for i in range(num_classes):
            f.write(f"class_{i}\n")
    return vdir


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="Generate test model fixtures")
    p.add_argument("--output-dir", default="models")
    args = p.parse_args()
    path = create_test_model(args.output_dir)
    print(f"created {path}")
