"""Model configuration — the single source of truth.

The reference parses per-model config.json in *four* different places with
diverging semantics (SURVEY.md §2c.5): Go handlers, the Go config loader,
and a C++ repository whose `GetModelConfig` fakes the parse entirely
(model_repository.cpp:131-156 hardcodes input/output names). Here one parser
owns the schema; every layer (repository, engine, server, native bridge)
consumes the same `ModelConfig`.

Schema (config.json, superset of the reference's — reference fields per
server/main.go:604-627 and models/*/1/config.json):

    {
      "name": "...", "version": "1",
      "platform": "jax" | "llm" | "pytorch" | "onnxruntime_onnx" | ...,
      "architecture": "mlp" | "resnet50" | "bert" | "llama" | ...,
      "max_batch_size": 0, "instance_count": 1, "dynamic_batching": false,
      "inputs":  [{"name", "data_type", "shape" | "dims", ...}],
      "outputs": [{..., "label_filename": "labels.txt"}],
      "quantization": {"weights": "int8"|"int4"|"none", "group_size": 128,
                        "kv_cache": "int8"|"none", "activations": "fp8"|"none"},
      "generation": {"max_seq_len": 2048, "max_slots": 8, "page_size": 128,
                      "eos_token_id": 2, "temperature": 0.0, "top_k": 0, "top_p": 1.0},
      "sharding":   {"tensor_parallel": 1, "data_parallel": 1},
      "model_params": { ... architecture hyperparameters ... }
    }
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import InvalidArgumentError


@dataclasses.dataclass
class TensorConfig:
    """One declared input/output (reference: InputConfig/OutputConfig,
    server/main.go:604-627). `shape` includes the batch dim, -1 = dynamic;
    `dims` (reference compat) excludes it."""

    name: str
    data_type: DataType
    shape: List[int]
    label_filename: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TensorConfig":
        if "name" not in d:
            raise InvalidArgumentError("tensor config missing 'name'")
        shape = d.get("shape")
        if shape is None and "dims" in d:
            # reference densenet config: dims excludes batch; assume batch 1
            shape = [1] + [int(x) for x in d["dims"]]
        if shape is None:
            raise InvalidArgumentError(f"tensor config '{d['name']}' missing 'shape'")
        return cls(
            name=str(d["name"]),
            data_type=DataType.from_string(str(d.get("data_type", "FP32"))),
            shape=[int(x) for x in shape],
            label_filename=d.get("label_filename"),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "data_type": self.data_type.value,
            "shape": list(self.shape),
        }
        if self.label_filename:
            out["label_filename"] = self.label_filename
        return out


@dataclasses.dataclass
class QuantizationConfig:
    """North-star quantization knobs (BASELINE.md): weight-only INT8/INT4,
    optional FP8 activations, INT8 KV cache."""

    weights: str = "none"  # none | int8 | int4
    group_size: int = 128  # contraction-dim group for scales; 0 = per-channel
    kv_cache: str = "none"  # none | int8 | int4 (packed, flat single-chip)
    activations: str = "none"  # none | int8 (dynamic per-token) | fp8
    # dtype of the INT8 KV cache's per-(pos, head) dequant scales:
    # "bfloat16" (default) halves the scale-stream bytes the decode kernel
    # reads (~1.5-2% of step bytes at 7B) for <=2^-9 relative rounding on
    # the dequantized K/V — measured at +3.5e-7 nat KL over f32 scales on
    # the real serving path (ACCURACY.json kv_cache_int8_scales), i.e.
    # accuracy-free next to int8's own quantization error.
    kv_scale_dtype: str = "bfloat16"  # bfloat16 | float32
    # weight quantizer: "rtn" (round-to-nearest + MSE clip search at int4)
    # or "gptq" (Hessian-calibrated error compensation, quant/gptq.py —
    # llama-family LLMs only). "calibration" names an .npy int32 [B, L]
    # token file for gptq; "synthetic" draws random tokens (fixture use).
    method: str = "rtn"  # rtn | gptq
    calibration: str = "synthetic"
    # Low-rank error correction (LoRC): store a rank-r bf16 factorization
    # of each gptq-quantized kernel's residual and add (x@A)@B at serving
    # time — 2r(K+N) extra bytes/FLOPs per kernel (a few % at r<=32) for
    # accuracy the int4 grid alone cannot reach. gptq-only; 0 = off.
    lowrank_correction: int = 0

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "QuantizationConfig":
        d = d or {}
        cfg = cls(
            weights=str(d.get("weights", "none")).lower(),
            group_size=int(d.get("group_size", 128)),
            kv_cache=str(d.get("kv_cache", "none")).lower(),
            activations=str(d.get("activations", "none")).lower(),
            kv_scale_dtype=str(d.get("kv_scale_dtype", "bfloat16")).lower(),
            method=str(d.get("method", "rtn")).lower(),
            calibration=str(d.get("calibration", "synthetic")),
            lowrank_correction=int(d.get("lowrank_correction", 0)),
        )
        if cfg.method not in ("rtn", "gptq"):
            raise InvalidArgumentError(f"unsupported quantization method '{cfg.method}'")
        if cfg.method == "gptq" and cfg.activations != "none":
            raise InvalidArgumentError(
                "quantization.method 'gptq' composes with bf16 activations only")
        if cfg.lowrank_correction and cfg.method != "gptq":
            raise InvalidArgumentError(
                "quantization.lowrank_correction requires method 'gptq'")
        if cfg.weights not in ("none", "int8", "int4"):
            raise InvalidArgumentError(f"unsupported weight quantization '{cfg.weights}'")
        if cfg.kv_cache not in ("none", "int8", "int4"):
            raise InvalidArgumentError(f"unsupported kv_cache quantization '{cfg.kv_cache}'")
        if cfg.activations not in ("none", "int8", "fp8"):
            raise InvalidArgumentError(f"unsupported activation quantization '{cfg.activations}'")
        if cfg.kv_scale_dtype not in ("float32", "bfloat16"):
            raise InvalidArgumentError(
                f"unsupported kv_scale_dtype '{cfg.kv_scale_dtype}'")
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GenerationConfig:
    """LLM serving parameters (no reference counterpart; the reference has no
    attention/KV machinery — SURVEY.md §5 'Long-context')."""

    max_seq_len: int = 2048
    max_slots: int = 8  # concurrent sequences in the continuous batch
    paged: bool = False  # paged KV cache (pages allocated on demand)
    page_size: int = 128  # tokens per KV page
    num_pages: int = 0  # page-pool size; 0 = capacity parity with contiguous
    # KV read-window bucketing: short-context batches read only the live
    # bucket (saves HBM traffic) at the cost of one decode compile per
    # bucket. 0 = off (single full-window compile, no mid-serving stalls).
    decode_buckets: int = 0
    # Chunked prefill: prompts longer than this admit in chunks of this
    # many tokens, one chunk between decode steps, so a long admission
    # cannot freeze the decode batch. 0 = off (whole-bucket prefill).
    prefill_chunk: int = 0
    # Prefix sharing (paged mode only): admissions reuse the KV pages of
    # previously seen prompt prefixes at full-page granularity — exact
    # token match via a hash chain, refcounted pages, LRU eviction of
    # unreferenced blocks under pool pressure. Matched tokens skip prefill
    # compute AND page allocation (vLLM-style automatic prefix caching).
    prefix_sharing: bool = False
    # Fused decode horizon: when no admissions are pending, run up to this
    # many decode+sample steps inside ONE device dispatch (lax.scan) —
    # host round-trips cost ~4 ms each on remote-device setups, a large
    # fraction of a ~30 ms step. Tokens then stream in bursts of up to
    # this size; 1 = one step per dispatch (lowest latency).
    # fused decode steps per dispatch (power-of-2 bucketed in the engine).
    # Default 8 (r5, was 4): every dispatch on the serving relay pays a
    # fixed ~25 ms round trip, so per-token cost at horizon h is
    # ~(RT + h*step)/h — 8 cuts the dispatch tax to ~12% of a step while
    # the adaptive target_burst_ms knob still bounds burst latency.
    decode_horizon: int = 8
    # Adaptive horizon: when > 0, bound each fused burst's wall time to this
    # many milliseconds — the engine tracks an EMA of measured per-token
    # decode time and picks horizon = min(decode_horizon, target_burst_ms /
    # ema). Fast small-batch decode keeps big bursts (dispatch amortization);
    # slow large-batch/long-context decode drops toward per-step streaming
    # so token cadence and admission latency stay under the SLO. 0 = fixed.
    target_burst_ms: float = 0.0
    # Speculative decoding (prompt-lookup): draft up to this many tokens per
    # step by matching the sequence's trailing n-gram against its own
    # history, verify all drafts in ONE batched step, and accept the prefix
    # that matches the model's own argmax — greedy outputs are EXACT, and
    # accepted tokens amortize the weight stream that dominates decode.
    # 0 = off. Active only for greedy (temperature 0, repetition_penalty 1)
    # slots; works in contiguous AND paged modes (not pipeline-parallel).
    speculation_tokens: int = 0
    speculation_ngram: int = 3
    # Fused speculation rounds: run this many draft+verify rounds inside
    # ONE device dispatch (lax.scan), with the prompt-lookup drafting done
    # ON DEVICE (llama.draft_lookup) from an uploaded history buffer —
    # the speculation analogue of decode_horizon. 1 = one verify per
    # dispatch (round-3 behavior). Contiguous single-island mode only;
    # paged / multi-chip meshes use single-round verification.
    speculation_rounds: int = 4
    # Break-even guard: a fused-speculation dispatch only fires when the
    # EXPECTED extra tokens per slot per round (per-slot acceptance EMA x
    # draft availability, averaged over active slots) clears this bar;
    # below it the engine falls back to the plain fused decode horizon,
    # whose per-round cost is ~1.3x cheaper than a C-wide verify. Keeps
    # speculation from regressing on low-acceptance (random) traffic.
    speculation_min_gain: float = 0.4
    eos_token_id: int = 2
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 256

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "GenerationConfig":
        d = d or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ShardingConfig:
    """Mesh axes sizes for multi-chip serving. 1/1 = single chip."""

    tensor_parallel: int = 1
    data_parallel: int = 1
    # long-context: shard the KV cache's sequence (L) dim over an "sp" mesh
    # axis; decode attention merges per-shard partial softmax stats
    # (flash-decoding style) over ICI — see parallel/sharding.py
    sequence_parallel: int = 1
    # capacity: stage n_layers/pp contiguous layers per device ("pp" axis)
    # with microbatch-rotation decode — see parallel/pipeline.py. v1 is
    # exclusive with the other axes / paged / chunked prefill / MoE.
    pipeline_parallel: int = 1

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ShardingConfig":
        d = d or {}
        return cls(
            tensor_parallel=int(d.get("tensor_parallel", 1)),
            data_parallel=int(d.get("data_parallel", 1)),
            sequence_parallel=int(d.get("sequence_parallel", 1)),
            pipeline_parallel=int(d.get("pipeline_parallel", 1)),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ModelConfig:
    name: str
    version: str = "1"
    platform: str = ""  # resolved from marker file when empty
    architecture: str = ""
    max_batch_size: int = 0
    instance_count: int = 1
    dynamic_batching: bool = False
    inputs: List[TensorConfig] = dataclasses.field(default_factory=list)
    outputs: List[TensorConfig] = dataclasses.field(default_factory=list)
    quantization: QuantizationConfig = dataclasses.field(default_factory=QuantizationConfig)
    generation: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    model_params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        if "name" not in d:
            raise InvalidArgumentError("model config missing 'name'")
        return cls(
            name=str(d["name"]),
            version=str(d.get("version", "1")),
            platform=str(d.get("platform", "")),
            architecture=str(d.get("architecture", "")),
            max_batch_size=int(d.get("max_batch_size", 0)),
            instance_count=int(d.get("instance_count", 1)),
            dynamic_batching=bool(d.get("dynamic_batching", False)),
            inputs=[TensorConfig.from_dict(x) for x in d.get("inputs", [])],
            outputs=[TensorConfig.from_dict(x) for x in d.get("outputs", [])],
            quantization=QuantizationConfig.from_dict(d.get("quantization")),
            generation=GenerationConfig.from_dict(d.get("generation")),
            sharding=ShardingConfig.from_dict(d.get("sharding")),
            model_params=dict(d.get("model_params", {})),
        )

    @classmethod
    def from_file(cls, path: str) -> "ModelConfig":
        try:
            with open(path, "r") as f:
                data = json.load(f)
        except FileNotFoundError:
            raise InvalidArgumentError(f"config file not found: {path}")
        except json.JSONDecodeError as e:
            raise InvalidArgumentError(f"invalid JSON in {path}: {e}")
        return cls.from_dict(data)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "platform": self.platform,
            "architecture": self.architecture,
            "max_batch_size": self.max_batch_size,
            "instance_count": self.instance_count,
            "dynamic_batching": self.dynamic_batching,
            "inputs": [t.to_dict() for t in self.inputs],
            "outputs": [t.to_dict() for t in self.outputs],
            "quantization": self.quantization.to_dict(),
            "generation": self.generation.to_dict(),
            "sharding": self.sharding.to_dict(),
            "model_params": self.model_params,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    # ------------------------------------------------------------------
    def input_config(self, name: str) -> Optional[TensorConfig]:
        for t in self.inputs:
            if t.name == name:
                return t
        return None

    def output_config(self, name: str) -> Optional[TensorConfig]:
        for t in self.outputs:
            if t.name == name:
                return t
        return None

    def resolve_label_file(self, model_dir: str, output_name: str) -> Optional[str]:
        """Resolve a classification label file relative to the *model version
        directory* — fixing the reference bug where labels resolve against the
        repository root and silently fail to load (SURVEY.md §2c.7,
        server/main.go:719)."""
        out = self.output_config(output_name)
        if out is None or not out.label_filename:
            return None
        candidate = os.path.join(model_dir, out.label_filename)
        if os.path.exists(candidate):
            return candidate
        # tolerate the reference's broken densenet config: try any *label*.txt
        try:
            for fn in sorted(os.listdir(model_dir)):
                if "label" in fn.lower() and fn.endswith(".txt"):
                    return os.path.join(model_dir, fn)
        except OSError:
            pass
        return None
