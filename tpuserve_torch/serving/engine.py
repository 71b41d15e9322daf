"""GenerationEngine — continuous batching over a slotted KV cache (PyTorch
port of tpuserve/serving/engine.py, the single-device contiguous and paged
paths).

- S decode *slots* (config.generation.max_slots). A scheduler thread owns
  the device loop: admit pending requests into free slots (prefill, or
  chunked prefill for long prompts), then run batched decode steps for all
  active slots, sample, emit, retire finished slots.
- Prefill pads prompts to power-of-two buckets; decode runs all S slots.
- A fused decode horizon runs up to `decode_horizon` (power-of-2 bucketed)
  decode+sample steps back to back on the device and fetches their tokens
  with ONE device-to-host copy (the JAX package fuses them with lax.scan;
  CUDA graphs are later work).
- Per-slot sampling params, one torch.Generator, a per-slot presence mask
  for the repetition penalty; EOS / stop ids / max_new_tokens tracked
  host-side.
- Weights load from model.safetensors (flat llama.py names) and are
  quantized on load per config.quantization (a MoE model's stacked experts
  too; its router stays bf16): round-to-nearest, or with `method: gptq`
  calibrated GPTQ on the engine's device (quant/gptq.py), with LoRC
  factors at `lowrank_correction` > 0; `model_params.init` "random" or
  "random_quantized" makes them from a seed instead.
- Paged mode (generation.paged): a page pool (serving/paged_kv.py) with a
  page table per slot, pages allocated as slots grow and released when
  they retire; prefix sharing (generation.prefix_sharing) reuses the pages
  of matched full-page prompt prefixes and prefills only the suffix.
  Chunked prefill rides the suffix path, so prefill_chunk must be a
  multiple of page_size.
- Speculative decoding (generation.speculation_tokens = k > 0): prompt-
  lookup drafts of up to k tokens, verified C = k+1 at a time with exact
  acceptance (greedy: the model's argmax; sampled: point-mass rejection
  sampling, sampling.spec_accept). Contiguous mode runs
  speculation_rounds draft+verify rounds back to back on the device,
  drafting there (llama.draft_lookup), and fetches their tokens with ONE
  device-to-host copy; paged mode drafts on the host, so that page chains
  cover the drafts, and verifies once per iteration. Slots with a
  repetition penalty do not speculate, nor does a step while requests
  wait for admission.

- Sharded serving (sharding.tensor_parallel / data_parallel /
  sequence_parallel / pipeline_parallel; one model at a time). Every rank
  is a process holding its block of the weights and of the KV cache
  (parallel/sharding.py; under pipeline_parallel its stage block and 5D
  stage cache or page pool, parallel/pipeline.py); rank 0, the controller,
  runs the scheduler and publishes every step's host inputs on the event
  bus (parallel/dispatcher.py), page-table rows included (the followers
  keep no allocator), and the follower ranks replay each step
  (`run_follower`). Ranks joined by TPUSERVE_COORDINATOR /
  TPUSERVE_NUM_PROCESSES / TPUSERVE_PROCESS_ID (the CLI's multi-process
  form, the JAX package's multi-host) serve the model whose mesh matches
  their number, under the JAX multi-host v1 rules (contiguous KV, no
  pipeline); with no process group, `start()` starts world - 1 follower
  ranks on this host itself and `stop()` stops them (the JAX package's
  single-host mesh: pipeline_parallel and paged KV too). Under
  sequence_parallel the cache is the 5D layout, its L split over sp. Where
  tensor_parallel does not divide n_kv_heads (MQA, narrow GQA) every rank
  keeps every kv head on the 5D cache or pool and attends by einsum, as
  the JAX engine's GSPMD path (parallel/sharding.py::kv_replicated). Under
  pipeline_parallel speculation is off, as in the JAX engine (its pipeline
  has no verify). Under a tp/dp/sp mesh speculation runs the JAX engine's
  single-round host-drafted verify, contiguous or paged, whatever
  speculation_rounds: the controller drafts, publishes a ("verify", ...)
  event and accepts; every rank runs the verify on its blocks
  (llama.verify_step / verify_step_paged under the mesh); a verify that
  fails on any rank fails on every rank and latches speculation off. The
  CLI's multi-process form refuses speculation, as the JAX multi-host v1
  does.

Runs on `device` ("cuda" by default); it never falls back to the CPU: with
no card it raises unless the caller passed device="cpu". The JAX
engine's own refusals raise BackendError with its words, as does a one-rank
contiguous speculation width the verify kernel does not take.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuserve_torch.models import llama
from tpuserve_torch.models.llama import KVCache, LlamaParams
from tpuserve_torch.parallel import pipeline
from tpuserve_torch.ops.decode_attention import KERNEL_HEAD_DIMS, check_multi_kernel
from tpuserve_torch.models.llama_bench import init_quantized_params, param_bytes
from tpuserve_torch.quant.core import quantize_param_tree
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.paged_kv import PagedKVCache, PageTableManager
from tpuserve_torch.serving.sampling import SamplingParams, sample_with_logprobs, spec_accept
from tpuserve_torch.utils.checkpoint import read_safetensors
from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import BackendError, InvalidArgumentError
from tpuserve_torch.utils.tensor import Tensor

log = logging.getLogger("tpuserve_torch.engine")

_QUANT_BITS = {"int8": 8, "int4": 4}

# the one live sharded engine of this process (one model at a time under a
# mesh: the event bus is a single ordered stream, and the active mesh is the
# process's)
_MH_LIVE_ENGINE = None


@dataclasses.dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0  # CTRL-style, over prompt + generated
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    want_logprobs: bool = False
    id: int = 0
    logprobs: List[float] = dataclasses.field(default_factory=list)
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    error: Optional[str] = None
    token_queue: "queue.Queue[Optional[int]]" = dataclasses.field(default_factory=queue.Queue)
    finish_reason: str = ""
    aborted: bool = False  # set by the transport when the client goes away


@dataclasses.dataclass
class _SlotState:
    request: Request
    next_pos: int  # cache position the *next* fed token occupies
    generated: int
    last_token: int
    # --- speculation bookkeeping (see _sync_slot_history) ---
    # tokens of (prompt + outputs) already copied into the engine's history
    # buffer row
    hist_synced: int = 0
    # EMA of accepted draft tokens per verify round (a count) for the
    # break-even guard; starts optimistic so that new slots get probed
    acc_ema: float = 8.0


class GenerationEngine:
    def __init__(self, model_dir: str, config: ModelConfig, device="cuda"):
        self.config = config
        self.model_dir = model_dir
        self.gptq_timings: List[Dict] = []  # per layer: GPTQ load seconds
        self.device = resolve_device(device)
        self.p = LlamaParams.from_dict(config.model_params)
        gen = config.generation
        self.max_seq_len = int(gen.max_seq_len)
        self.n_slots = int(gen.max_slots)
        self.eos_token_id = int(gen.eos_token_id)
        self.default_max_new = int(gen.max_new_tokens)

        self.params = None
        self.cache = None  # KVCache, or PagedKVCache in paged mode
        self.ptm: Optional[PageTableManager] = None  # paged mode only
        self._param_bytes = 0
        self._pending: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._slots: List[Optional[_SlotState]] = [None] * self.n_slots
        # chunked-prefill admission in flight: {"req", "slot", "progress"}
        self._chunk_size = int(getattr(gen, "prefill_chunk", 0))
        self._chunking: Optional[Dict] = None
        self._tok_ms_ema: Optional[float] = None  # adaptive-horizon EMA
        self._horizon_last = 1
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._req_ids = itertools.count(1)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(config.model_params.get("seed", 0)))
        self._sampling = SamplingParams.create(self.n_slots, device=self.device)
        self._presence: Optional[torch.Tensor] = None  # [S, V] bool, made at start()
        self.steps = 0          # decode steps (a verify round counts one)
        self.prefill_calls = 0  # whole-prompt prefills and prefill chunks
        self.tokens_out = 0
        self.tokens_in = 0
        self.verify_calls = 0   # verify_step / verify_step_paged calls
        self._hist_np: Optional[np.ndarray] = None  # [S, max_seq_len] token history
        self._spec_disabled = False  # latched when a verify dispatch raises
        self._spec_probe = 0         # break-even-guard probe counter
        self.spec_drafted = 0        # drafted tokens proposed
        self.spec_accepted = 0       # drafted tokens accepted (and emitted)
        # under a mesh: each verify's positions and lengths [S], as published
        self.verify_log: "collections.deque" = collections.deque(maxlen=4096)
        # sharded serving: this rank's mesh, whether this process is the
        # controller (rank 0), the follower ranks this engine started (one
        # host, no process group yet), the last decode steps' host clock, a
        # profile of one decode step when asked (profile_next_decode), the
        # checksum of the rank's weight blocks and its peak memory at load
        self.mesh = None
        self._mh = False
        self._mh_ctrl = True
        self._followers: List = []
        self._step_log: "collections.deque" = collections.deque(maxlen=16)
        self._profile_next = False
        self._decode_profile: Optional[Dict] = None
        self._fingerprint: Optional[int] = None
        self._load_peak: Optional[int] = None
        self._stage = None  # the stage block under construction (pipeline_parallel)
        self._paged = bool(gen.paged)

    # ------------------------------------------------------------------ setup
    @property
    def tokenizer(self):
        """Model-local tokenizer (tokenizer.json in the version dir, HF
        `tokenizers` format), lazily loaded; None when absent — the token-id
        APIs always work without one."""
        if not hasattr(self, "_tokenizer"):
            self._tokenizer = None
            path = os.path.join(self.model_dir, "tokenizer.json")
            if os.path.exists(path):
                try:
                    from tokenizers import Tokenizer

                    self._tokenizer = Tokenizer.from_file(path)
                except Exception:
                    self._tokenizer = None
        return self._tokenizer

    def generate_text(self, text: str, **kw) -> Dict:
        """Text-in/text-out generation; requires tokenizer.json."""
        tok = self.tokenizer
        if tok is None:
            raise InvalidArgumentError(
                "model has no tokenizer.json; send 'input_ids' instead of 'text'"
            )
        ids = tok.encode(text).ids
        result = self.generate(ids, **kw)
        result["text"] = tok.decode(result["generated_ids"])
        return result

    def load_params(self, dtype=torch.bfloat16, host: bool = False) -> Dict[str, torch.Tensor]:
        """The checkpoint's flat param dict on the engine's device (with
        `host`, on the CPU), floating tensors in `dtype` (the engine serves
        bf16; the accuracy script's reference takes f32): model.safetensors,
        or with model_params.init "random" weights from seed 42, drawn on
        the engine's device either way."""
        init_mode = str(self.config.model_params.get("init", "")).lower()
        st_path = os.path.join(self.model_dir, "model.safetensors")
        dev = torch.device("cpu") if host else self.device
        if os.path.exists(st_path):   # the port's own reader: no safetensors package needed
            out = {}
            for k, t in read_safetensors(st_path).items():
                if t.is_floating_point():
                    t = t.to(dtype)
                out[k] = t.to(dev)
            return out
        if init_mode == "random":
            return llama.init_params(self.p, dtype=dtype, device=self.device, seed=42,
                                     keep=lambda _, t: t.to(dev))
        raise BackendError(
            f"no checkpoint in {self.model_dir} and model_params.init != 'random'")

    def _mesh_sizes(self):
        shard = self.config.sharding
        return (int(shard.tensor_parallel), int(shard.data_parallel),
                int(getattr(shard, "sequence_parallel", 1) or 1))

    @property
    def _pp(self) -> int:
        return int(getattr(self.config.sharding, "pipeline_parallel", 1) or 1)

    def _world(self) -> int:
        tp, dp, sp = self._mesh_sizes()
        return tp * dp * sp * self._pp

    def _check_supported(self) -> None:
        qcfg, gen, p = self.config.quantization, self.config.generation, self.p
        tp, dp, sp = self._mesh_sizes()
        pp = self._pp
        spec_k = int(getattr(gen, "speculation_tokens", 0) or 0)
        self._check_head_dim(spec_k)
        if pp > 1:
            self._check_pipeline(pp, tp, dp, sp)
        if self._world() > 1:
            from tpuserve_torch.parallel import distributed

            if distributed.joined_by_variables():
                # the JAX package's multi-host v1 refusals
                if pp > 1:
                    raise BackendError("multi-host serving v1 does not compose with "
                                       "pipeline_parallel")
                if gen.paged:
                    raise BackendError("multi-host serving v1 does not compose with paged KV "
                                       "(page-table bookkeeping is controller-local)")
                if spec_k > 0:
                    raise BackendError("multi-host serving v1 does not compose with "
                                       "speculative decoding")
            self._check_mesh(tp, dp, sp)
        if spec_k > 0 and not gen.paged and self._world() == 1:
            # the one-rank contiguous verify's kernel takes C = k+1 candidates
            # of the query heads one block serves (a head pair's for int4 KV);
            # a mesh verifies by einsum
            nq = p.n_heads // p.n_kv_heads * (2 if qcfg.kv_cache == "int4" else 1)
            cache = qcfg.kv_cache if qcfg.kv_cache in ("int8", "int4") else "bf16"
            try:
                check_multi_kernel(spec_k + 1, nq, cache=cache, hd=p.head_dim)
            except ValueError as e:
                raise BackendError(f"generation.speculation_tokens {spec_k}: {e}") from e

    def _check_head_dim(self, spec_k: int) -> None:
        """Refuse at load a head_dim that a decode-attention kernel of the
        configured mode (TPUSERVE_DECODE_ATTN, read here as decode_step reads
        it) does not take, naming the shape and the kernels: "pallas" runs
        the flat core in the decode step, the multi-candidate core in a
        speculative verify and the paged core over a paged pool wherever
        head_dim is a multiple of 128 (else the einsum path, as the JAX
        package); "grouped" runs the grouped kernel in the contiguous decode
        step, and the einsum path over a paged pool. The kernels take
        head_dim 128 and 256, so a larger multiple of 128 is refused here and
        never at a decode step; the CPU's plain versions are held to the
        card's shapes."""
        p, gen = self.p, self.config.generation
        mode = llama._decode_attn_mode(p)
        if mode == "xla" or p.head_dim in KERNEL_HEAD_DIMS or (mode == "grouped" and gen.paged):
            return
        if mode == "grouped":
            used = ["grouped"]
        else:
            used = ["paged" if gen.paged else "flat"]
            if spec_k > 0 and not gen.paged:
                used.append("multi-candidate")
        raise BackendError(
            f"head_dim {p.head_dim} ({p.n_heads} heads over {p.n_kv_heads} kv heads): the "
            f"{' and '.join(used)} decode-attention kernel{'s' if len(used) > 1 else ''} of "
            f"TPUSERVE_DECODE_ATTN={mode} take head_dim {' or '.join(map(str, KERNEL_HEAD_DIMS))}")

    def _check_pipeline(self, pp: int, tp: int, dp: int, sp: int) -> None:
        """The JAX engine's refusals under pipeline_parallel, with its
        messages."""
        p, gen, qcfg = self.p, self.config.generation, self.config.quantization
        if sp > 1:
            if tp > 1:
                raise BackendError("pipeline_parallel x sequence_parallel does not compose "
                                   "with tensor_parallel (v1)")
            if gen.paged:
                raise BackendError("sequence_parallel does not compose with paged KV")
        if gen.paged:
            if tp > 1 or dp > 1:
                raise BackendError("pipeline_parallel x paged KV requires tensor_parallel = "
                                   "data_parallel = 1 (v1)")
            if bool(getattr(gen, "prefix_sharing", False)):
                raise BackendError("pipeline_parallel x paged KV does not compose with "
                                   "prefix_sharing")
        if self._chunk_size > 0:
            raise BackendError("pipeline_parallel does not compose with prefill_chunk (v1)")
        if p.n_layers % pp:
            raise BackendError(f"n_layers {p.n_layers} must divide by pipeline_parallel {pp}")
        if self.n_slots % (pp * dp):
            raise BackendError(f"max_slots {self.n_slots} must divide by "
                               f"pipeline_parallel*data_parallel {pp * dp}")
        if tp > 1 and (p.n_kv_heads % tp or p.n_heads % tp or p.ffn_dim % tp):
            raise BackendError(f"n_heads/n_kv_heads/ffn_dim must divide by tensor_parallel "
                               f"{tp} under pipeline_parallel")
        if tp > 1 and p.n_experts:
            raise BackendError("pipeline_parallel x tensor_parallel does not compose with "
                               "MoE yet")
        if qcfg.kv_cache == "int4":
            raise BackendError("kv_cache int4 does not compose with pipeline_parallel "
                               "(5D stage caches)")

    def _check_mesh(self, tp: int, dp: int, sp: int) -> None:
        """The JAX engine's divisibility errors and v1 refusals under a mesh,
        and the widths a tp split must divide."""
        p, qcfg, gen = self.p, self.config.quantization, self.config.generation
        if self.n_slots % dp:
            raise BackendError(f"max_slots {self.n_slots} must divide by data_parallel {dp}")
        if self.max_seq_len % sp:
            raise BackendError(
                f"max_seq_len {self.max_seq_len} must divide by sequence_parallel {sp}")
        if sp > 1 and gen.paged:
            raise BackendError("sequence_parallel does not compose with paged KV (page pools "
                               "address L dynamically; shard slots/heads via "
                               "data_parallel/tensor_parallel instead)")
        if int(getattr(qcfg, "lowrank_correction", 0) or 0) > 0:
            raise BackendError("quantization.lowrank_correction is single-chip (v1): the "
                               "rank-r correction factors are not sharded")
        if qcfg.kv_cache == "int4" and gen.paged:
            raise BackendError("paged kv_cache int4 is single-chip (the shared pool cannot "
                               "shard a packed W dim)")
        if qcfg.kv_cache == "int4":
            if sp > 1:
                raise BackendError("kv_cache int4 does not compose with sequence_parallel "
                                   "(sp reads the 5D layout)")
            if p.n_kv_heads % tp or (p.n_kv_heads * p.head_dim // tp) % 2:
                raise BackendError("kv_cache int4 under tp needs tp | n_kv_heads")
        qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim
        widths = {"(n_heads + 2 n_kv_heads) * head_dim": qd + 2 * kvd,
                  "n_heads * head_dim": qd}
        if self._pp == 1:   # a pipeline stage holds the lm_head whole
            widths["vocab_size"] = p.vocab_size
        if not p.n_experts:
            widths["ffn_dim"] = p.ffn_dim
        for what, width in widths.items():
            if width % tp:
                raise BackendError(f"{what} ({width}) must divide by tensor_parallel {tp}")
        if _QUANT_BITS.get(qcfg.weights) == 4:
            from tpuserve_torch.parallel.sharding import row_shard_cuts_group

            rows = {"wo": qd} if p.n_experts else {"wo": qd, "w_down": p.ffn_dim}
            for name, k in rows.items():
                if row_shard_cuts_group(k, qcfg.group_size, tp):
                    raise BackendError(
                        f"int4 {name}: a row shard of {k // tp} rows over tensor_parallel "
                        f"{tp} cuts a quantization group of {qcfg.group_size or k} (codes "
                        "pack split-half per group)")

    def _gptq_quantize(self, raw: Dict, bits: int, qcfg) -> Dict:
        """Hessian-calibrated GPTQ (with LoRC at quantization.
        lowrank_correction > 0) for the dense 2-D kernels, fused wqkv and
        w_gateup and lm_head included, on the engine's device; MoE expert
        stacks are quantized by RTN afterwards. Calibration tokens: an .npy
        int32 [B, L] file named by quantization.calibration, or the JAX
        package's synthetic draw (the same tokens). The per-layer seconds
        of collection, GPTQ and LoRC go to `gptq_timings`."""
        from tpuserve_torch.quant.gptq import collect_and_quantize_llama

        calib_src = qcfg.calibration
        if calib_src and calib_src != "synthetic":
            path = calib_src if os.path.isabs(calib_src) else os.path.join(
                self.model_dir, calib_src)
            tokens = np.load(path).astype(np.int32)
            if tokens.ndim != 2:
                raise BackendError(
                    f"gptq calibration file {path} must be int32 [B, L]")
        else:
            tokens = np.random.default_rng(0).integers(
                0, self.p.vocab_size, (16, 128)).astype(np.int32)
        t0 = time.monotonic()
        self.gptq_timings.clear()
        params = collect_and_quantize_llama(
            raw, self.p, torch.from_numpy(tokens), bits=bits, group_size=qcfg.group_size,
            lowrank_r=int(getattr(qcfg, "lowrank_correction", 0) or 0),
            timings=self.gptq_timings)
        if self.p.n_experts:
            params = quantize_param_tree(
                params, bits=bits, group_size=qcfg.group_size,
                predicate=lambda n, a: getattr(a, "ndim", 0) == 3
                and n.endswith("kernel") and "router" not in n)
        log.info("gptq calibration+quantization took %.1fs (%d tokens)",
                 time.monotonic() - t0, tokens.size)
        return params

    def start(self) -> None:
        self._check_supported()
        world = self._world()
        from tpuserve_torch.parallel import distributed

        if world == 1:
            if distributed.is_multi_host():
                raise BackendError(
                    "multi-process serving requires a sharded config (set "
                    "sharding.tensor_parallel/data_parallel/sequence_parallel)")
            self._start_rank()
            return
        global _MH_LIVE_ENGINE
        if _MH_LIVE_ENGINE is not None and _MH_LIVE_ENGINE is not self:
            raise BackendError("sharded serving serves ONE model at a time (the event bus "
                               "is a single ordered stream)")
        _MH_LIVE_ENGINE = self
        try:
            self._join_ranks(world)
            self._start_rank()
        except BaseException:
            # leave no live-engine mark and no ranks behind a failed start
            self._leave_ranks()
            if _MH_LIVE_ENGINE is self:
                _MH_LIVE_ENGINE = None
            raise

    def _join_ranks(self, world: int) -> None:
        """Take this process's rank: the process group's (ranks joined by the
        TPUSERVE_* variables), or rank 0 of one this engine forms with
        world - 1 follower ranks it starts on this host. The controller then
        tells the followers to load this model; every rank builds the mesh."""
        from tpuserve_torch.parallel import distributed
        from tpuserve_torch.parallel.dispatcher import publish_event
        from tpuserve_torch.parallel.mesh import make_mesh, rank_device

        if distributed.is_initialized():
            have = distributed.process_info()["process_count"]
            if have != world:
                raise BackendError(f"the mesh needs {world} ranks (tensor_parallel x "
                                   f"data_parallel x sequence_parallel x pipeline_parallel), "
                                   f"the process group has {have}")
        else:
            self._followers = distributed.launch_local_ranks(world, self.device.type)
        rank = distributed.process_info()["process_index"]
        self._mh, self._mh_ctrl = True, rank == 0
        if self._mh_ctrl:
            publish_event(("load", self.model_dir, self.config, self.device.type))
        tp, dp, sp = self._mesh_sizes()
        if self._pp > 1:
            from tpuserve_torch.parallel.mesh import make_pipeline_mesh

            self.mesh = make_pipeline_mesh(self._pp, tp=tp, dp=dp, sp=sp,
                                           backend=distributed.backend())
        else:
            self.mesh = make_mesh(tp=tp, dp=dp, sp=sp, backend=distributed.backend())
        dev = rank_device(self.device.type, rank)
        if dev != self.device:
            self.device = dev
            self._generator = torch.Generator(device=dev)
            self._generator.manual_seed(int(self.config.model_params.get("seed", 0)))
            self._sampling = SamplingParams.create(self.n_slots, device=dev)
        # every rank's groups are up before any rank loads: a rank that
        # fails its load and exits would otherwise close its sockets under
        # another rank's group creation
        from tpuserve_torch.parallel.sharding import mesh_any

        mesh_any(self.mesh, False, self.device)

    def _leave_ranks(self) -> None:
        """Release the followers (a published unload), the mesh's groups, the
        active mesh and the ranks this engine started."""
        from tpuserve_torch.parallel import distributed
        from tpuserve_torch.parallel.sharding import set_active_mesh

        if self._mh and self._mh_ctrl:
            try:
                self._publish(("unload",))
            except Exception as e:  # a dead follower: nothing left to release
                log.error("could not release the follower ranks: %s", e)
        if self.mesh is not None:
            set_active_mesh(None)
            if self.mesh.comm is not None:
                self.mesh.comm.destroy()
            self.mesh = None
        if self._followers:
            codes = distributed.stop_local_ranks(self._followers)
            if any(codes):
                log.error("follower ranks exited with codes %s", codes)
            self._followers = []
            distributed.shutdown()
        self._mh = False

    def _keep_block(self, name: str, val):
        """This rank's block of one parameter, on the device (the whole value
        unsharded; under pipeline_parallel the stage block takes the layers,
        None here)."""
        if self.mesh is None:
            return val
        if self._stage is not None:
            return self._stage.keep(name, val)
        from tpuserve_torch.parallel.sharding import shard_llama_params

        return shard_llama_params({name: val}, self.mesh)[name]

    def _start_rank(self) -> None:
        """Build the weights. Under a mesh each parameter is cut to the
        rank's block as it is made (checkpoints and bf16 draws wait on the
        host and go to the card one tensor at a time), so the card holds the
        rank's blocks and one whole parameter at most; GPTQ calibrates on
        the whole model first."""
        p = self.p
        qcfg = self.config.quantization
        bits = _QUANT_BITS.get(qcfg.weights)
        init_mode = str(self.config.model_params.get("init", "")).lower()
        if self._pp > 1:
            from tpuserve_torch.parallel.pipeline import StageBlock

            self._stage = StageBlock(p, self.mesh)
        if init_mode == "random_quantized":
            if bits is None:
                raise BackendError(
                    "model_params.init 'random_quantized' requires "
                    "quantization.weights int8/int4")
            params = init_quantized_params(p, bits=bits, group_size=qcfg.group_size,
                                           device=self.device, seed=42, keep=self._keep_block)
        else:
            raw = llama.fuse_params(self.load_params(host=self.mesh is not None), p)
            if bits is not None and qcfg.method == "gptq":
                raw = {name: t.to(self.device) for name, t in raw.items()}
                params = self._gptq_quantize(raw, bits, qcfg)
                params = {name: self._keep_block(name, val) for name, val in params.items()}
            else:
                def pred(name, arr):
                    # 2-D projections and stacked 3-D MoE expert weights; the
                    # router stays bf16 (routing is precision-sensitive)
                    return arr.dim() in (2, 3) and name.endswith("kernel") and "router" not in name

                params = {}
                for name in list(raw):
                    val = raw.pop(name).to(self.device)
                    if bits is not None:
                        val = quantize_param_tree(
                            {name: val}, bits=bits, group_size=qcfg.group_size, predicate=pred,
                            act_bits=8 if qcfg.activations == "int8" else 0,
                            act_fp8=qcfg.activations == "fp8")[name]
                    params[name] = self._keep_block(name, val)
        if self._stage is not None:
            params, self._stage = self._stage.finish(params), None
        self._finish_start(params)

    def _finish_start(self, params) -> None:
        p = self.p
        qcfg = self.config.quantization
        if self.mesh is not None:
            # `params` are this rank's blocks (_start_rank)
            from tpuserve_torch.parallel.sharding import (block_fingerprint, kv_replicated,
                                                          local_llama_params,
                                                          set_active_mesh)

            self._fingerprint = block_fingerprint(params)
            if self._pp == 1:   # a pipeline stage runs its own collectives
                set_active_mesh(self.mesh)
            pc = local_llama_params(p, self.mesh)
            n_slots = self.n_slots // self.mesh.shape["dp"]
            max_len = self.max_seq_len // self.mesh.shape["sp"]
        else:
            pc, n_slots, max_len = p, self.n_slots, self.max_seq_len
        self.params = params
        self._param_bytes = param_bytes(params)
        gen = self.config.generation
        if gen.paged and self._chunk_size > 0 and self._chunk_size % int(gen.page_size) != 0:
            raise BackendError(
                f"generation.prefill_chunk ({self._chunk_size}) must be a "
                f"multiple of page_size ({gen.page_size}) in paged mode")
        if self._chunk_size > 0 and self.max_seq_len % self._chunk_size != 0:
            # a trailing chunk may not straddle max_seq_len
            raise BackendError(
                f"generation.prefill_chunk ({self._chunk_size}) must divide "
                f"max_seq_len ({self.max_seq_len})")
        quant_kv = qcfg.kv_cache in ("int8", "int4")
        kv_bits = 4 if qcfg.kv_cache == "int4" else 8
        if kv_bits == 4 and (p.n_kv_heads * p.head_dim) % 2:
            raise BackendError("kv_cache int4 needs even n_kv_heads*head_dim")
        if gen.paged:
            # flat pools (the JAX package's int4 pools are always flat), cut
            # over tp and replicated over dp under a mesh (where tp does not
            # divide the kv heads, the whole 5D pool on every rank); a
            # pipeline stage's block of the 5D pool; scale pools are float32
            # whatever kv_scale_dtype says, as there
            ps = int(gen.page_size)
            max_pages = -(-self.max_seq_len // ps)
            num_pages = int(gen.num_pages) or self.n_slots * max_pages + 1
            if self._pp > 1:
                self.cache = PagedKVCache.create(
                    dataclasses.replace(p, n_layers=p.n_layers // self._pp), num_pages, ps,
                    quantized=quant_kv, dtype=torch.bfloat16, device=self.device, flat=False)
            elif self.mesh is not None:
                from tpuserve_torch.parallel.sharding import paged_cache_block

                self.cache = paged_cache_block(p, self.mesh, num_pages, ps, quant_kv,
                                               dtype=torch.bfloat16, kv_bits=kv_bits,
                                               device=self.device)
            else:
                self.cache = PagedKVCache.create(p, num_pages, ps, quantized=quant_kv,
                                                 dtype=torch.bfloat16, kv_bits=kv_bits,
                                                 device=self.device)
            # the controller's page bookkeeping; followers get table rows on the bus
            self.ptm = None if not self._mh_ctrl else PageTableManager(
                num_pages, ps, self.n_slots, self.max_seq_len,
                prefix_sharing=bool(gen.prefix_sharing), device=self.device)
            if self.ptm is not None:
                log.info("paged KV: %s page allocator (native runtime %s)",
                         self.kv_allocator, self._native_version())
        else:
            # a rank's block: its slots, kv heads and (5D under sp) L window,
            # or where tp does not divide the kv heads every head on the 5D
            # cache, as the JAX engine; a pipeline stage's 5D stage cache
            scale_dtype = torch.bfloat16 \
                if getattr(qcfg, "kv_scale_dtype", "float32") == "bfloat16" else torch.float32
            if self._pp > 1:
                from tpuserve_torch.parallel.pipeline import stage_cache

                self.cache = stage_cache(p, self.mesh, self.n_slots, self.max_seq_len,
                                         quant_kv, dtype=torch.bfloat16,
                                         scale_dtype=scale_dtype, device=self.device)
            else:
                flat = self.mesh is None or (self.mesh.shape["sp"] == 1
                                             and not kv_replicated(p, self.mesh))
                self.cache = KVCache.create(pc, n_slots, max_len, quantized=quant_kv,
                                            dtype=torch.bfloat16, scale_dtype=scale_dtype,
                                            kv_bits=kv_bits, device=self.device, flat=flat)
            self.ptm = None
        self._presence = torch.zeros((self.n_slots, p.vocab_size), dtype=torch.bool,
                                     device=self.device)
        if self.device.type == "cuda":
            self._load_peak = torch.cuda.max_memory_allocated(self.device)
        self._running = True
        if self._mh_ctrl:   # follower ranks replay the controller's steps instead
            self._thread = threading.Thread(target=self._loop,
                                            name="tpuserve-torch-genloop", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        global _MH_LIVE_ENGINE
        self._running = False
        self._pending.put(None)
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        # followers are released after the scheduler's last step (event
        # order is step order)
        self._leave_ranks()
        if _MH_LIVE_ENGINE is self:
            _MH_LIVE_ENGINE = None
        self._fail_outstanding("engine stopped")
        self.params = None
        self.cache = None

    # ------------------------------------------------------------ sharded serving
    def _publish(self, ev) -> None:
        """Controller: hand a step's host inputs to the follower ranks (a
        no-op unsharded)."""
        if self._mh and self._mh_ctrl:
            from tpuserve_torch.parallel.dispatcher import publish_event

            publish_event(ev)

    def run_follower(self) -> str:
        """A follower rank's loop: replay the controller's steps in event
        order until the model unloads; returns "unload" or "shutdown" (a
        server teardown that never unloaded the model). Call after start()
        on ranks other than 0."""
        from tpuserve_torch.parallel.dispatcher import exchange, recv_event

        last_logits = None
        while True:
            ev = recv_event()
            op = ev[0]
            if op == "admit":
                self._dev_admit(*ev[1:])
            elif op == "decode":
                self._dev_decode(*ev[1:])
            elif op == "chunk":
                last_logits = self._dev_chunk(*ev[1:])
            elif op == "chunk_final":
                self._dev_first_sample(*ev[1:], last_logits)
            elif op == "verify":
                try:
                    self._dev_verify(*ev[1:])
                except Exception as e:  # every rank raised: the controller latches too
                    self._spec_failed(e)
            elif op == "stats":
                exchange(self.local_stats(*ev[1:]))
            elif op == "ping":
                continue
            elif op in ("unload", "shutdown"):
                return op
            else:
                raise BackendError(f"unknown event on the bus: {op!r}")

    @property
    def kv_allocator(self) -> Optional[str]:
        """The page allocator's class (paged mode, the controller), or None."""
        return None if self.ptm is None else type(self.ptm._alloc).__name__

    @staticmethod
    def _native_version() -> Optional[str]:
        from tpuserve_torch.bindings import native

        return native.version()

    def local_stats(self, cache: bool = False) -> Dict:
        """This rank's counts: the kernels' launches (quant-matmul, the flat
        and paged decode-attention core) at the shard shapes, the plain-torch row
        shards, its verify calls and the candidate rows they wrote into its
        block, the last decode steps' host clock, the profiled decode step
        (profile_next_decode), its weight blocks' checksum and its memory.
        cache=True adds its cache's checksum (the tp replicas of a cache block
        are byte-equal), a read of the whole cache that only checks ask for."""
        from tpuserve_torch.ops import decode_attention, quant_matmul
        from tpuserve_torch.parallel import sharding

        host = sorted(ms / h for ms, h in self._step_log)
        cuda = self.device.type == "cuda"
        stats = {"rank": self.mesh.rank if self.mesh is not None else 0,
                "coords": dict(self.mesh.coords) if self.mesh is not None else None,
                "device": str(self.device), "backend": self.mesh.backend if self.mesh else None,
                "quant_matmul_launches": quant_matmul.launches,
                "decode_attention_launches": decode_attention.launches,
                "decode_attention_paged_launches": decode_attention.paged_launches,
                "plain_calls": quant_matmul.plain_calls + decode_attention.plain_calls,
                "shard_launches": dict(sharding.shard_launches),
                "shard_launch_rows": dict(sharding.shard_launch_rows),
                "plain_row_shards": sharding.plain_fallbacks,
                "kv_allocator": self.kv_allocator, "native_runtime": self._native_version(),
                "verify_calls": self.verify_calls,
                "verify_rows_written": sharding.verify_rows_written,
                "spec_disabled": self._spec_disabled,
                "step_host_ms_median": host[len(host) // 2] if host else None,
                "decode_profile": self._decode_profile,
                "param_bytes": self._param_bytes, "param_fingerprint": self._fingerprint,
                "cache_bytes": self.cache.nbytes if self.cache is not None else 0,
                "load_max_memory_allocated": self._load_peak,
                "max_memory_allocated": torch.cuda.max_memory_allocated(self.device)
                if cuda else None}
        if cache:
            stats["cache_fingerprint"] = sharding.block_fingerprint({} if self.cache is None else {
                name: getattr(self.cache, name) for name in ("k", "v", "k_scale", "v_scale")
                if getattr(self.cache, name) is not None})
        return stats

    def rank_stats(self, cache: bool = False) -> List[Dict]:
        """Every rank's local_stats(cache), in rank order (controller only:
        the followers answer a published "stats" event on the bus)."""
        if not self._mh:
            return [self.local_stats(cache)]
        from tpuserve_torch.parallel.dispatcher import controlled, exchange, publish_event

        with controlled():
            publish_event(("stats", cache))
            return exchange(self.local_stats(cache))

    def _fail_outstanding(self, reason: str) -> None:
        """Complete every in-flight and queued request with an error so no
        caller blocks forever across a stop/crash."""
        if self._chunking is not None:
            req = self._chunking["req"]
            req.error = reason
            req.token_queue.put(None)
            req.done.set()
            self._release(self._chunking["slot"])
            self._chunking = None
        for i, st in enumerate(self._slots):
            if st is not None:
                st.request.error = reason
                st.request.token_queue.put(None)
                st.request.done.set()
                self._slots[i] = None
                self._release(i)
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = reason
                req.token_queue.put(None)
                req.done.set()

    def _release(self, slot: int) -> None:
        """Return a slot's pages to the pool (paged mode; else a no-op)."""
        if self.ptm is not None:
            self.ptm.release(slot)

    def memory_usage_bytes(self) -> int:
        total = self._param_bytes
        if self.cache is not None:
            total += self.cache.nbytes
        return total

    def serving_stats(self) -> Dict:
        stats = {
            "active_slots": sum(1 for s in self._slots if s is not None),
            "max_slots": self.n_slots,
            "queue_depth": self._pending.qsize(),
            "decode_steps": self.steps,
            "prefill_calls": self.prefill_calls,
            "tokens_generated": self.tokens_out,
            "tokens_prefilled": self.tokens_in,
            "paged": self.ptm is not None,
            "decode_horizon_last": self._horizon_last,
        }
        if self.mesh is not None:
            stats["mesh"] = dict(self.mesh.shape, world=self.mesh.size,
                                 backend=self.mesh.backend)
            if self._mh_ctrl and self._running:
                try:
                    stats["ranks"] = self.rank_stats()
                except Exception as e:  # a dead follower
                    stats["ranks_error"] = str(e)
        if self.spec_drafted:
            stats["spec_drafted"] = self.spec_drafted
            stats["spec_accepted"] = self.spec_accepted
        if self._tok_ms_ema is not None:
            stats["decode_token_ms_ema"] = round(self._tok_ms_ema, 3)
        if self.ptm is not None:
            stats["kv_free_pages"] = self.ptm.free_pages
            if self.ptm.prefix_sharing:
                stats["prefix_cached_blocks"] = self.ptm.cached_blocks
                stats["prefix_hits"] = self.ptm.prefix_hits
                stats["prefix_hit_tokens"] = self.ptm.prefix_hit_tokens
            stats["kv_page_size"] = self.ptm.page_size
        return stats

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids: List[int], max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               seed: Optional[int] = None, repetition_penalty: float = 1.0,
               min_p: float = 0.0, stop_token_ids: Optional[List[int]] = None,
               logprobs: bool = False) -> Request:
        if not self._running:
            raise BackendError("engine is not running")
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise InvalidArgumentError("empty prompt")
        if len(prompt_ids) >= self.max_seq_len:
            raise InvalidArgumentError(
                f"prompt length {len(prompt_ids)} exceeds max_seq_len {self.max_seq_len}")
        req = Request(
            prompt_ids=prompt_ids,
            max_new_tokens=int(max_new_tokens or self.default_max_new),
            temperature=float(temperature), top_k=int(top_k), top_p=float(top_p),
            repetition_penalty=float(repetition_penalty), min_p=float(min_p),
            stop_token_ids=[int(t) for t in (stop_token_ids or [])],
            want_logprobs=bool(logprobs), id=next(self._req_ids))
        self._pending.put(req)
        return req

    def generate(self, prompt_ids, max_new_tokens: Optional[int] = None, **kw) -> Dict:
        """Blocking generation; returns {"output_ids", "generated_ids",
        "num_generated", "finish_reason"[, "logprobs"]}."""
        req = self.submit(prompt_ids, max_new_tokens=max_new_tokens, **kw)
        req.done.wait()
        if req.error:
            raise BackendError(req.error)
        out = {
            "output_ids": list(req.prompt_ids) + list(req.output_ids),
            "generated_ids": list(req.output_ids),
            "num_generated": len(req.output_ids),
            "finish_reason": req.finish_reason,
        }
        if req.want_logprobs:
            out["logprobs"] = list(req.logprobs)
        return out

    def infer_tensors(self, inputs: List[Tensor]) -> List[Tensor]:
        by_name = {t.name: t for t in inputs}
        if "input_ids" not in by_name:
            raise InvalidArgumentError("LLM infer requires an 'input_ids' tensor")
        ids = by_name["input_ids"].numpy().reshape(-1).astype(np.int64).tolist()
        max_new = self.default_max_new
        if "max_new_tokens" in by_name:
            max_new = int(by_name["max_new_tokens"].numpy().reshape(-1)[0])
        result = self.generate(ids, max_new_tokens=max_new)
        out = np.asarray(result["output_ids"], np.int32)[None, :]
        return [Tensor(name="output_ids", dtype=DataType.INT32, shape=out.shape, data=out)]

    # ------------------------------------------------------------------ device
    def _bucket_len(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq_len)

    def _window(self, last_pos: int) -> int:
        """KV read window of a dispatch whose last write is at `last_pos`:
        the smallest of generation.decode_buckets power-of-two buckets past
        it (0 buckets: the whole max_seq_len)."""
        n_buckets = int(self.config.generation.decode_buckets)
        if n_buckets <= 0:
            return self.max_seq_len
        window = max(64, self.max_seq_len >> n_buckets)
        while window <= last_pos:
            window *= 2
        return min(window, self.max_seq_len)

    def _free_slot(self) -> Optional[int]:
        busy = self._chunking["slot"] if self._chunking is not None else -1
        for i, s in enumerate(self._slots):
            if s is None and i != busy:
                return i
        return None

    def _tokens(self, ids, width: int) -> torch.Tensor:
        tokens = np.zeros((1, width), np.int64)
        tokens[0, :len(ids)] = ids
        return torch.from_numpy(tokens).to(self.device)

    def _admit_pages(self, slot: int, prompt_ids):
        """Controller, paged mode: shared prefix pages first, private pages
        for the rest of the bucket. Returns (the slot's table row, matched
        tokens) for the admission's event."""
        _, matched = self.ptm.admit_shared(slot, prompt_ids)
        try:
            self.ptm.ensure(slot, self._bucket_len(len(prompt_ids)))  # ResourceExhaustedError
        except Exception:
            self.ptm.release(slot)  # drop the shared refs taken above
            raise
        return self.ptm.table[slot].copy(), matched

    def _table(self, rows) -> torch.Tensor:
        """A device page table [S, P] int32 from the controller's rows: the
        whole table ([S, P] array) or {slot: row} (the other rows point at
        the zero page)."""
        if isinstance(rows, dict):
            table = np.zeros((self.n_slots, -(-self.max_seq_len // int(
                self.config.generation.page_size))), np.int32)
            for slot, row in rows.items():
                table[slot] = row
            rows = table
        return torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(self.device)

    def _dev_admit(self, slot: int, prompt_ids, samp, paged=None):
        """Whole-prompt admission: bucketed prefill + first-token sample.
        Paged mode (`paged` = the slot's table row and the tokens its shared
        prefix matched): a suffix prefill when a prefix matched."""
        l = len(prompt_ids)
        bucket = self._bucket_len(l)
        pp = self._pp > 1
        if paged is None:
            tokens = self._tokens(prompt_ids, bucket)
            if pp:
                logits, _ = pipeline.pp_prefill(self.params, self.p, tokens, self.cache, slot,
                                                l, self.mesh)
            else:
                logits, _ = llama.prefill(self.params, self.p, tokens, self.cache, slot, l)
        else:
            row, matched = paged
            table = self._table({slot: row})
            if matched > 0:
                # matched pages already hold valid KV: prefill the suffix only
                suffix = prompt_ids[matched:]
                cb = self._bucket_len(len(suffix))
                ps = int(self.config.generation.page_size)
                win = -(-min(matched + cb, self.max_seq_len) // ps) * ps
                logits, _ = llama.prefill_paged_suffix(
                    self.params, self.p, self._tokens(suffix, cb), self.cache, table, slot,
                    matched, len(suffix), window=win)
            elif pp:
                logits, _ = pipeline.pp_prefill_paged(
                    self.params, self.p, self._tokens(prompt_ids, bucket), self.cache, table,
                    slot, l, self.mesh)
            else:
                logits, _ = llama.prefill_paged(
                    self.params, self.p, self._tokens(prompt_ids, bucket), self.cache,
                    table, slot, l)
        self.prefill_calls += 1
        return self._dev_first_sample(slot, prompt_ids, samp, logits)

    def _dev_first_sample(self, slot: int, prompt_ids, samp, logits):
        """Sample the first generated token from prefill logits [1, V]."""
        self._sampling.update_slot(slot, *samp)
        row = np.zeros((self.p.vocab_size,), np.bool_)
        row[np.asarray(prompt_ids, np.int64)] = True
        self._presence[slot] = torch.from_numpy(row).to(self.device)
        toks, lps, _ = sample_with_logprobs(
            logits, self._sampling.select(slot), self._generator,
            self._presence[slot:slot + 1].clone())
        both = torch.stack([toks.to(torch.float64), lps.to(torch.float64)]).cpu()
        tok, lp0 = int(both[0, 0]), float(both[1, 0])
        self._presence[slot, tok] = True
        return tok, lp0

    def _dev_chunk(self, slot: int, chunk_ids, c0: int, n: int, window: int, row=None):
        """One prefill chunk; returns this chunk's logits. Paged mode runs
        it as a suffix prefill over the slot's pages (`row`, its table
        row)."""
        tokens = self._tokens(chunk_ids, self._chunk_size)
        if row is None:
            logits, _ = llama.prefill_chunk(self.params, self.p, tokens, self.cache, slot,
                                            c0, n, window=window)
        else:
            logits, _ = llama.prefill_paged_suffix(
                self.params, self.p, tokens, self.cache, self._table({slot: row}), slot,
                c0, n, window=window)
        self.prefill_calls += 1
        return logits

    def _dev_decode(self, tokens, positions, window: int, horizon: int, profile: bool = False,
                    table=None):
        """`horizon` batched decode+sample steps back to back on the device,
        fetched with one copy; returns ([H, S] tokens, [H, S] logprobs) as
        host arrays. Slots that are inactive (position -1) stay so. Paged
        mode: `table`, the controller's page table [S, P]."""
        t0 = time.monotonic()
        prof = self._profile_start() if profile else None
        toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        positions = np.asarray(positions, np.int32)
        pos = torch.from_numpy(positions).to(self.device)
        active_idx = torch.from_numpy(np.nonzero(positions >= 0)[0]).to(self.device)
        table = None if table is None else self._table(table)
        pp = self._pp > 1
        out_t, out_lp = [], []
        for _ in range(horizon):
            if table is None and pp:
                logits, _ = pipeline.pp_decode_step(self.params, self.p, toks, self.cache, pos,
                                                    self.mesh, window=window)
            elif table is None:
                logits, _ = llama.decode_step(self.params, self.p, toks, self.cache, pos,
                                              window=window, active_idx=active_idx)
            elif pp:
                logits, _ = pipeline.pp_decode_step_paged(self.params, self.p, toks,
                                                          self.cache, table, pos, self.mesh,
                                                          window=window)
            else:
                logits, _ = llama.decode_step_paged(self.params, self.p, toks, self.cache,
                                                    table, pos, window=window,
                                                    active_idx=active_idx)
            toks, lp, _ = sample_with_logprobs(logits, self._sampling, self._generator,
                                               self._presence)
            pos = torch.where(pos >= 0, pos + 1, pos)
            out_t.append(toks)
            out_lp.append(lp)
        both = torch.stack([torch.stack(out_t).to(torch.float64),
                            torch.stack(out_lp).to(torch.float64)]).cpu().numpy()
        host_ms = (time.monotonic() - t0) * 1e3
        if prof is not None:
            self._decode_profile = self._profile_finish(prof, host_ms, horizon)
        else:
            self._step_log.append((host_ms, horizon))
        return both[0].astype(np.int64), both[1].astype(np.float32)

    def profile_next_decode(self) -> None:
        """Every rank runs the next decode dispatch under torch.profiler (the
        controller's decode event carries the request); local_stats()
        ["decode_profile"] then holds the step's host clock, its device busy
        time and its device ops' times by name."""
        self._profile_next = True

    def _profile_start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _profile_finish(self, prof, host_ms: float, horizon: int) -> Dict:
        """A step's device busy time: the device's own rows (kernels, copies,
        sets) summed; the host rows carry their kernels' time too and are
        left out, or it would count twice."""
        from torch.autograd import DeviceType

        prof.__exit__(None, None, None)
        rows = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU:
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((e.key, us / 1e3 / horizon, e.count // horizon))
        rows.sort(key=lambda r: -r[1])
        return {"host_ms": host_ms / horizon, "busy_ms": sum(r[1] for r in rows),
                "device_ops": sum(r[2] for r in rows), "rows": rows}

    def _dev_verify(self, toks, positions, lens, window: int, table=None):
        """One verify of host-drafted candidates toks [S, C] and their
        acceptance, fetched with one copy; returns host arrays (tokens
        [S, C], logprobs [S, C], accepted [S]). Paged mode: `table`, the
        controller's page table [S, P]. A follower rank runs the same step
        on its blocks and draws the acceptance's random numbers, so that its
        sampler stays in step with the controller's; the controller's
        acceptance is the one served."""
        dev = self.device
        toks_t = torch.from_numpy(toks).to(dev)
        pos_t = torch.from_numpy(np.asarray(positions, np.int32)).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        if table is None:
            logits, _ = llama.verify_step(self.params, self.p, toks_t, self.cache, pos_t, lens_t,
                                          window=window)
        else:
            logits, _ = llama.verify_step_paged(self.params, self.p, toks_t, self.cache,
                                                self._table(table), pos_t, lens_t, window=window)
        self.verify_calls += 1
        g, lp, acc = spec_accept(logits, toks_t, lens_t, self._sampling, self._generator)
        if not self._mh_ctrl:
            return None
        c = toks.shape[1]
        host = torch.cat([g.to(torch.float64), lp.to(torch.float64),
                          acc[:, None].to(torch.float64)], dim=1).cpu().numpy()
        return host[:, :c].astype(np.int64), host[:, c:2 * c], host[:, 2 * c].astype(np.int64)

    def _dev_spec_rounds(self, last, positions, k_cap, window: int, rounds: int):
        """`rounds` draft+verify+accept rounds back to back on the device
        (the JAX engine's spec_multi_fn): each round drafts from the history
        buffer (llama.draft_lookup), verifies C = k+1 candidates per slot and
        appends the committed run to the buffer. Nothing crosses to the host
        until all rounds are queued; one copy then returns host arrays
        (tokens [R, S, C], logprobs [R, S, C], accepted [R, S], drafted
        [R, S])."""
        gen = self.config.generation
        spec_k = int(gen.speculation_tokens)
        n = int(getattr(gen, "speculation_ngram", 3) or 3)
        c = spec_k + 1
        dev = self.device
        # C columns wider than max_seq_len (draft_lookup reads nothing past
        # seq_lens). A slot whose k_cap is 0 still moves one position a
        # round, past max_seq_len when it enters within rounds - 1 of it:
        # its appends clamp to the last column, as in the JAX engine.
        hist = torch.zeros((self.n_slots, self.max_seq_len + c), dtype=torch.int64, device=dev)
        hist[:, :self.max_seq_len] = torch.from_numpy(self._hist_np).to(dev)
        last = torch.from_numpy(last).to(dev)
        pos = torch.from_numpy(np.asarray(positions, np.int64)).to(dev)
        k_cap = torch.from_numpy(k_cap).to(dev)
        rows = torch.arange(self.n_slots, device=dev)[:, None]
        cols = torch.arange(c, device=dev)[None, :]
        rounds_out = []
        for _ in range(rounds):
            live = pos >= 0
            slen = torch.where(live, pos + 1, 0)
            drafts, k_eff = llama.draft_lookup(hist, slen, n, spec_k, k_cap)
            toks = torch.cat([last[:, None], drafts], dim=1)
            lens = torch.where(live, 1 + k_eff, 0)
            logits, _ = llama.verify_step(self.params, self.p, toks, self.cache, pos, lens,
                                          window=window)
            self.verify_calls += 1
            g, lp, acc = spec_accept(logits, toks, lens, self._sampling, self._generator)
            acc = torch.minimum(acc, k_eff)
            adv = torch.where(live, acc + 1, 0)
            last = torch.where(live, torch.gather(g, 1, acc[:, None])[:, 0], last)
            wr = (slen[:, None] + cols).clamp_(max=hist.shape[1] - 1)
            hist[rows, wr] = torch.where(cols < adv[:, None], g, hist[rows, wr])
            pos = torch.where(live, pos + adv, pos)
            rounds_out.append(torch.cat([g.to(torch.float64), lp.to(torch.float64),
                                         acc[:, None].to(torch.float64),
                                         k_eff[:, None].to(torch.float64)], dim=1))
        host = torch.stack(rounds_out).cpu().numpy()   # [R, S, 2C + 2]
        return (host[..., :c].astype(np.int64), host[..., c:2 * c],
                host[..., 2 * c].astype(np.int64), host[..., 2 * c + 1].astype(np.int64))

    # ------------------------------------------------------------------ scheduling
    def _admit(self, req: Request, slot: int) -> None:
        samp = (req.temperature, req.top_k, req.top_p, req.repetition_penalty, req.min_p)
        paged = None if self.ptm is None else self._admit_pages(slot, req.prompt_ids)
        self._publish(("admit", slot, list(req.prompt_ids), samp, paged))
        tok, lp0 = self._dev_admit(slot, req.prompt_ids, samp, paged)
        self.tokens_in += len(req.prompt_ids)
        self._emit(req, tok, lp0)
        st = _SlotState(request=req, next_pos=len(req.prompt_ids), generated=1,
                        last_token=tok)
        if self._retire_if_done(st):
            self._release(slot)
        else:
            self._slots[slot] = st

    def _advance_chunk(self) -> None:
        """One chunk of the in-flight long admission."""
        ch = self._chunking
        req, slot = ch["req"], ch["slot"]
        if req.aborted:
            req.finish_reason = "aborted"
            req.token_queue.put(None)
            req.done.set()
            self._chunking = None
            self._release(slot)
            return
        ids = req.prompt_ids
        c0 = ch["progress"]
        cs = self._chunk_size
        try:
            if self.ptm is None:
                n = min(cs, len(ids) - c0)
                window = self._bucket_len(min(c0 + cs, self.max_seq_len))
            else:
                if c0 == 0:
                    _, matched = self.ptm.admit_shared(slot, ids)
                    if matched > 0:  # matched pages already hold valid KV
                        ch["progress"] = c0 = matched
                n = min(cs, len(ids) - c0)
                self.ptm.ensure(slot, c0 + n)
                ps = self.ptm.page_size
                window = -(-min(c0 + cs, self.max_seq_len) // ps) * ps
            row = None if self.ptm is None else self.ptm.table[slot].copy()
            self._publish(("chunk", slot, list(ids[c0:c0 + n]), c0, n, window, row))
            logits = self._dev_chunk(slot, ids[c0:c0 + n], c0, n, window, row)
        except Exception as e:
            req.error = str(e)
            req.token_queue.put(None)
            req.done.set()
            self._chunking = None
            self._release(slot)
            return
        ch["progress"] = c0 + n
        if ch["progress"] < len(ids):
            return
        # prompt fully prefilled: sample the first generated token
        self._chunking = None
        samp = (req.temperature, req.top_k, req.top_p, req.repetition_penalty, req.min_p)
        self._publish(("chunk_final", slot, list(req.prompt_ids), samp))
        tok, lp0 = self._dev_first_sample(slot, req.prompt_ids, samp, logits)
        self.tokens_in += len(ids)
        self._emit(req, tok, lp0)
        st = _SlotState(request=req, next_pos=len(ids), generated=1, last_token=tok)
        if self._retire_if_done(st):
            self._release(slot)
        else:
            self._slots[slot] = st

    def _emit(self, req: Request, tok: int, logprob: Optional[float] = None) -> None:
        req.output_ids.append(tok)
        if logprob is not None:
            req.logprobs.append(logprob)
        req.token_queue.put(tok)
        self.tokens_out += 1

    def _retire_if_done(self, st: _SlotState) -> bool:
        req = st.request
        if req.aborted:
            req.finish_reason = "aborted"
        elif st.last_token == self.eos_token_id:
            req.finish_reason = "eos"
        elif st.last_token in (req.stop_token_ids or ()):
            req.finish_reason = "stop"
        elif st.generated >= req.max_new_tokens:
            req.finish_reason = "max_new_tokens"
        elif st.next_pos >= self.max_seq_len:
            req.finish_reason = "max_seq_len"
        else:
            return False
        req.token_queue.put(None)
        req.done.set()
        return True

    # ------------------------------------------------------------------ speculation
    def _propose_lookup(self, st: _SlotState, k: int, n: int) -> List[int]:
        """Prompt-lookup draft: match the sequence's trailing n-gram against
        its own history (prompt + generated) and propose the k tokens that
        followed the most recent earlier occurrence with a full k-token
        continuation, else the occurrence with the longest continuation (on
        repetitive text the latest match abuts the tail and would draft 0-1
        tokens)."""
        hist = st.request.prompt_ids + st.request.output_ids
        if len(hist) < n + 1 or k <= 0:
            return []
        arr = np.asarray(hist, np.int64)
        pat = arr[-n:]
        win = np.lib.stride_tricks.sliding_window_view(arr[:-1], n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if len(hits) == 0:
            return []
        avail = len(arr) - (hits + n)
        full = hits[avail >= k]
        j = int(full[-1]) if len(full) else int(hits[np.argmax(avail)])
        return [int(t) for t in arr[j + n:j + n + k]]

    def _sync_slot_history(self, i: int, st: _SlotState) -> None:
        """Bring the slot's row of the history buffer up to date, in O(new
        tokens)."""
        if self._hist_np is None:
            self._hist_np = np.zeros((self.n_slots, self.max_seq_len), np.int64)
        req = st.request
        p_len = len(req.prompt_ids)
        total = min(p_len + len(req.output_ids), self.max_seq_len)
        row = self._hist_np[i]
        if st.hist_synced == 0:
            row[:total] = (req.prompt_ids + req.output_ids)[:total]
        elif total > st.hist_synced:
            row[st.hist_synced:total] = req.output_ids[st.hist_synced - p_len:total - p_len]
        st.hist_synced = total

    def _commit(self, i: int, st: _SlotState, run, lps, accepted: int) -> bool:
        """Emit a verify's run for slot i: `accepted` drafts, then the final
        token. Returns False when the slot retired inside the run (tokens
        past its EOS, stop id or budget are dropped; their cache rows are
        masked by position)."""
        for j in range(accepted + 1):
            st.next_pos += 1
            st.generated += 1
            st.last_token = int(run[j])
            if j < accepted:
                self.spec_accepted += 1  # counted as delivered
            self._emit(st.request, st.last_token, float(lps[j]))
            if self._retire_if_done(st):
                self._slots[i] = None
                self._release(i)
                return False
        return True

    def _spec_failed(self, e: Exception) -> bool:
        # a verify failure never takes down in-flight requests: the rows it
        # may have written lie past every slot's live position, so plain
        # decode goes on over an intact cache
        self._spec_disabled = True
        log.error("speculative verify failed; speculation is off for this engine's "
                  "lifetime, plain decode goes on: %s", e)
        return False

    def _spec_step(self, active, positions, spec_k: int) -> bool:
        """One speculative iteration; False when drafting is not worthwhile
        (the caller runs a plain decode step instead).

        Contiguous mode on one rank: speculation_rounds rounds on the device
        with device drafting (_dev_spec_rounds); paged mode and any mesh of
        more than one rank, whatever speculation_rounds: one host-drafted
        verify (_spec_step_single), as in the JAX engine."""
        if self.ptm is not None or self.mesh is not None:
            return self._spec_step_single(active, positions, spec_k)
        gen = self.config.generation
        rounds = max(1, int(getattr(gen, "speculation_rounds", 1) or 1))
        n = int(getattr(gen, "speculation_ngram", 3) or 3)
        # the gate: the trailing n-gram occurs earlier in the history
        match = {i: bool(self._propose_lookup(self._slots[i], 1, n)) for i in active}
        if not any(match.values()):
            return False
        # break-even guard: the expected accepted drafts per slot and round
        # (per-slot EMA) must clear speculation_min_gain; a probe every 16
        # refusals refreshes the EMAs
        min_gain = float(getattr(gen, "speculation_min_gain", 0.0) or 0.0)
        exp_gain = sum(min(self._slots[i].acc_ema, spec_k) for i in active if match[i]) \
            / len(active)
        if exp_gain < min_gain:
            self._spec_probe += 1
            if self._spec_probe % 16 != 0:
                return False
        k_cap = np.zeros((self.n_slots,), np.int64)
        for i in active:
            # a round advances at most k_cap + 1: even fully accepted runs
            # stay inside the sequence capacity. Not match-gated: the device
            # lookup re-matches every round as the history grows.
            room = (self.max_seq_len - 1 - self._slots[i].next_pos) // rounds - 1
            k_cap[i] = min(spec_k, max(0, room))
        if not k_cap.any():
            return False
        window = self._window(max(positions[i] for i in active) + rounds * (spec_k + 1) - 1)
        last = np.zeros((self.n_slots,), np.int64)
        for i in active:
            self._sync_slot_history(i, self._slots[i])
            last[i] = self._slots[i].last_token
        try:
            g, lps, acc, keff = self._dev_spec_rounds(last, positions, k_cap, window, rounds)
        except Exception as e:
            return self._spec_failed(e)
        self.steps += rounds
        self._horizon_last = 1
        live = {i: self._slots[i] for i in active}
        for r in range(rounds):
            for i in list(live):
                st = live[i]
                kr = int(keff[r, i])
                a = min(int(acc[r, i]), kr)
                self.spec_drafted += kr
                if kr > 0:
                    st.acc_ema = 0.7 * st.acc_ema + 0.3 * a
                if not self._commit(i, st, g[r, i], lps[r, i], a):
                    del live[i]
        return True

    def _spec_step_single(self, active, positions, spec_k: int) -> bool:
        """One host-drafted verify (paged mode: the page chains are grown to
        cover the drafts before the dispatch); False when no slot has a
        draft. Under a mesh the controller publishes the verify's inputs
        before its own dispatch and the followers run the same step;
        drafting, the acceptance and the commit stay here."""
        n = int(getattr(self.config.generation, "speculation_ngram", 3) or 3)
        c = spec_k + 1
        props: Dict[int, List[int]] = {}
        for i in active:
            room = self.max_seq_len - 1 - self._slots[i].next_pos - 1  # drafts past col 0
            props[i] = self._propose_lookup(self._slots[i], min(spec_k, max(0, room)), n)
        if not any(props.values()):
            return False
        toks = np.zeros((self.n_slots, c), np.int64)
        lens = np.zeros((self.n_slots,), np.int64)
        for i in active:
            row = [self._slots[i].last_token] + props[i]
            toks[i, :len(row)] = row
            lens[i] = len(row)
        last_pos = max(positions[i] for i in active) + c - 1
        table = None
        if self.ptm is not None:
            # page chains must cover every candidate; a slot the pool cannot
            # grow drops its drafts (one real token)
            for i in active:
                try:
                    self.ptm.ensure(i, self._slots[i].next_pos + int(lens[i]))
                except Exception:
                    toks[i, 1:] = 0
                    lens[i] = 1
                    props[i] = []
            if not any(props.values()):
                return False
            ps = self.ptm.page_size
            window = min(-(-(last_pos + 1) // ps) * ps, self.max_seq_len)
            table = self.ptm.table.copy()
        else:
            window = self._window(last_pos)
        if self.mesh is not None:
            self.verify_log.append((np.array(positions, np.int64), lens.copy()))
        try:
            self._publish(("verify", toks, positions, lens, window, table))
            g, lps, acc = self._dev_verify(toks, positions, lens, window, table)
        except Exception as e:
            return self._spec_failed(e)
        self.steps += 1
        self._horizon_last = 1
        for i in active:
            st, prop = self._slots[i], props[i]
            a = min(int(acc[i]), len(prop))
            self.spec_drafted += len(prop)
            self._commit(i, st, prop[:a] + [int(g[i, a])], lps[i], a)
        return True

    def _loop(self) -> None:
        try:
            self._loop_inner()
        except Exception as e:  # the scheduler must never die silently
            log.exception("generation loop crashed")
            self._fail_outstanding(f"generation loop crashed: {e}")
            self._running = False

    def _loop_inner(self) -> None:
        while self._running:
            # admit pending requests into free slots
            while True:
                slot = self._free_slot()
                if slot is None:
                    break
                try:
                    # block only when the whole batch is idle
                    idle = (not any(self._slots) and self._pending.empty()
                            and self._chunking is None)
                    req = self._pending.get(block=idle)
                except queue.Empty:
                    break
                if req is None:  # shutdown signal
                    return
                if (self._chunk_size > 0 and self._chunking is None
                        and len(req.prompt_ids) > self._chunk_size):
                    # long prompt: admit in chunks interleaved with decode steps
                    self._chunking = {"req": req, "slot": slot, "progress": 0}
                    break
                try:
                    self._admit(req, slot)
                except Exception as e:
                    req.error = str(e)
                    req.token_queue.put(None)
                    req.done.set()
                    self._release(slot)
                if self._pending.empty():
                    break

            # at most ONE prefill chunk between decode steps
            if self._chunking is not None:
                self._advance_chunk()

            for i, st in enumerate(self._slots):
                if st is not None and st.request.aborted and self._retire_if_done(st):
                    self._slots[i] = None
                    self._release(i)

            active = [i for i, s in enumerate(self._slots) if s is not None]
            if not active:
                continue

            tokens = np.zeros((self.n_slots,), np.int64)
            positions = np.full((self.n_slots,), -1, np.int32)
            for i in active:
                st = self._slots[i]
                tokens[i] = st.last_token
                positions[i] = st.next_pos
            if self.ptm is not None:
                # grow page chains for the token each active slot writes
                for i in list(active):
                    st = self._slots[i]
                    try:
                        self.ptm.ensure(i, st.next_pos + 1)
                    except Exception as e:
                        st.request.error = str(e)
                        st.request.finish_reason = "kv_pages_exhausted"
                        st.request.token_queue.put(None)
                        st.request.done.set()
                        self.ptm.release(i)
                        self._slots[i] = None
                        positions[i] = -1
                        active.remove(i)
                if not active:
                    continue
            # fused horizon: when nothing waits to be admitted, run up to
            # decode_horizon steps per host fetch, bounded by each slot's
            # remaining budget and the sequence capacity
            max_pos = int(max(positions[i] for i in active))
            horizon = 1
            gen = self.config.generation
            h_cfg = int(getattr(gen, "decode_horizon", 1) or 1)
            if h_cfg > 1 and self._pending.empty() and self._chunking is None \
                    and not any(self._slots[i].request.aborted for i in active):
                rem = min(self._slots[i].request.max_new_tokens - self._slots[i].generated
                          for i in active)
                cap = self.max_seq_len - 1 - max_pos
                horizon = max(1, min(h_cfg, rem, cap))
                tgt = float(getattr(gen, "target_burst_ms", 0.0) or 0.0)
                if tgt > 0 and self._tok_ms_ema is not None:
                    horizon = max(1, min(horizon, int(tgt / max(self._tok_ms_ema, 1e-6))))
                if horizon > 1:  # power-of-2 bucket, as the JAX engine
                    horizon = 1 << (horizon.bit_length() - 1)
            window = self._window(max_pos + horizon - 1)  # covers every live position
            if self.ptm is not None and horizon > 1:
                # page chains must cover every position the horizon writes
                for i in active:
                    try:
                        self.ptm.ensure(i, self._slots[i].next_pos + horizon)
                    except Exception:
                        horizon = 1
                        break
            # speculative decoding (prompt-lookup): when every active slot
            # is unpenalized and nothing waits to be admitted, verify drafts
            # instead of one decode step. The repetition penalty disables
            # it: its presence mask would have to evolve inside the
            # accepted run.
            # (off under pipeline_parallel, as in the JAX engine)
            spec_k = int(getattr(gen, "speculation_tokens", 0) or 0) if self._pp == 1 else 0
            if (spec_k > 0 and not self._spec_disabled and self._pending.empty()
                    and self._chunking is None
                    and all(self._slots[i].request.repetition_penalty == 1.0
                            and not self._slots[i].request.aborted for i in active)):
                if self._spec_step(active, positions, spec_k):
                    continue
            try:
                t_disp = time.monotonic()
                profile, self._profile_next = self._profile_next, False
                table = None if self.ptm is None else self.ptm.table.copy()
                self._publish(("decode", tokens, positions, window, horizon, profile, table))
                step_tokens, step_lps = self._dev_decode(tokens, positions, window, horizon,
                                                         profile, table)
                per_tok = (time.monotonic() - t_disp) * 1000.0 / step_tokens.shape[0]
                self._tok_ms_ema = per_tok if self._tok_ms_ema is None \
                    else 0.7 * self._tok_ms_ema + 0.3 * per_tok
                self._horizon_last = horizon
            except Exception as e:
                for i in active:
                    st = self._slots[i]
                    st.request.error = str(e)
                    st.request.token_queue.put(None)
                    st.request.done.set()
                    self._slots[i] = None
                    self._release(i)
                continue
            self.steps += step_tokens.shape[0]
            for h in range(step_tokens.shape[0]):
                for i in list(active):
                    st = self._slots[i]
                    if st is None:
                        continue
                    st.next_pos += 1
                    st.generated += 1
                    st.last_token = int(step_tokens[h, i])
                    self._emit(st.request, st.last_token, float(step_lps[h, i]))
                    if self._retire_if_done(st):
                        # tokens produced past EOS/limit are discarded; the
                        # slot's cache tail is masked by position on reads
                        self._slots[i] = None
                        active.remove(i)
                        self._release(i)
