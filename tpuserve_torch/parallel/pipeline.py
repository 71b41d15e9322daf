"""Pipeline parallelism: transformer layers staged over a "pp" mesh axis
(PyTorch port of tpuserve/parallel/pipeline.py).

Layer weights stack into [n_layers, ...] leaves (`stacked_layers/` keys,
QTensor layers as QExperts stacks) whose leading dim is cut over "pp": a
stage holds n_layers/pp contiguous layers, which is what pp buys a server,
capacity beyond one card. Within a stage the layer weights may also be cut
over "tp" (Megatron split: column-parallel wqkv and w_gateup, regrouped
rank-major at stack time by `_tp_shuffle_cols` so that a rank's columns are
its local fused weight; row-parallel wo and w_down with one psum each);
whole pipelines replicate over "dp" (slots cut, weights replicated); a
stage's KV length may be cut over "sp" (flash-decoding merge). The shared
params (embed, final norm, lm_head) sit whole on every stage.

Every rank is a process holding its stage block (`place_pipeline_params`,
or `StageBlock` cutting each parameter as it is drawn) and its block of the
5D stage cache ([n_layers/pp, S/dp, L/sp, Hkv/tp, hd], `shard_cache_pp`) or
of the 5D page pool ([n_layers/pp, n_pages, ps, Hkv, hd], pp-only meshes).
`pp_decode_step` and `pp_prefill` (and the paged pair) are plain functions
of those blocks, the JAX shard_map island's body with its collectives
through the rank's Mesh:

- decode follows the microbatch rotation: the rank's dp slots split into pp
  microbatches of mb rows; at tick t (2*pp - 1 ticks) stage s runs
  microbatch t - s and the activations rotate to stage s + 1 (`ppermute`);
  the last stage banks the finished rows, one [S, D] psum over pp puts them
  on every stage, and the replicated lm_head finishes there;
- prefill pushes the prompt through as one microbatch (stage t at tick t).

Where the JAX island computes every tick on every stage (the fill and
drain ticks on garbage whose cache writes are masked), a rank here skips
its idle ticks' compute, which the host knows, and still joins every
tick's rotation; it also leaves out the last tick's rotation, whose result
no stage reads. So a rank launches the quant-matmul pp * (n_layers/pp) * 4
+ 1 = 4 * n_layers + 1 times a decode step (fused weights: wqkv, wo,
w_gateup, w_down a layer a microbatch, and the lm_head), at its stage's
shard widths. The island's attention reads the 5D cache with the einsum
path (`llama._attend_window`), as the JAX island's XLA path does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from tpuserve_torch.models.layers import rms_norm
from tpuserve_torch.models.llama import (KVCache, LlamaParams, _attend_window,
                                         _attention_prefill, _forward_block, _kv_rows,
                                         _mm_w, _write_pages, _write_slot_kv,
                                         apply_rope, rope_cos_sin)
from tpuserve_torch.parallel import sharding
from tpuserve_torch.parallel.mesh import Mesh
from tpuserve_torch.quant.core import QExperts, QTensor, true_div

_STACK = "stacked_layers/"  # param-dict prefix for [n_layers, ...] stacks

_COL_SFX = ("wq/kernel", "wk/kernel", "wv/kernel", "wqkv/kernel",
            "w_gate/kernel", "w_up/kernel", "w_gateup/kernel")
_ROW_SFX = ("wo/kernel", "w_down/kernel")

# inside a stage the model functions see no mesh (_forward_block would
# gather the column shards otherwise): the stage owns its collectives
_ISLAND = Mesh(1, 1, 1, 0)


def _fused_segments(sfx: str, p: LlamaParams):
    """Column segment widths of a fused weight (None = not fused)."""
    if sfx.endswith("wqkv/kernel"):
        qd = p.n_heads * p.head_dim
        kvd = p.n_kv_heads * p.head_dim
        return [qd, kvd, kvd]
    if sfx.endswith("w_gateup/kernel"):
        return [p.ffn_dim, p.ffn_dim]
    return None


def _tp_perm(segs: List[int], tp: int) -> List[int]:
    """Segment-major [s0 | s1 | ...] -> rank-major [s0_r0|s1_r0|...|s0_r1|...]."""
    perm, off = [], 0
    offs = []
    for w in segs:
        offs.append(off)
        off += w
    for r in range(tp):
        for o, w in zip(offs, segs):
            if w % tp != 0:
                raise ValueError(f"fused segment width {w} must divide tensor_parallel {tp}")
            wl = w // tp
            perm.extend(range(o + r * wl, o + (r + 1) * wl))
    return perm


def _tp_shuffle_cols(leaf, segs, tp: int):
    """Reorder the last axis of a (stacked) weight from segment-major to
    rank-major, so that a plain split of the last axis over tp hands rank r
    exactly its heads' / columns' fused slice. Scales permute alike (per
    output column)."""
    idx = torch.tensor(_tp_perm(segs, tp), dtype=torch.long)
    if isinstance(leaf, (QTensor, QExperts)):
        return dataclasses.replace(leaf, q=leaf.q[..., idx.to(leaf.q.device)],
                                   scale=leaf.scale[..., idx.to(leaf.scale.device)])
    return leaf[..., idx.to(leaf.device)]


def _split_name(name: str) -> Optional[Tuple[int, str]]:
    """"layers.<l>/<sfx>" -> (l, sfx); None for a shared param."""
    if not name.startswith("layers."):
        return None
    head, sfx = name.split("/", 1)
    return int(head[len("layers."):]), sfx


def _stack_leaf(leaves, n_layers: int):
    first = leaves[0]
    if isinstance(first, QExperts):
        # a layer stack of [E, K, N] expert stacks: a QExperts of 4-D arrays
        return QExperts(q=torch.stack([t.q for t in leaves]),
                        scale=torch.stack([t.scale for t in leaves]),
                        bits=first.bits, group_size=first.group_size,
                        orig_shape=(n_layers,) + tuple(first.orig_shape),
                        act_bits=first.act_bits, act_fp8=first.act_fp8)
    if isinstance(first, QTensor):
        return QExperts(q=torch.stack([t.q for t in leaves]),
                        scale=torch.stack([t.scale for t in leaves]),
                        bits=first.bits, group_size=first.group_size,
                        orig_shape=(n_layers,) + tuple(first.orig_shape),
                        act_bits=first.act_bits, act_fp8=first.act_fp8)
    return torch.stack(leaves)


def stack_layer_params(params: Dict, p: LlamaParams, tp: int = 1) -> Dict:
    """Flat param dict with per-layer leaves -> one dict holding [n_layers,
    ...] stacks (prefix `stacked_layers/`) plus the shared params
    unchanged. QTensor layers stack into QExperts (a layer stack is a stack
    of 2-D quantized weights, the container expert stacks use); under tp
    the fused weights' columns are regrouped rank-major."""
    out = {k: v for k, v in params.items() if _split_name(k) is None}
    suffixes = sorted({_split_name(k)[1] for k in params if _split_name(k) is not None})
    for sfx in suffixes:
        stacked = _stack_leaf([params[f"layers.{l}/{sfx}"] for l in range(p.n_layers)],
                              p.n_layers)
        if tp > 1:
            segs = _fused_segments(sfx, p)
            if segs is not None:
                stacked = _tp_shuffle_cols(stacked, segs, tp)
        out[_STACK + sfx] = stacked
    return out


def _layer_view(params: Dict, l: int) -> Dict:
    """Name-keyed view of ONE layer's weights sliced from the stacks,
    shaped like an ordinary per-layer param dict (prefix "L")."""
    view = {}
    for k, v in params.items():
        if not k.startswith(_STACK):
            continue
        sfx = k[len(_STACK):]
        if isinstance(v, QExperts) and v.q.dim() == 4:
            # a layer stack of expert stacks (pp x MoE): slice the layer
            # dim, leaving an ordinary [E, ...] QExperts for _moe_ffn
            view[f"L/{sfx}"] = dataclasses.replace(v, q=v.q[l], scale=v.scale[l],
                                                   orig_shape=tuple(v.orig_shape[1:]))
        elif isinstance(v, QExperts):
            view[f"L/{sfx}"] = v.expert(l)
        else:
            view[f"L/{sfx}"] = v[l]
    return view


def _stack_tp_axes(sfx: str, tp: int) -> Tuple[Optional[str], Optional[str]]:
    """(weight-dim-1 axis, weight-dim-2 axis) of a [L, K, N] stack under tp.
    Column weights cut N; row weights cut K (psum inside the stage)."""
    if tp <= 1:
        return None, None
    if any(sfx.endswith(s) for s in _COL_SFX):
        return None, "tp"
    if any(sfx.endswith(s) for s in _ROW_SFX):
        return "tp", None
    return None, None


def _local_params(p: LlamaParams, tp: int) -> LlamaParams:
    """Per-tp-shard view of the model dims: each shard owns H/tp query
    heads, Hkv/tp kv heads and F/tp ffn columns."""
    if tp <= 1:
        return p
    return dataclasses.replace(p, n_heads=p.n_heads // tp, n_kv_heads=p.n_kv_heads // tp,
                               ffn_dim=p.ffn_dim // tp)


def _leaf_specs(sfx: str, v, tp: int):
    """Specs of a stacked leaf: the dim-0 "pp" cut and the Megatron tp cut
    (a QTensor stack: a QExperts of specs). Scales [L, G, N] track the
    weight, except that G == 1 replicates across row shards, and a G that
    does not divide tp has no clean local dequantization (refused, as in
    the JAX package)."""
    ax1, ax2 = _stack_tp_axes(sfx, tp)
    if isinstance(v, QExperts):
        pad = (None,) * (v.q.dim() - 3)
        s_ax1 = ax1
        if ax1 is not None:
            g = v.scale.shape[1]
            if g == 1:
                s_ax1 = None
            elif g % tp != 0:
                raise ValueError(f"{sfx}: scale groups {g} must divide tp {tp} "
                                 "(or use group_size spanning the shard)")
        return dataclasses.replace(v, q=("pp", ax1) + pad + (ax2,),
                                   scale=("pp", s_ax1) + (None,) * (v.scale.dim() - 3) + (ax2,))
    if v.dim() >= 3:
        return ("pp", ax1) + (None,) * (v.dim() - 3) + (ax2,)
    return ("pp",) + (None,) * (v.dim() - 1)


def pipeline_pspecs(params: Dict, tp: int = 1) -> Dict:
    """Spec of every leaf of a stacked param dict: stacks cut dim 0 over
    "pp" (and their weight dims over "tp" per the Megatron split when tp >
    1); shared params (norms, embed, lm_head) replicate."""
    specs = {}
    for k, v in params.items():
        if k.startswith(_STACK):
            specs[k] = _leaf_specs(k[len(_STACK):], v, tp)
        else:
            specs[k] = dataclasses.replace(v, q=(), scale=()) \
                if isinstance(v, (QTensor, QExperts)) else ()
    return specs


def _local_stack(v, spec, mesh):
    """This rank's block of one stacked leaf; a QExperts stack's orig_shape
    is its local one."""
    if isinstance(v, QExperts):
        q = sharding.shard_block(v.q, spec.q, mesh)
        scale = sharding.shard_block(v.scale, spec.scale, mesh)
        k = q.shape[-2] * (2 if v.bits == 4 else 1)
        shape = tuple(q.shape[:-2]) + (k, q.shape[-1])
        return dataclasses.replace(v, q=q, scale=scale, orig_shape=shape)
    return sharding.shard_block(v, spec, mesh)


def place_pipeline_params(params: Dict, mesh) -> Dict:
    """This rank's block of a stacked param dict (the JAX
    place_pipeline_params' shard on the rank's device): its n_layers/pp
    layers, each cut over tp, and the shared params whole."""
    specs = pipeline_pspecs(params, tp=mesh.shape["tp"])
    return {k: _local_stack(v, specs[k], mesh) if k.startswith(_STACK) else v
            for k, v in params.items()}


class StageBlock:
    """Builds a rank's stage block as the parameters are drawn or loaded:
    `keep(name, value)` (the engine's hook) keeps a shared param whole,
    drops a layer of another stage and writes a layer of this stage, cut
    over tp, into its slot of a preallocated stack, so that the rank never
    holds more than its block and one whole parameter; `finish(kept)`
    returns the block."""

    def __init__(self, p: LlamaParams, mesh, device=None):
        self.p, self.mesh, self.device = p, mesh, device
        self.lp = p.n_layers // mesh.shape["pp"]
        self.first = mesh.coords["pp"] * self.lp
        self.stacks: Dict[str, object] = {}

    def keep(self, name: str, val):
        split = _split_name(name)
        if split is None:
            return val if self.device is None else _to(val, self.device)
        l, sfx = split
        if not self.first <= l < self.first + self.lp:
            return None
        tp = self.mesh.shape["tp"]
        segs = _fused_segments(sfx, self.p) if tp > 1 else None
        if segs is not None:
            val = _tp_shuffle_cols(val, segs, tp)
        one = _stack_leaf([val], 1)
        spec = _leaf_specs(sfx, one, tp)   # this one layer: no cut over pp
        if isinstance(spec, QExperts):
            spec = dataclasses.replace(spec, q=(None,) + spec.q[1:],
                                       scale=(None,) + spec.scale[1:])
        else:
            spec = (None,) + spec[1:]
        blk = _local_stack(one, spec, self.mesh)
        if self.device is not None:
            blk = _to(blk, self.device)
        key = _STACK + sfx
        if key not in self.stacks:
            self.stacks[key] = _empty_stack(blk, self.lp)
        _put_layer(self.stacks[key], blk, l - self.first)
        return None

    def finish(self, kept: Dict) -> Dict:
        out = {k: v for k, v in kept.items() if v is not None}
        out.update(self.stacks)
        return out


def _to(val, device):
    return val.to(device) if isinstance(val, (QTensor, QExperts, torch.Tensor)) else val


def _empty_stack(one, lp: int):
    if isinstance(one, QExperts):
        return dataclasses.replace(
            one, q=one.q.new_empty((lp,) + tuple(one.q.shape[1:])),
            scale=one.scale.new_empty((lp,) + tuple(one.scale.shape[1:])),
            orig_shape=(lp,) + tuple(one.orig_shape[1:]))
    return one.new_empty((lp,) + tuple(one.shape[1:]))


def _put_layer(stack, one, i: int) -> None:
    if isinstance(stack, QExperts):
        stack.q[i].copy_(one.q[0])
        stack.scale[i].copy_(one.scale[0])
    else:
        stack[i].copy_(one[0])


def _split_params(params: Dict):
    stacks = {k: v for k, v in params.items() if k.startswith(_STACK)}
    shared = {k: v for k, v in params.items() if not k.startswith(_STACK)}
    return stacks, shared


# ------------------------------------------------------------ stage matmul
def _island_mm(mesh):
    """The stage's matmul: a QTensor layer through the quant-matmul kernel
    on the rank's local block (`sharding.qmatmul_local`, counted at its
    local K x N), its orig_shape and group_size rebuilt from the local
    arrays; a dense one as llama._mm_w. Row-sharded contractions (wo,
    w_down) psum their partials over tp."""
    tp = mesh.shape["tp"]

    def mm(view: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
        w = view[name]
        if isinstance(w, QTensor):
            k = w.q.shape[0] * (2 if w.bits == 4 else 1)
            gs = 0 if w.scale.shape[0] == 1 else w.group_size
            w = dataclasses.replace(w, orig_shape=(k, w.q.shape[1]), group_size=gs)
            # the block is a whole QTensor of its own (its scales are local)
            out = sharding.qmatmul_local(x, w, name, 0, 1)
        else:
            out = _mm_w(x, w)
        if tp > 1 and any(name.endswith(s) for s in _ROW_SFX):
            out = mesh.psum(out, "tp")
        return out

    return mm


def _logits_shared(shared: Dict, x: torch.Tensor, p: LlamaParams) -> torch.Tensor:
    """Final norm and the replicated lm_head (whole on every stage)."""
    h = rms_norm(shared, "final_norm", x, p.rms_eps)
    if p.tie_embeddings:
        w = shared["embed/weight"]
        return torch.matmul(h.to(torch.float32), w.to(h.dtype).to(torch.float32).t())
    w = shared["lm_head/kernel"]
    if isinstance(w, QTensor):
        return sharding.qmatmul_local(h, w, "lm_head/kernel", 0, 1).to(torch.float32)
    return _mm_w(h, w).to(torch.float32)


# --------------------------------------------------------- 5D stage caches
def _cache_specs(cache, tp: int = 1, dp: int = 1, sp: int = 1) -> Tuple:
    """(k/v spec, scale spec) of a stage cache: [lp, S, L, Hkv, hd] (flat:
    [lp, S, L, W]) with lp over pp, slots over dp, L over sp, heads over
    tp; head-major scales [lp, S, Hkv, L] alike (None for a float cache)."""
    h_ax = "tp" if tp > 1 else None
    d_ax = "dp" if dp > 1 else None
    l_ax = "sp" if sp > 1 else None
    if cache.k.dim() == 5:
        kv = ("pp", d_ax, l_ax, h_ax, None)
    else:
        kv = ("pp", d_ax, l_ax, h_ax)
    sc = ("pp", d_ax, h_ax, l_ax) if cache.quantized else None
    return kv, sc


def shard_cache_pp(cache: KVCache, mesh) -> KVCache:
    """This rank's block of a whole stage-cut cache: its stage's layers,
    its dp slots, its L window under sp and its kv heads under tp."""
    kv, sc = _cache_specs(cache, mesh.shape["tp"], mesh.shape["dp"], mesh.shape["sp"])
    cut = (lambda t, spec: None if t is None else sharding.shard_block(t, spec, mesh))
    return KVCache(k=cut(cache.k, kv), v=cut(cache.v, kv),
                   k_scale=cut(cache.k_scale, sc), v_scale=cut(cache.v_scale, sc))


def stage_cache(p: LlamaParams, mesh, n_slots: int, max_len: int, quantized: bool,
                dtype=torch.bfloat16, scale_dtype=torch.float32, device="cuda") -> KVCache:
    """A rank's 5D stage cache, made at its block's size: [n_layers/pp,
    S/dp, L/sp, Hkv/tp, hd] (scales [.., Hkv/tp, L/sp])."""
    pl = dataclasses.replace(_local_params(p, mesh.shape["tp"]),
                             n_layers=p.n_layers // mesh.shape["pp"])
    return KVCache.create(pl, n_slots // mesh.shape["dp"], max_len // mesh.shape["sp"],
                          quantized=quantized, dtype=dtype, scale_dtype=scale_dtype,
                          device=device, flat=False)


def _gqa_decode_attention_sp(q, k_l, v_l, k_scale, v_scale, posc, p_loc: LlamaParams,
                             mesh) -> torch.Tensor:
    """sp-sharded decode attention inside a stage: k_l/v_l [mb, L/sp, Hkv,
    hd] hold this shard's slice of the window (global position sp_idx *
    L/sp + i), scales [mb, Hkv, L/sp] or None, q [mb, H, hd] post-RoPE,
    posc [mb] the clamped global positions. Each shard keeps the softmax
    partials of its slice and the flash-decoding merge (one pmax and two
    psums over "sp") combines them, as the JAX island's. Fully masked
    shards weigh e^(m - m_global) = 0. Returns [mb, H*hd] f32."""
    s, hd = q.shape[0], p_loc.head_dim
    lloc, hkv = k_l.shape[1], p_loc.n_kv_heads
    qg = q.reshape(s, hkv, p_loc.n_heads // hkv, hd)
    cdt = torch.float32 if k_l.dtype == torch.float32 else torch.bfloat16
    scores = torch.einsum("shrd,slhd->shrl", qg.to(cdt).to(torch.float32),
                          k_l.to(cdt).to(torch.float32))
    if k_scale is not None:
        scores = scores * k_scale.to(torch.float32)[:, :, None, :]
    scores = true_div(scores, hd ** 0.5)
    ar = mesh.coords["sp"] * lloc + torch.arange(lloc, device=q.device)
    read = ar[None, :] <= posc[:, None]
    scores = torch.where(read[:, None, None, :], scores, -1e30)
    m = scores.amax(dim=-1)
    probs = torch.exp(scores - m[..., None])
    ssum = probs.sum(dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.to(torch.float32)[:, :, None, :]
    o = torch.einsum("shrl,slhd->shrd", probs.to(cdt).to(torch.float32),
                     v_l.to(cdt).to(torch.float32))
    w = torch.exp(m - mesh.pmax(m, "sp"))
    o = mesh.psum(o * w[..., None], "sp")
    ssum = mesh.psum(ssum * w, "sp")
    return (o / torch.clamp_min(ssum, 1e-20)[..., None]).reshape(s, -1)


def _mesh_sizes(mesh):
    return tuple(mesh.shape[a] for a in ("pp", "tp", "dp", "sp"))


def _rotate(mesh, x, t: int, last: int):
    """The rotation after tick t (all but the last: no stage reads it)."""
    return mesh.ppermute(x, "pp") if t < last else x


def _bank(mesh, xs_final: torch.Tensor, stage: int, pp: int) -> torch.Tensor:
    """One psum over pp of the last stage's banked rows (zeros elsewhere)."""
    if stage != pp - 1:
        xs_final = torch.zeros_like(xs_final)
    return mesh.psum(xs_final, "pp")


def _rows_of(pos_host: torch.Tensor, row0: int, mb: int, cond=None):
    """Local indices of the microbatch's rows to write (host; moved by the
    caller)."""
    act = pos_host[row0:row0 + mb] >= 0
    if cond is not None:
        act = act & cond
    return torch.nonzero(act).flatten()


def pp_decode_step(params: Dict, p: LlamaParams, tokens: torch.Tensor, cache: KVCache,
                   positions: torch.Tensor, mesh, window: Optional[int] = None):
    """One continuous-batching decode step through the layer pipeline, on
    this rank: llama.decode_step's contract (tokens [S], positions [S], -1 =
    inactive; returns (logits [S, V] f32, cache)) with `params` the rank's
    stage block and `cache` its 5D stage cache. S must divide by pp * dp.
    Under sp each shard reads its whole L window (the merge handles
    liveness), as in the JAX package."""
    with sharding.use_mesh(_ISLAND):
        return _pp_decode(params, p, tokens, cache, positions, mesh, window, None)


def pp_decode_step_paged(params: Dict, p: LlamaParams, tokens: torch.Tensor, cache,
                         page_table: torch.Tensor, positions: torch.Tensor, mesh,
                         window: Optional[int] = None):
    """One decode step through the layer pipeline over the rank's block of
    a 5D PagedKVCache ([n_layers/pp, n_pages, ps, Hkv, hd], head-major
    scale pool [n_layers/pp, n_pages, pad8(Hkv), ps]): llama.
    decode_step_paged's contract (page_table [S, P]; the engine grows each
    active slot's chain first) with pp_decode_step's rotation; a stage
    writes and reads only its own layers' pages. pp-only meshes (v1)."""
    with sharding.use_mesh(_ISLAND):
        return _pp_decode(params, p, tokens, cache, positions, mesh, window, page_table)


def _pp_decode(params, p, tokens, cache, positions, mesh, window, page_table):
    pp, tp, dp, sp = _mesh_sizes(mesh)
    stage = mesh.coords["pp"]
    p_loc = _local_params(p, tp)
    lp = p.n_layers // pp
    dev = cache.k.device
    stacks, shared = _split_params(params)
    tokens = tokens.to(dev)
    positions = positions.to(device=dev, dtype=torch.int32)
    s_loc = tokens.shape[0] // dp
    mb = s_loc // pp
    lo = mesh.coords["dp"] * s_loc
    toks, pos = tokens[lo:lo + s_loc], positions[lo:lo + s_loc]
    pos_host = pos.cpu()   # which rows each microbatch writes (one sync)
    mm = _island_mm(mesh)
    dtype = shared["embed/weight"].dtype
    x = torch.zeros((mb, p.dim), dtype=dtype, device=dev)
    xs_final = torch.zeros((s_loc, p.dim), dtype=dtype, device=dev)
    paged = page_table is not None
    if paged:
        ps = cache.page_size
        table = page_table.to(device=dev, dtype=torch.long)[lo:lo + s_loc]
        if window is not None:
            table = table[:, :max(1, min(int(window) // ps, table.shape[1]))]
        win = table.shape[1] * ps
    else:
        l_loc = cache.max_len
        win = l_loc if window is None or sp > 1 else min(int(window), l_loc)
    last = 2 * pp - 2
    for t in range(2 * pp - 1):
        mb_idx = t - stage
        if 0 <= mb_idx < pp:
            if stage == 0:
                x = shared["embed/weight"][toks[t * mb:(t + 1) * mb]]
            row0 = mb_idx * mb
            if paged:
                x = _paged_microbatch(stacks, p, x, cache, table[row0:row0 + mb],
                                      pos[row0:row0 + mb], pos_host, row0, mb, lp, win, mm)
            else:
                x = _microbatch(stacks, p, p_loc, x, cache, pos, pos_host, row0, mb, lp, win,
                                mesh, mm)
            if stage == pp - 1:
                xs_final[row0:row0 + mb] = x
        x = _rotate(mesh, x, t, last)
    logits = _logits_shared(shared, _bank(mesh, xs_final, stage, pp), p)
    logits = torch.where(pos[:, None] >= 0, logits, 0.0)
    if dp > 1:
        logits = mesh.gather(logits, "dp", dim=0)
    return logits, cache


def _microbatch(stacks, p, p_loc, x, cache, pos, pos_host, row0, mb, lp, win, mesh, mm):
    """The stage's layers over one microbatch of rows [row0, row0 + mb) of
    the contiguous 5D stage cache."""
    sp = mesh.shape["sp"]
    dev = x.device
    pos_mb = pos[row0:row0 + mb]
    posc = pos_mb.clamp_min(0)
    cos, sin = rope_cos_sin(posc, p.head_dim, p.rope_theta)
    cos_q, sin_q = cos[:, None, :], sin[:, None, :]
    l_loc = cache.max_len
    if sp > 1:
        # writes land on the owner shard of the position only
        ph = pos_host[row0:row0 + mb].clamp_min(0)
        ia_h = _rows_of(pos_host, row0, mb, (ph // l_loc) == mesh.coords["sp"])
        col = (ph[ia_h] % l_loc).to(dev)
    else:
        ia_h = _rows_of(pos_host, row0, mb)
        col = pos_host[row0:row0 + mb].clamp_min(0)[ia_h].to(dev)
    ia = ia_h.to(dev)
    rows = row0 + ia
    read_mask = torch.arange(win, device=dev)[None, :] <= posc[:, None]
    k_rows, v_rows = cache.rows(cache.k), cache.rows(cache.v)
    for ll in range(lp):
        def attn_fn(q, k, v, ll=ll):
            q = apply_rope(q.reshape(mb, p_loc.n_heads, p.head_dim), cos_q, sin_q)
            k = apply_rope(k.reshape(mb, p_loc.n_kv_heads, p.head_dim), cos_q, sin_q)
            v = v.reshape(mb, p_loc.n_kv_heads, p.head_dim)
            kq, vq, ks, vs = _kv_rows(cache, k, v)
            k_rows[ll][rows, col] = kq[ia]
            v_rows[ll][rows, col] = vq[ia]
            if ks is not None:
                cache.k_scale[ll][rows, :, col] = ks[ia].to(cache.k_scale.dtype)
                cache.v_scale[ll][rows, :, col] = vs[ia].to(cache.v_scale.dtype)
            sl = slice(row0, row0 + mb)
            if sp > 1:
                out = _gqa_decode_attention_sp(
                    q, cache.k[ll, sl], cache.v[ll, sl],
                    cache.k_scale[ll, sl] if cache.quantized else None,
                    cache.v_scale[ll, sl] if cache.quantized else None, posc, p_loc, mesh)
            else:
                ks_w = vs_w = None
                if cache.quantized:
                    ks_w, vs_w = cache.k_scale[ll, sl, :, :win], cache.v_scale[ll, sl, :, :win]
                out = _attend_window(q[:, None], k_rows[ll, sl, :win], v_rows[ll, sl, :win],
                                     ks_w, vs_w, read_mask[:, None], p_loc)
            return out.to(x.dtype).reshape(mb, -1)

        x = _forward_block(_layer_view(stacks, ll), "L", x, p_loc, attn_fn, mm=mm)
    return x


def _paged_microbatch(stacks, p, x, cache, table_mb, pos_mb, pos_host, row0, mb, lp, win, mm):
    """The stage's layers over one microbatch through its page-table rows
    (pp-only meshes): writes at the physical (page, offset) of each active
    row, attention over the gathered window of its pages."""
    dev = x.device
    ps = cache.page_size
    posc = pos_mb.clamp_min(0)
    cos, sin = rope_cos_sin(posc, p.head_dim, p.rope_theta)
    cos_q, sin_q = cos[:, None, :], sin[:, None, :]
    ia = _rows_of(pos_host, row0, mb).to(dev)
    pa = posc[ia].long()
    wpages, woffs = table_mb[ia, pa // ps], pa % ps
    read_mask = torch.arange(win, device=dev)[None, :] <= posc[:, None]
    hp = cache.k_scale.shape[2] if cache.quantized else 0

    def window_scales(pool, ll):  # [mb, n_cols, hp, ps] -> [mb, Hkv, win]
        return pool[ll][table_mb].permute(0, 2, 1, 3).reshape(mb, hp, win)[:, :p.n_kv_heads]

    for ll in range(lp):
        def attn_fn(q, k, v, ll=ll):
            q = apply_rope(q.reshape(mb, p.n_heads, p.head_dim), cos_q, sin_q)
            k = apply_rope(k.reshape(mb, p.n_kv_heads, p.head_dim), cos_q, sin_q)
            v = v.reshape(mb, p.n_kv_heads, p.head_dim)
            _write_pages(cache, ll, wpages, woffs, k[ia], v[ia])
            ks = vs = None
            if cache.quantized:
                ks, vs = window_scales(cache.k_scale, ll), window_scales(cache.v_scale, ll)
            out = _attend_window(q[:, None], cache.k[ll][table_mb].reshape(mb, win, -1),
                                 cache.v[ll][table_mb].reshape(mb, win, -1), ks, vs,
                                 read_mask[:, None], p)
            return out.to(x.dtype).reshape(mb, -1)

        x = _forward_block(_layer_view(stacks, ll), "L", x, p, attn_fn, mm=mm)
    return x


def pp_prefill(params: Dict, p: LlamaParams, tokens: torch.Tensor, cache: KVCache,
               slot: int, length: int, mesh):
    """Prompt prefill through the layer pipeline on this rank: llama.
    prefill's contract (tokens [1, C] right-padded, `length` real tokens;
    returns (logits [1, V] f32 at length - 1, cache)). One microbatch:
    stage t computes at tick t. Under dp only the dp group that owns `slot`
    runs it and the others add zeros to its logits; under sp each shard
    writes the rows of its L window."""
    with sharding.use_mesh(_ISLAND):
        return _pp_prefill(params, p, tokens, cache, int(slot), int(length), mesh, None)


def pp_prefill_paged(params: Dict, p: LlamaParams, tokens: torch.Tensor, cache,
                     page_table: torch.Tensor, slot: int, length: int, mesh):
    """Prompt prefill through the layer pipeline into the rank's block of a
    5D PagedKVCache: llama.prefill_paged's contract (the engine guarantees
    the slot's chain covers the bucket); each stage writes its own layers'
    pages."""
    with sharding.use_mesh(_ISLAND):
        return _pp_prefill(params, p, tokens, cache, int(slot), int(length), mesh, page_table)


def _pp_prefill(params, p, tokens, cache, slot, length, mesh, page_table):
    pp, tp, dp, sp = _mesh_sizes(mesh)
    stage = mesh.coords["pp"]
    p_loc = _local_params(p, tp)
    lp = p.n_layers // pp
    stacks, shared = _split_params(params)
    dev = cache.k.device
    tokens = tokens.to(dev)
    b, c = tokens.shape
    paged = page_table is not None
    local = slot
    if dp > 1:
        owner, local = divmod(slot, cache.n_slots)
        if owner != mesh.coords["dp"]:
            zeros = torch.zeros((b, p.vocab_size), dtype=torch.float32, device=dev)
            return mesh.psum(zeros, "dp"), cache
    positions = torch.arange(c, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    mask = positions[:, :, None] >= positions[:, None, :]
    if paged:
        row = page_table[slot].to(device=dev, dtype=torch.long)
        lpos = torch.arange(c, device=dev)
        pages, offsets = row[lpos // cache.page_size], lpos % cache.page_size
    l_off = mesh.coords["sp"] * cache.max_len if not paged else 0
    mm = _island_mm(mesh)
    dtype = shared["embed/weight"].dtype
    x = torch.zeros((b, c, p.dim), dtype=dtype, device=dev)
    x_last = torch.zeros((b, p.dim), dtype=dtype, device=dev)
    for t in range(pp):
        if stage == t:
            if t == 0:
                x = shared["embed/weight"][tokens]
            for ll in range(lp):
                def attn_fn(q, k, v, ll=ll):
                    q = apply_rope(q.reshape(b, c, p_loc.n_heads, p.head_dim), cos, sin)
                    k = apply_rope(k.reshape(b, c, p_loc.n_kv_heads, p.head_dim), cos, sin)
                    v = v.reshape(b, c, p_loc.n_kv_heads, p.head_dim)
                    if paged:
                        _write_pages(cache, ll, pages, offsets, k[0], v[0])
                    else:
                        _write_slot_kv(cache, ll, local, 0, k[0], v[0], l_off)
                    return _attention_prefill(q, k, v, mask).reshape(b, c, -1)

                x = _forward_block(_layer_view(stacks, ll), "L", x, p_loc, attn_fn, mm=mm)
            if t == pp - 1:
                x_last = x[:, length - 1, :]
        x = _rotate(mesh, x, t, pp - 1)
    logits = _logits_shared(shared, _bank(mesh, x_last, stage, pp), p)
    if dp > 1:
        logits = mesh.psum(logits, "dp")
    return logits, cache


# ---------------------------------------------------------------- pp x paged
# pp x paged (v1, as in the JAX package): pp-only meshes, the 5D pool layout
# the stages read, page tables host-global (every stage gets the whole
# table), no prefix sharing.
def shard_paged_cache_pp(cache, mesh):
    """This rank's block of a whole page pool: its stage's layers (dim 0
    over pp), every page."""
    from tpuserve_torch.serving.paged_kv import PagedKVCache

    kv = ("pp",) + (None,) * (cache.k.dim() - 1)
    sc = ("pp", None, None, None)
    cut = (lambda t, spec: None if t is None else sharding.shard_block(t, spec, mesh))
    return PagedKVCache(k=cut(cache.k, kv), v=cut(cache.v, kv),
                        k_scale=cut(cache.k_scale, sc), v_scale=cut(cache.v_scale, sc))
