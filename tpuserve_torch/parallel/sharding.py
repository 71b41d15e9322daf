"""Sharding rules and per-shard bodies of the Llama serving path (PyTorch port
of tpuserve/parallel/sharding.py).

The JAX package annotates global arrays with PartitionSpecs and runs the
Pallas kernels inside shard_map islands. Here every rank is a process that
holds only its own block of each parameter and cache, the block a JAX
NamedSharding puts on the device at the rank's mesh coordinates
(parallel/mesh.py), and runs the islands' bodies on it, with the islands'
collectives through its Mesh. The rules (mesh axes ("dp", "sp", "tp")):

- column-sharded (output dim over tp): wq, wk, wv, wqkv, w_gate, w_up,
  w_gateup, lm_head; row-sharded (input dim over tp): wo, w_down; the rest
  (norms, embed, router) replicated;
- QTensor scales [G, N] track their weight, except that dim 0 replicates
  when it cannot split over tp (per-channel G == 1, or G % tp != 0);
- stacked MoE experts [E, ...]: E over tp when it divides, else replicated;
- KV cache [n_layers, S, L, Hkv, hd] (flat: [.., W]): slots over dp, kv
  heads over tp where tp divides them (else every rank holds every head:
  the JAX package's GSPMD-only meshes, see `kv_replicated`), L over sp;
  scales [n_layers, S, Hkv, L] alike;
- paged pool [n_layers, n_pages, ps, W] (5D: [.., Hkv, hd]): kv heads over
  tp where tp divides them, replicated over dp (any slot's table may name
  any page); the scale pool [n_layers, n_pages, pad8(Hkv), ps] over tp only
  where its rows split into whole unpadded head groups (a 5D pool whose Hkv
  is a multiple of 8 and of tp), else replicated. Slots, tables and
  positions ride dp.

Each rank keeps its block as a tensor of its own, and a QTensor block's
orig_shape is its local [K, N]. Per-shard bodies are plain functions of the
local tensors (`qmatmul_local`, `moe_ffn_local`, `seq_partial`), so that
the tests can run every rank's body in one process and do the collective by
hand; the `*_sharded` forms add the collective through the Mesh.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from tpuserve_torch.quant.core import QExperts, QTensor, qmatmul, true_div

_COL = (
    "wq/kernel", "wk/kernel", "wv/kernel", "wqkv/kernel",
    "w_gate/kernel", "w_up/kernel", "w_gateup/kernel", "lm_head/kernel",
)
_ROW = ("wo/kernel", "w_down/kernel")

# kernel launches of the sharded bodies at their local shapes: name -> count;
# the quant-matmul's also by its rows of x ("quant_matmul MxKxN")
shard_launches: "collections.Counter[str]" = collections.Counter()
shard_launch_rows: "collections.Counter[str]" = collections.Counter()
# row shards whose scales straddle groups, run in plain torch on the rank's rows
plain_fallbacks = 0


def _spec_for(name: str) -> Tuple:
    if any(name.endswith(s) for s in _COL):
        return (None, "tp")
    if any(name.endswith(s) for s in _ROW):
        return ("tp", None)
    return ()  # norms, embed, biases: replicated


def _row_sharded(name: str) -> bool:
    return _spec_for(name)[:1] == ("tp",)


def _scale_spec(spec: Tuple, scale, tp: int = 1) -> Tuple:
    """Scales [G, N] track the weight's spec, except when dim 0 cannot be
    split over tp: per-channel scales (G == 1) and group counts not
    divisible by tp replicate dim 0 (qmatmul_local slices the rank's group)."""
    if len(spec) >= 1 and spec[0] is not None and (
            scale.shape[0] == 1 or (tp > 1 and scale.shape[0] % tp != 0)):
        return (None,) + tuple(spec[1:])
    return spec


def _expert_spec(val, tp: int) -> Tuple:
    """Stacked MoE experts [E, ...]: E over "tp" (each rank owns E/tp whole
    experts), replicated when E does not divide."""
    n_e = val.n_experts if isinstance(val, QExperts) else val.shape[0]
    if tp > 1 and n_e % tp == 0:
        return ("tp", None, None)
    return (None, None, None)


def _is_expert_stack(name: str, val) -> bool:
    if isinstance(val, QExperts):
        return True
    return getattr(val, "ndim", 0) == 3 and ("moe_" in name or "expert" in name)


def llama_param_pspecs(params: Dict, tp: int = 1) -> Dict[str, object]:
    """name -> spec tuple (or a QTensor / QExperts of specs)."""
    specs: Dict[str, object] = {}
    for name, val in params.items():
        if _is_expert_stack(name, val):
            espec = _expert_spec(val, tp)
            specs[name] = dataclasses.replace(val, q=espec, scale=espec) \
                if isinstance(val, QExperts) else espec
            continue
        spec = _spec_for(name)
        if isinstance(val, QTensor):
            specs[name] = dataclasses.replace(val, q=spec, scale=_scale_spec(spec, val.scale, tp))
        else:
            specs[name] = spec
    return specs


def shard_block(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The block of `t` a NamedSharding(spec) puts at this rank's mesh
    coordinates: each dim named by an axis cut into that axis's size, the
    rank's piece kept (a tensor of its own; t itself when nothing is cut)."""
    out = t
    for dim, axis in enumerate(spec):
        n = 1 if axis is None else mesh.shape[axis]
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not split over {axis}={n}")
        step = size // n
        out = out.narrow(dim, mesh.coords[axis] * step, step)
    # a copy even where the cut is contiguous (dim 0): a view would keep the
    # whole tensor's storage alive on the rank
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def _local_q(val, q_spec, sc_spec, mesh):
    q = shard_block(val.q, q_spec, mesh)
    scale = shard_block(val.scale, sc_spec, mesh)
    k = q.shape[-2] * (2 if val.bits == 4 else 1)
    shape = (q.shape[0], k, q.shape[-1]) if isinstance(val, QExperts) else (k, q.shape[-1])
    return dataclasses.replace(val, q=q, scale=scale, orig_shape=shape)


def shard_llama_params(params: Dict, mesh) -> Dict:
    """This rank's block of every parameter (every rank builds the same full
    weights, from one seed or checkpoint, and keeps its own)."""
    out = {}
    tp = mesh.shape["tp"]
    for name, val in params.items():
        if _is_expert_stack(name, val):
            espec = _expert_spec(val, tp)
            out[name] = _local_q(val, espec, espec, mesh) if isinstance(val, QExperts) \
                else shard_block(val, espec, mesh)
            continue
        spec = _spec_for(name)
        if isinstance(val, QTensor):
            out[name] = _local_q(val, spec, _scale_spec(spec, val.scale, tp), mesh)
        else:
            out[name] = shard_block(val, spec, mesh)
    return out


def kv_replicated(p, mesh) -> bool:
    """Whether every tp rank keeps every kv head: a tp that does not divide
    n_kv_heads (MQA or narrow GQA at a wide tp). The JAX package serves such
    a mesh through GSPMD: its cache replicates the head axis over tp
    (shard_cache) and attention takes the XLA einsum path."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    return tp > 1 and p.n_kv_heads % tp != 0


def local_llama_params(p, mesh):
    """The LlamaParams of one rank's K/V and cache: n_heads and n_kv_heads
    over tp (the kv-head groups split on head boundaries), or, where
    kv_replicated, every head (attention_heads names those it attends
    over)."""
    tp = mesh.shape["tp"] if mesh is not None else 1
    if kv_replicated(p, mesh):
        return p
    return dataclasses.replace(p, n_heads=p.n_heads // tp, n_kv_heads=p.n_kv_heads // tp)


def attention_heads(p, mesh) -> Tuple[slice, slice]:
    """Where kv_replicated, the heads a tp rank attends over and the columns
    it keeps: (kv heads [kv0, kv1), the kv groups whose query heads cover
    the rank's qd/tp rows of the row-sharded wo; those rows' columns of the
    groups' attention output [.., (kv1 - kv0) * rep * hd]). A wo shard may
    cut a head (n_heads % tp != 0) or hold part of one group. None where
    the rank's heads are its own whole kv groups."""
    if not kv_replicated(p, mesh):
        return None
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    width = p.n_heads * p.head_dim // tp
    group = p.n_heads // p.n_kv_heads * p.head_dim    # a kv group's output columns
    kv0, kv1 = r * width // group, -(-(r + 1) * width // group)
    col = r * width - kv0 * group
    return slice(kv0, kv1), slice(col, col + width)



def local_slots(mesh, n_slots: int) -> Tuple[int, int]:
    """[lo, hi) of the slots this rank's dp index owns."""
    dp = mesh.shape["dp"]
    per = n_slots // dp
    lo = mesh.coords["dp"] * per
    return lo, lo + per


def block_fingerprint(params: Dict) -> int:
    """A checksum of a rank's blocks: each tensor's bytes summed, weighted by
    the tensor's place in name order. A rank's blocks and the same cut made
    in another process agree; random weights cut otherwise almost surely do
    not."""
    total = 0
    for i, name in enumerate(sorted(params)):
        val = params[name]
        for t in (val.q, val.scale) if isinstance(val, (QTensor, QExperts)) else (val,):
            flat = t.contiguous().view(torch.uint8).reshape(-1)
            acc = torch.zeros((), dtype=torch.int64, device=flat.device)
            for c in flat.split(1 << 22):   # the sum casts its input: 32 MiB at a time
                acc += c.sum(dtype=torch.int64)
            total += (i + 1) * int(acc)
    return total


# ------------------------------------------------------------- active mesh
# The engine publishes its mesh here and llama routes its matmuls, MoE FFN
# and decode attention through the per-shard bodies while one is live. A
# thread may set its own (`use_mesh`): the tests run every rank of a mesh as
# a thread of one process.

_ACTIVE_MESH = None
_THREAD = threading.local()


def set_active_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh():
    mesh = getattr(_THREAD, "mesh", None)
    return mesh if mesh is not None else _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """This thread's active mesh for the block."""
    saved = getattr(_THREAD, "mesh", None)
    _THREAD.mesh = mesh
    try:
        yield mesh
    finally:
        _THREAD.mesh = saved


def mesh_sp(mesh) -> int:
    """Size of the sequence-parallel axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape.get("sp", 1))


def _launched(kind: str, before: int, after: int, shape, rows: Optional[int] = None) -> None:
    if after != before:
        shard_launches[f"{kind} {'x'.join(str(d) for d in shape)}"] += after - before
        if rows is not None:
            shard_launch_rows[f"{kind} {'x'.join(str(d) for d in (rows,) + tuple(shape))}"] += \
                after - before


# ------------------------------------------------------------- sharded qmatmul
def row_shard_cuts_group(k: int, group_size: int, tp: int) -> bool:
    """Whether row shards of K rows over tp cut a quantization group (0 or
    >= K: one group). int4 codes pack split-half per group, so such a shard
    would pair nibbles with the wrong rows of x (the JAX island does so
    there); qmatmul_local raises and the engine refuses such configs."""
    gs = group_size if 0 < group_size < k and k % group_size == 0 else k
    return tp > 1 and (k // tp) % gs != 0


def kernel_operand(qt: QTensor, name: str, tp_index: int, tp: int) -> Optional[QTensor]:
    """The QTensor qmatmul_local hands the kernel for one rank's block: the
    block itself, or for a row shard whose replicated scale holds more
    groups than its rows (G % tp != 0) and whose rows lie inside one group,
    the block with that group's scale (the JAX island's case); None where
    the rows straddle groups (plain torch there, as the JAX package leaves
    the matmul to XLA)."""
    k_loc = qt.orig_shape[0]
    gs = qt.group_size
    if not (_row_sharded(name) and gs > 0 and qt.scale.shape[0] * gs != k_loc):
        return qt
    if gs % k_loc:
        return None
    gidx = (tp_index * k_loc) // gs
    return dataclasses.replace(qt, scale=qt.scale[gidx:gidx + 1], group_size=0)


def qmatmul_local(x: torch.Tensor, qt: QTensor, name: str, tp_index: int,
                  tp: int) -> torch.Tensor:
    """One rank's body of qmatmul_sharded on its local x and weight block:
    column shards give their output columns, row shards their partial sum
    (before the psum over tp), through the kernel on `kernel_operand`, or
    where that is None by dequantizing the rank's rows in plain torch. An
    int4 row shard that cuts a packing group raises (see
    row_shard_cuts_group)."""
    global plain_fallbacks
    from tpuserve_torch.ops import quant_matmul

    k_loc, n = qt.orig_shape
    if _row_sharded(name) and qt.bits == 4 and row_shard_cuts_group(k_loc * tp,
                                                                    qt.group_size, tp):
        raise ValueError(f"{name}: an int4 row shard of {k_loc} rows cuts a packing group")
    before = quant_matmul.launches
    op = kernel_operand(qt, name, tp_index, tp)
    if op is None:
        rows = torch.arange(k_loc, device=qt.q.device) + tp_index * k_loc
        w = qt.q.to(torch.float32) * qt.scale[rows // qt.group_size].to(torch.float32)
        out = torch.matmul(x.to(torch.float32), w).to(x.dtype)
        plain_fallbacks += 1
    else:
        out = qmatmul(x, op)
    _launched("quant_matmul", before, quant_matmul.launches, (k_loc, n),
              rows=x.numel() // max(1, x.shape[-1]))
    return out


def qmatmul_sharded(x: torch.Tensor, qt: QTensor, name: str, mesh) -> torch.Tensor:
    """x [.., K_local] @ this rank's block of a QTensor: column shards
    return [.., N/tp] (no collective), row shards psum their partials over
    tp and return [.., N]."""
    out = qmatmul_local(x, qt, name, mesh.coords["tp"], mesh.shape["tp"])
    return mesh.psum(out, "tp") if _row_sharded(name) else out


def matmul_sharded(x: torch.Tensor, w: torch.Tensor, name: str, mesh) -> torch.Tensor:
    """The same for a dense weight block (f32 accumulation in x's dtype, as
    llama._mm_w)."""
    out = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32)).to(x.dtype)
    return mesh.psum(out, "tp") if _row_sharded(name) else out


# --------------------------------------------------------- expert parallelism
def moe_ffn_local(h: torch.Tensor, w_se: torch.Tensor, gu, dn, p, tp_index: int) -> torch.Tensor:
    """One rank's body of moe_ffn_sharded: its E/tp whole experts (the local
    stacks' views) over every row of h [T, D], each weighted by its column
    of the combine weights w_se [T, E]; unrouted pairs weigh exactly 0."""
    from tpuserve_torch.models.llama import _expert_slice, expert_forward
    from tpuserve_torch.ops import quant_matmul

    e_local = gu.n_experts if isinstance(gu, QExperts) else gu.shape[0]
    before = quant_matmul.launches
    out = torch.zeros_like(h)
    for e in range(e_local):
        y = expert_forward(h, _expert_slice(gu, e), _expert_slice(dn, e), p.ffn_dim)
        col = tp_index * e_local + e
        out = out + w_se[:, col:col + 1].to(y.dtype) * y
    _launched("quant_matmul experts", before, quant_matmul.launches, (e_local,))
    return out


def moe_ffn_sharded(h: torch.Tensor, w_se: torch.Tensor, gu, dn, p, mesh) -> torch.Tensor:
    """Expert-parallel MoE FFN: the rank's experts, one psum over tp."""
    return mesh.psum(moe_ffn_local(h, w_se, gu, dn, p, mesh.coords["tp"]), "tp")


# ------------------------------------------------- sharded decode attention
def can_shard_decode_attention(mesh, s_dim: int, n_kv_heads: int) -> bool:
    """The kernel's body needs whole slots per dp rank and whole kv-head
    groups per tp rank; sp meshes take decode_attention_seq_sharded."""
    return (s_dim % mesh.shape["dp"] == 0 and n_kv_heads % mesh.shape["tp"] == 0
            and mesh_sp(mesh) == 1)


def decode_attention_sharded(q, k_local, v_local, k_scale_l, v_scale_l, positions, layer,
                             mesh=None, *, window: Optional[int] = None) -> torch.Tensor:
    """The flat-cache decode attention core on one rank's shard: q [S/dp,
    H/tp, hd] (pre-scaled by 1/sqrt(hd)), the rank's cache [n_layers, S/dp,
    L, W/tp] (a packed int4 cache's bytes are its own W/tp positions packed
    split-half, the global cache's chunks = tp), its scales [S/dp, Hkv/tp,
    L] or None, its slots' positions. Every head's output is complete on its
    rank: no collective (the psum comes in the row-sharded wo)."""
    from tpuserve_torch.ops import decode_attention as da

    del mesh
    before = da.launches
    out = da.decode_attention_wide_cache(q, k_local, v_local, k_scale_l, v_scale_l, positions,
                                         layer, window=window)
    _launched("decode_attention", before, da.launches, tuple(k_local.shape[1:]))
    return out


def _seq_scores(q, k_l, k_scale_l, qpos, l_off: int, scale: float = 1.0):
    """A shard's masked scores [S, C, Hkv, rep, L_loc] f32 (bf16 dots, f32
    over an f32 window), divided by `scale` after the key scales, and the
    dots' dtype."""
    s, c, h, hd = q.shape
    lloc, hkv = k_l.shape[1], k_l.shape[2]
    qg = q.reshape(s, c, hkv, h // hkv, hd)
    cdt = torch.float32 if k_l.dtype == torch.float32 else torch.bfloat16
    scores = torch.einsum("schrd,slhd->schrl", qg.to(cdt).to(torch.float32),
                          k_l.to(cdt).to(torch.float32))
    if k_scale_l is not None:
        scores = scores * k_scale_l.to(torch.float32)[:, None, :, None, :]
    if scale != 1.0:
        scores = true_div(scores, scale)
    kpos = l_off + torch.arange(lloc, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]                # [S, C, L_loc]
    return torch.where(mask[:, :, None, None, :], scores, -1e30), cdt


def seq_partial(q, k_l, v_l, k_scale_l, v_scale_l, qpos, l_off: int):
    """One sp shard's unnormalized attention over its L window (the JAX
    island's `_partial`): q [S, C, H, hd] pre-scaled by 1/sqrt(hd); k_l/v_l
    [S, L_loc, Hkv, hd] (int8, bf16 or f32); scales [S, Hkv, L_loc] or None;
    qpos [S, C] the global position of each query (keys at <= qpos count).
    Returns (o [S, C, Hkv, rep, hd], m [S, C, Hkv, rep], mass [S, C, Hkv,
    rep]), all f32. Masked scores are -1e30, so a window wholly past a
    query's position gives m = -1e30 and its mass vanishes in the merge."""
    scores, cdt = _seq_scores(q, k_l, k_scale_l, qpos, l_off)
    m = scores.amax(dim=-1)
    probs = torch.exp(scores - m[..., None])
    mass = probs.sum(dim=-1)
    if v_scale_l is not None:
        probs = probs * v_scale_l.to(torch.float32)[:, None, :, None, :]
    o = torch.einsum("schrl,slhd->schrd", probs.to(cdt).to(torch.float32),
                     v_l.to(cdt).to(torch.float32))
    return o, m, mass


def seq_finish(o, mass, qpos) -> torch.Tensor:
    """Normalize merged partials into [S, C, H, hd] f32, zero where the
    query's position is negative (an inactive slot)."""
    s, c = o.shape[:2]
    out = o / torch.clamp_min(mass, 1e-20)[..., None]
    out = out.reshape(s, c, -1, o.shape[-1])
    return torch.where((qpos >= 0)[:, :, None, None], out, 0.0)


def attend_seq_sharded(q, k_l, v_l, k_scale_l, v_scale_l, qpos, mesh) -> torch.Tensor:
    """Flash-decoding over the sp axis: each shard's partial, then one pmax
    and two psums on [S, C, H]-sized statistics. Returns [S, C, H, hd] f32."""
    l_off = mesh.coords["sp"] * k_l.shape[1]
    o, m, mass = seq_partial(q, k_l, v_l, k_scale_l, v_scale_l, qpos, l_off)
    m_g = mesh.pmax(m, "sp")
    w = torch.exp(m - m_g)
    o = mesh.psum(o * w[..., None], "sp")
    mass = mesh.psum(mass * w, "sp")
    return seq_finish(o, mass, qpos)


def attend_seq_softmax(q, k_l, v_l, k_scale_l, v_scale_l, qpos, mesh,
                       scale: float) -> torch.Tensor:
    """The JAX verify's einsum attention over an L split over sp, as GSPMD
    partitions it: q [S, C, H, hd] unscaled (rope applied), the rank's
    k_l/v_l [S, L_loc, Hkv, hd] and scales [S, Hkv, L_loc] or None, qpos
    [S, C] each candidate's global position. Scores are bf16 dots divided
    by `scale` after the key scales (as `_attend_window`); the softmax takes
    the global max (one pmax) and sum (one psum) before it normalizes, so
    the probabilities round to bf16 as one softmax's do, and one psum adds
    the ranks' P@V partials. Returns [S, C, H, hd] f32. Every row has a key
    at position 0, so its sum is at least 1."""
    l_off = mesh.coords["sp"] * k_l.shape[1]
    scores, cdt = _seq_scores(q, k_l, k_scale_l, qpos, l_off, scale)
    m = mesh.pmax(scores.amax(dim=-1), "sp")
    probs = torch.exp(scores - m[..., None])
    probs = probs / mesh.psum(probs.sum(dim=-1), "sp")[..., None]
    if v_scale_l is not None:
        probs = probs * v_scale_l.to(torch.float32)[:, None, :, None, :]
    o = torch.einsum("schrl,slhd->schrd", probs.to(cdt).to(torch.float32),
                     v_l.to(cdt).to(torch.float32))
    o = mesh.psum(o, "sp")
    return o.reshape(q.shape[0], q.shape[1], -1, o.shape[-1])


# ------------------------------------------------------------ sharded verify
# rows a rank wrote into its cache block or pool block in its verify calls
# (each (slot, candidate) row once a call, whatever the layer count)
verify_rows_written = 0


class VerifyFailed(RuntimeError):
    """A sharded verify failed on some rank; raised on every rank."""


def local_verify_inputs(mesh, tokens, positions, lengths, page_table=None):
    """The rank's dp slots' rows of a verify's global inputs: tokens [S, C],
    positions [S], lengths [S] and a page table [S, P] (or None); all of
    them with no mesh."""
    if mesh is None:
        return tokens, positions, lengths, page_table
    lo, hi = local_slots(mesh, tokens.shape[0])
    table = None if page_table is None else page_table[lo:hi]
    return tokens[lo:hi], positions[lo:hi], lengths[lo:hi], table


def verify_write_rows(valid: torch.Tensor, pos_c: torch.Tensor, l_off: int = 0,
                      l_loc: Optional[int] = None):
    """The (slot, candidate) rows a rank writes in a verify: the valid ones
    whose global position pos_c lies in its L window [l_off, l_off + l_loc)
    (every valid one with no window). Returns (slot index, candidate index,
    position in the window), long tensors of one length (finding them
    syncs with the host)."""
    held = valid if l_loc is None else valid & (pos_c >= l_off) & (pos_c < l_off + l_loc)
    si, ci = torch.nonzero(held, as_tuple=True)
    return si, ci, pos_c[si, ci].long() - l_off


def mesh_any(mesh, flag: bool, device) -> bool:
    """Whether `flag` holds on any rank of the mesh: a max over every axis in
    turn (each rank calls it, in the same place)."""
    t = torch.tensor([1.0 if flag else 0.0], dtype=torch.float32, device=device)
    for axis in ("tp", "sp", "pp", "dp"):
        t = mesh.pmax(t, axis)
    return bool(t.item() > 0)


def run_agreed(mesh, device, prep, body):
    """A sharded verify's two phases with the ranks agreeing after each:
    `prep()` (host work, before any collective of the step) and
    `body(prep's result)`. Where either raised on some rank, every rank
    raises VerifyFailed after that phase, so no rank is left waiting in the
    step's collectives for one that stopped before them. A rank that fails
    between two of the body's collectives leaves the others in the next one
    until the group's timeout (TPUSERVE_DIST_TIMEOUT)."""
    for phase, fn in (("prepare", prep), ("run", body)):
        err = None
        try:
            state = fn() if phase == "prepare" else fn(state)
        except Exception as e:  # agreed on below, then raised on every rank
            err = e
        if mesh_any(mesh, err is not None, device):
            where = f"rank {mesh.rank}: {err}" if err is not None else "another rank"
            raise VerifyFailed(f"the sharded verify failed to {phase} ({where})") from err
    return state


def decode_attention_seq_sharded(q, k_l, v_l, k_scale_l, v_scale_l, positions, mesh):
    """Sequence-parallel GQA decode attention on one rank: q [S/dp, H/tp,
    hd] pre-scaled by 1/sqrt(hd), this layer's local cache [S/dp, L/sp,
    Hkv/tp, hd] and scales [S/dp, Hkv/tp, L/sp] or None, the slots' global
    positions [S/dp] (-1 = inactive). Returns [S/dp, H/tp, hd] f32."""
    return attend_seq_sharded(q[:, None], k_l, v_l, k_scale_l, v_scale_l,
                              positions.to(torch.long)[:, None], mesh)[:, 0]


# ---------------------------------------------------------------- KV cache
def cache_pspec(sp: bool = False):
    """Specs of the KVCache tensors [n_layers, S, L, Hkv, hd] (scales
    head-major [n_layers, S, Hkv, L]); sp=True also splits L over "sp"."""
    from tpuserve_torch.models.llama import KVCache

    l_ax = "sp" if sp else None
    kv = (None, "dp", l_ax, "tp", None)
    sc = (None, "dp", "tp", l_ax)
    return KVCache(k=kv, v=kv, k_scale=sc, v_scale=sc)


def shard_cache(cache, mesh):
    """This rank's block of a full KVCache (flat [.., W] or 5D): slots over
    dp, heads (W on head boundaries) over tp where they split (the JAX
    rule: dim 3, Hkv or W, a multiple of tp; else every rank holds every
    head, and the scales' heads alike), L over sp on an sp mesh. A packed
    int4 cache splits its bytes over tp (the global cache packed with
    chunks = tp)."""
    from tpuserve_torch.models.llama import KVCache

    tp = mesh.shape["tp"]
    l_ax = "sp" if mesh_sp(mesh) > 1 else None
    h_ax = "tp" if cache.k.shape[3] % tp == 0 else None
    kv = (None, "dp", l_ax, h_ax) + (() if cache.k.dim() == 4 else (None,))
    sc = (None, "dp", "tp" if cache.k_scale is not None and cache.k_scale.shape[2] % tp == 0
          else None, l_ax)
    return KVCache(
        k=shard_block(cache.k, kv, mesh), v=shard_block(cache.v, kv, mesh),
        k_scale=None if cache.k_scale is None else shard_block(cache.k_scale, sc, mesh),
        v_scale=None if cache.v_scale is None else shard_block(cache.v_scale, sc, mesh))


# ---------------------------------------------------------------- paged pool
def _paged_scale_split(cache, tp: int) -> bool:
    """Whether the scale pool is cut over tp (the JAX rule): its padded head
    rows split into whole unpadded head groups, i.e. a 5D pool with hp ==
    Hkv and hp % tp == 0; else every rank holds all of it."""
    return (cache.k_scale is not None and tp > 1 and cache.k_scale.shape[2] % tp == 0
            and cache.k.dim() == 5 and cache.k_scale.shape[2] == cache.k.shape[3])


def shard_paged_cache(cache, mesh):
    """This rank's block of a whole PagedKVCache: the pool's kv heads (W on
    head boundaries) over tp where they split (dim 3, Hkv or W, a multiple
    of tp; else whole: the JAX package's device_put refuses that cut),
    every page, replicated over dp; the scale pool cut over tp where
    _paged_scale_split holds, else whole."""
    from tpuserve_torch.serving.paged_kv import PagedKVCache

    h_ax = "tp" if cache.k.shape[3] % mesh.shape["tp"] == 0 else None
    kv = (None, None, None, h_ax) + (() if cache.k.dim() == 4 else (None,))
    sc = (None, None, "tp" if _paged_scale_split(cache, mesh.shape["tp"]) else None, None)
    cut = (lambda t, spec: None if t is None else shard_block(t, spec, mesh))
    return PagedKVCache(k=cut(cache.k, kv), v=cut(cache.v, kv),
                        k_scale=cut(cache.k_scale, sc), v_scale=cut(cache.v_scale, sc))


def paged_cache_block(p, mesh, n_pages: int, page_size: int, quantized: bool,
                      dtype=torch.bfloat16, kv_bits: int = 8, device="cuda"):
    """A rank's block of a flat pool, made at its size: [n_layers, n_pages,
    ps, W/tp] and, the flat pool's scales being replicated, the whole scale
    pool [n_layers, n_pages, pad8(Hkv), ps] (shard_paged_cache's shapes).
    Where kv_replicated, the whole 5D pool [n_layers, n_pages, ps, Hkv,
    hd] and its scale pool, as the JAX engine makes it there."""
    from tpuserve_torch.serving.paged_kv import PagedKVCache, pad8

    if kv_replicated(p, mesh):
        return PagedKVCache.create(p, n_pages, page_size, quantized, dtype=dtype,
                                   kv_bits=kv_bits, device=device, flat=False)
    blk = PagedKVCache.create(local_llama_params(p, mesh), n_pages, page_size, quantized,
                              dtype=dtype, kv_bits=kv_bits, device=device)
    if quantized and mesh.shape["tp"] > 1:
        shape = (p.n_layers, n_pages, pad8(p.n_kv_heads), page_size)
        blk.k_scale = blk.k_scale.new_zeros(shape)
        blk.v_scale = blk.v_scale.new_zeros(shape)
    return blk


def paged_scales_whole(cache, n_kv_local: int, mesh) -> bool:
    """Whether a rank's scale pool holds every head's rows (replicated over
    tp), so that a rank's writes must carry every head's scales."""
    tp = 1 if mesh is None else mesh.shape["tp"]
    return cache.k_scale is not None and tp > 1 and cache.k_scale.shape[2] >= n_kv_local * tp


def paged_scale_rows(cache, n_kv_local: int, mesh):
    """The rank's rows of its scale pools (views from its first head row of
    a replicated pool; the pools themselves when cut over tp or unsharded),
    or (None, None) for a float pool."""
    if cache.k_scale is None:
        return None, None
    if not paged_scales_whole(cache, n_kv_local, mesh):
        return cache.k_scale, cache.v_scale
    h0 = mesh.coords["tp"] * n_kv_local
    return cache.k_scale[:, :, h0:], cache.v_scale[:, :, h0:]


def decode_attention_paged_sharded(q, k_pool, v_pool, k_scale_rows, v_scale_rows, page_table,
                                   positions, layer, mesh=None, *,
                                   window: Optional[int] = None) -> torch.Tensor:
    """The paged core on one rank's shard: q [S/dp, H/tp, hd] (pre-scaled by
    1/sqrt(hd)), the rank's pool block [n_layers, n_pages, ps, W/tp], its
    scale rows (paged_scale_rows: the JAX island takes the gathered [S, Hkv,
    win] scales of its shard instead; the core reads the pool in place),
    its slots' table rows [S/dp, P] and positions [S/dp]. Every head's
    output is complete on its rank: no collective (the psum comes in the
    row-sharded wo)."""
    from tpuserve_torch.ops import decode_attention as da

    del mesh
    before = da.paged_launches
    out = da.decode_attention_wide_paged(q, k_pool, v_pool, k_scale_rows, v_scale_rows,
                                         page_table, positions, layer, window=window)
    _launched("decode_attention_paged", before, da.paged_launches, tuple(k_pool.shape[1:]))
    return out
