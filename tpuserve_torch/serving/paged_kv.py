"""Paged KV cache: fixed-size pages + per-slot page tables (PyTorch port of
tpuserve/serving/paged_kv.py).

The contiguous per-slot cache (llama.KVCache) reserves max_seq_len for every
slot; the paged cache allocates pages on demand, so the memory committed
follows the actual token count and more concurrent slots fit the same card.

Device layout:
  k/v:     flat [n_layers, n_pages, page_size, W] (W = Hkv*hd; int8, bf16 or
           f32) or packed int4 uint8 [.., W/2] (llama.pack_kv_codes); or 5D
           [n_layers, n_pages, page_size, Hkv, hd] (int8 or float; the
           layout the pipeline's stages read, PagedKVCache.create(flat=
           False)). The two layouts hold the same bytes, so a pool crosses
           between them by a reshape of k and v.
  scales:  [n_layers, n_pages, pad8(Hkv), page_size] f32 (int8/int4 only),
           head-major per page. The pad8 rows are kept so pools cross
           between the two packages byte for byte.
  table:   [S, max_pages_per_slot] int32; page 0 is the reserved zero page
           that unallocated entries point at.

Decode reads pages from the pool in place through the page table
(ops/decode_attention.py::decode_attention_wide_paged). Page bookkeeping
(free list, per-sequence chains, run-affine placement) is the native
runtime's allocator where libtpuserve.so loads (bindings/native.py), else
`_PyKvAllocator`, a verbatim port of the JAX package's pure-Python
allocator; both place pages alike, so page ids come out identical in the
two packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.errors import ResourceExhaustedError


def pad8(n: int) -> int:
    """Scale-pool rows per page: n_kv_heads padded to a multiple of 8."""
    return (n + 7) // 8 * 8


class _PyKvAllocator:
    """Page allocator with the RUN-AFFINE policy:

      1. growing chains first consume/extend their physical tail run;
      2. fresh pages come from the head of the first free run long enough
         for the whole request, skipping runs soft-reserved by other
         chains (first-fit from a run's head never splits it);
      3. after taking pages, the next RESERVE_RUN pages of the run are
         soft-reserved for this chain, so interleaved one-page-at-a-time
         growth across slots (the decode steady state) still produces
         contiguous chains;
      4. reservations are SOFT: they don't count against free_pages and
         are stolen under pool pressure, so capacity is unaffected."""

    RESERVE_RUN = 7  # pages soft-held past each chain's tail

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.total_pages = num_pages
        self._free = set(range(num_pages))
        self._chains: Dict[int, List[int]] = {}
        self._reserved: Dict[int, List[int]] = {}  # seq -> [start, end) run
        self._lock = threading.Lock()

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def _foreign_reserved(self, seq_id: int) -> set:
        out = set()
        for s, (a, b) in self._reserved.items():
            if s != seq_id:
                out.update(range(a, b))
        return out

    def _runs(self, pages) -> List[Tuple[int, int]]:
        """Maximal runs of `pages`, ascending: (start, len) pairs."""
        out = []
        run_start, run_len, prev = -1, 0, -2
        for pg in sorted(pages):
            if pg == prev + 1:
                run_len += 1
            else:
                if run_len:
                    out.append((run_start, run_len))
                run_start, run_len = pg, 1
            prev = pg
        if run_len:
            out.append((run_start, run_len))
        return out

    def _steal(self, seq_id: int, pages: List[int]) -> None:
        """Drop any foreign reservation overlapping `pages`."""
        for s in list(self._reserved):
            if s == seq_id:
                continue
            a, b = self._reserved[s]
            if any(a <= p < b for p in pages):
                del self._reserved[s]

    def _take(self, seq_id: int, chain: List[int], start: int, n: int) -> None:
        pages = list(range(start, start + n))
        chain.extend(pages)
        self._free.difference_update(pages)
        self._steal(seq_id, pages)

    def ensure(self, seq_id: int, num_tokens: int) -> bool:
        with self._lock:
            chain = self._chains.setdefault(seq_id, [])
            need = -(-num_tokens // self.page_size)
            extra = need - len(chain)
            if extra <= 0:
                return True
            if extra > len(self._free):
                return False
            # 1. extend the chain's physical tail run (its own reservation
            #    sits exactly there when one exists)
            while extra > 0 and chain and (chain[-1] + 1) in self._free:
                self._take(seq_id, chain, chain[-1] + 1, 1)
                extra -= 1
                resv = self._reserved.get(seq_id)
                if resv is not None:
                    resv[0] = max(resv[0], chain[-1] + 1)
                    if resv[0] >= resv[1]:
                        del self._reserved[seq_id]
            # 2./3. fresh runs: unreserved first-fit, then any first-fit,
            #        then consume whole longest-runs
            relaxed = False
            while extra > 0:
                avail = self._free if relaxed else (
                    self._free - self._foreign_reserved(seq_id))
                runs = self._runs(avail)
                ff = next(((s, l) for s, l in runs if l >= extra), None)
                if ff is None and not relaxed:
                    relaxed = True
                    continue
                if ff is not None:
                    start, length = ff
                    self._take(seq_id, chain, start, extra)
                    # soft-reserve the continuation for this chain, in
                    # proportion to its growth (one-page chains such as
                    # shared prefix blocks leave at most a one-page hole)
                    resv = min(self.RESERVE_RUN, length - extra, len(chain))
                    if resv > 0:
                        self._reserved[seq_id] = [start + extra, start + extra + resv]
                    extra = 0
                else:
                    start, length = max(runs, key=lambda r: r[1])
                    self._take(seq_id, chain, start, length)
                    extra -= length
            return True

    def release(self, seq_id: int) -> bool:
        with self._lock:
            chain = self._chains.pop(seq_id, None)
            self._reserved.pop(seq_id, None)
            if chain is None:
                return False
            self._free.update(chain)
            return True

    def page_table(self, seq_id: int) -> Optional[List[int]]:
        with self._lock:
            chain = self._chains.get(seq_id)
            return None if chain is None else list(chain)


def make_allocator(num_pages: int, page_size: int):
    """The native runtime's allocator (bindings/native.py) where
    libtpuserve.so loads, else `_PyKvAllocator`, which places pages the same
    way; the JAX package chooses so too."""
    try:
        from tpuserve_torch.bindings import native

        if native.available():
            return native.NativeKvAllocator(num_pages, page_size)
    except Exception:
        pass
    return _PyKvAllocator(num_pages, page_size)


@dataclasses.dataclass
class PagedKVCache:
    """Device page pool, flat or 5D (see module docstring). Written in place
    by the model's paged entry points."""

    k: torch.Tensor  # [n_layers, n_pages, page_size, W] (W/2 uint8 for int4) or 5D
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [n_layers, n_pages, pad8(Hkv), page_size] f32
    v_scale: Optional[torch.Tensor]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def kv_bits(self) -> int:
        return 4 if self.k.dtype == torch.uint8 else 8

    def as_flat(self) -> "PagedKVCache":
        """The same pool viewed flat [.., page_size, Hkv*hd] (no copy)."""
        if self.flat:
            return self
        return dataclasses.replace(self, k=self.k.flatten(-2), v=self.v.flatten(-2))

    def as_5d(self, n_kv_heads: int) -> "PagedKVCache":
        """The same pool viewed 5D [.., page_size, Hkv, hd] (no copy; not a
        packed int4 pool)."""
        if not self.flat:
            return self
        if self.k.dtype == torch.uint8:
            raise ValueError("a packed int4 pool is flat only")
        shape = tuple(self.k.shape[:3]) + (n_kv_heads, self.k.shape[3] // n_kv_heads)
        return dataclasses.replace(self, k=self.k.view(shape), v=self.v.view(shape))

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def nbytes(self) -> int:
        ts = (self.k, self.v) + ((self.k_scale, self.v_scale) if self.quantized else ())
        return sum(t.numel() * t.element_size() for t in ts)

    @classmethod
    def create(cls, p, n_pages: int, page_size: int, quantized: bool,
               dtype=torch.bfloat16, kv_bits: int = 8, device="cuda",
               flat: bool = True) -> "PagedKVCache":
        dev = resolve_device(device)
        w = p.n_kv_heads * p.head_dim
        if kv_bits == 4:
            if not (quantized and flat):
                raise ValueError("kv_bits=4 requires quantized flat pools")
            if w % 2:
                raise ValueError("kv_bits=4 requires an even n_kv_heads*head_dim")
        shape = (p.n_layers, n_pages, page_size, w // 2 if kv_bits == 4 else w) if flat \
            else (p.n_layers, n_pages, page_size, p.n_kv_heads, p.head_dim)
        if not quantized:
            return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev),
                       k_scale=None, v_scale=None)
        code_dt = torch.uint8 if kv_bits == 4 else torch.int8
        scale_shape = (p.n_layers, n_pages, pad8(p.n_kv_heads), page_size)
        return cls(k=torch.zeros(shape, dtype=code_dt, device=dev),
                   v=torch.zeros(shape, dtype=code_dt, device=dev),
                   k_scale=torch.zeros(scale_shape, dtype=torch.float32, device=dev),
                   v_scale=torch.zeros(scale_shape, dtype=torch.float32, device=dev))


class PageTableManager:
    """Host-side bridge: sequence ids -> device page table [S, P].

    Page 0 is the reserved zero page (never allocated), so unused table
    entries point at it; the attention mask ignores what they hold.

    Prefix sharing (``prefix_sharing=True``): full prompt pages are
    content-addressed by a blake2b digest chain; an admission whose leading
    full pages match registered blocks reuses those pages (refcount + 1)
    and skips both their allocation and their prefill. Shared blocks are
    owned by synthetic allocator handles (>= n_slots, one page each);
    blocks at refcount 0 stay cached and are evicted least recently used
    first under pool pressure.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int, max_len: int,
                 prefix_sharing: bool = False, device="cuda"):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        # page 0 reserved: hand the allocator n_pages-1 pages, shift ids by 1
        self._alloc = make_allocator(n_pages - 1, page_size)
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self.table = np.zeros((n_slots, self.max_pages), np.int32)  # 0 = zero page
        self.prefix_sharing = bool(prefix_sharing)
        # digest -> block record {"handle", "page" (0-based pool id), "refs", "tick"}
        self._blocks: Dict[bytes, Dict] = {}
        self._slot_shared: Dict[int, List[bytes]] = {}  # slot -> digests held
        self._next_handle = n_slots  # synthetic allocator seq ids
        self._tick = 0
        self.prefix_hits = 0          # blocks served from cache
        self.prefix_hit_tokens = 0    # prompt tokens skipped through sharing

    @property
    def free_pages(self) -> int:
        return self._alloc.free_pages

    @property
    def cached_blocks(self) -> int:
        return len(self._blocks)

    # -------------------------------------------------------- prefix sharing
    @staticmethod
    def _digest_chain(prompt_ids, page_size: int, n_blocks: int) -> List[bytes]:
        """Rolling digests of the first n_blocks full pages: block i's digest
        commits to all tokens in pages 0..i, so a match implies the whole
        prefix matches."""
        out = []
        prev = b""
        for i in range(n_blocks):
            blk = np.asarray(prompt_ids[i * page_size:(i + 1) * page_size], np.int32)
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(blk.tobytes())
            prev = h.digest()
            out.append(prev)
        return out

    def _evict_lru(self) -> bool:
        """Free ONE refcount-0 cached block (least recently used)."""
        victim = None
        for d, rec in self._blocks.items():
            if rec["refs"] == 0 and (victim is None or rec["tick"] < self._blocks[victim]["tick"]):
                victim = d
        if victim is None:
            return False
        rec = self._blocks.pop(victim)
        self._alloc.release(rec["handle"])
        return True

    def _alloc_one_shared(self) -> Optional[Tuple[int, int]]:
        """Allocate one page under a fresh synthetic handle, evicting
        refcount-0 blocks as needed. Returns (handle, 0-based page id)."""
        handle = self._next_handle
        while not self._alloc.ensure(handle, 1):
            if not self._evict_lru():
                return None
        self._next_handle += 1
        return handle, self._alloc.page_table(handle)[0]

    def admit_shared(self, slot: int, prompt_ids) -> Tuple[int, int]:
        """Match/register the prompt's full pages in the prefix cache and
        install them at the head of the slot's table row.

        Returns (shared_tokens, matched_tokens): the first shared_tokens of
        the prompt live in shared pages (matched ones already hold valid KV;
        newly registered ones are written by this admission's prefill);
        matched_tokens of those skip prefill. The final prompt token is
        never shared, so prefill always has a token to produce the
        first-token logits from. No-op unless prefix_sharing."""
        if not self.prefix_sharing:
            return 0, 0
        ps = self.page_size
        n_blocks = min((len(prompt_ids) - 1) // ps, self.max_pages)
        if n_blocks <= 0:
            return 0, 0
        digests = self._digest_chain(prompt_ids, ps, n_blocks)
        held: List[bytes] = []
        pages: List[int] = []
        matched = 0
        self._tick += 1
        still_matching = True
        for d in digests:
            rec = self._blocks.get(d)
            if rec is not None:
                rec["refs"] += 1
                rec["tick"] = self._tick
                held.append(d)
                pages.append(rec["page"])
                if still_matching:
                    matched += 1
                continue
            still_matching = False
            got = self._alloc_one_shared()
            if got is None:
                break  # pool pressure: the rest of the prompt goes private
            handle, page = got
            self._blocks[d] = {"handle": handle, "page": page, "refs": 1, "tick": self._tick}
            held.append(d)
            pages.append(page)
        self._slot_shared[slot] = held
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(pages)] = np.asarray(pages, np.int32) + 1
        self.table[slot] = row
        self.prefix_hits += matched
        self.prefix_hit_tokens += matched * ps
        return len(held) * ps, matched * ps

    # ------------------------------------------------------------- allocation
    def ensure(self, slot: int, num_tokens: int) -> None:
        """Grow the slot's chain to cover num_tokens (beyond any shared
        prefix installed by admit_shared); raises ResourceExhaustedError
        when the pool is out of pages after evicting every unreferenced
        cached block."""
        n_shared = len(self._slot_shared.get(slot, ()))
        need_tokens = max(0, num_tokens - n_shared * self.page_size)
        while not self._alloc.ensure(slot, need_tokens):
            if not self._evict_lru():
                raise ResourceExhaustedError(
                    f"KV page pool exhausted ({self._alloc.free_pages} pages free)")
        chain = self._alloc.page_table(slot) or []
        row = self.table[slot].copy()
        row[n_shared:] = 0
        row[n_shared:n_shared + len(chain)] = np.asarray(chain, np.int32) + 1  # past page 0
        self.table[slot] = row

    def release(self, slot: int) -> None:
        self._alloc.release(slot)
        for d in self._slot_shared.pop(slot, ()):  # decref, keep cached
            rec = self._blocks.get(d)
            if rec is not None:
                rec["refs"] = max(0, rec["refs"] - 1)
        self.table[slot] = 0

    def device_table(self) -> torch.Tensor:
        """The table as int32 [S, P] on the manager's device (a copy)."""
        return torch.from_numpy(self.table.copy()).to(self.device)
