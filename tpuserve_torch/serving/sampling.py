"""Token sampling, batched over slots (PyTorch port of
tpuserve/serving/sampling.py).

Greedy / temperature / top-k / top-p / min-p / repetition penalty, applied
per slot with per-slot parameters so one sampler serves a mixed continuous
batch. Randomness comes from an explicit torch.Generator, so sampled tokens
cannot match JAX's bit for bit; greedy and point-mass paths can.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tpuserve_torch.utils.device import resolve_device


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling parameters, each [S]-shaped."""

    temperature: torch.Tensor         # 0 -> greedy
    top_k: torch.Tensor               # 0 -> disabled
    top_p: torch.Tensor               # 1 -> disabled
    repetition_penalty: torch.Tensor  # 1 -> disabled (CTRL-style)
    min_p: torch.Tensor               # 0 -> disabled

    @classmethod
    def create(cls, n_slots: int, temperature=0.0, top_k=0, top_p=1.0,
               repetition_penalty=1.0, min_p=0.0, device="cuda") -> "SamplingParams":
        dev = resolve_device(device)

        def full(v, dt):
            return torch.full((n_slots,), v, dtype=dt, device=dev)

        return cls(
            temperature=full(float(temperature), torch.float32),
            top_k=full(int(top_k), torch.int32),
            top_p=full(float(top_p), torch.float32),
            repetition_penalty=full(float(repetition_penalty), torch.float32),
            min_p=full(float(min_p), torch.float32),
        )

    def update_slot(self, slot: int, temperature: float, top_k: int, top_p: float,
                    repetition_penalty: float = 1.0, min_p: float = 0.0) -> "SamplingParams":
        """Set one slot's parameters in place; returns self."""
        self.temperature[slot] = float(temperature)
        self.top_k[slot] = int(top_k)
        self.top_p[slot] = float(top_p)
        self.repetition_penalty[slot] = float(repetition_penalty)
        self.min_p[slot] = float(min_p)
        return self

    def select(self, idx) -> "SamplingParams":
        """The parameters of a subset of slots (idx: int, slice or index tensor)."""
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return SamplingParams(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))


def mark_presence(presence: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Record sampled tokens in the per-slot presence mask [S, V] bool (the
    repetition-penalty working set), in place."""
    s = tokens.shape[0]
    presence[torch.arange(s, device=presence.device), tokens.long()] = True
    return presence


def _masked_logits(lf: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """Temperature-scaled, top-k / top-p / min-p masked logits [N, V]; dropped
    tokens are -inf. Rank 0 is never masked, so argmax(masked) == argmax(lf)."""
    n, v = lf.shape
    dev = lf.device
    temp = torch.clamp_min(params.temperature, 1e-6)[:, None]
    scaled = lf / temp

    # top-k mask: rank of each logit within its row (descending, stable)
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    ranks = torch.empty_like(sort_idx)
    ranks.scatter_(1, sort_idx, torch.arange(v, device=dev).expand(n, v))
    k = torch.where(params.top_k[:, None] > 0, params.top_k[:, None].long(), v)
    scaled = torch.where(ranks < k, scaled, -torch.inf)

    # top-p mask: keep the smallest prefix of sorted probs covering top_p
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < params.top_p[:, None]  # always keeps rank 0
    keep = torch.zeros_like(keep_sorted).scatter_(1, sort_idx, keep_sorted)
    scaled = torch.where(keep, scaled, -torch.inf)

    # min-p mask: drop tokens below min_p * p_max
    probs = torch.softmax(scaled, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    return torch.where(probs >= params.min_p[:, None] * pmax, scaled, -torch.inf)


def _uniform(shape, generator, device) -> torch.Tensor:
    """Uniform in [1e-10, 1), as jax.random.uniform(minval=1e-10)."""
    u = torch.rand(shape, generator=generator, device=device)
    return 1e-10 + (1.0 - 1e-10) * u


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator] = None,
           presence: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [S, V] -> token ids [S] int64.

    Repetition-penalized, temperature-scaled logits are masked by top-k
    rank, top-p mass and min-p, then Gumbel-max sampled with noise from
    `generator`; temperature <= 0 slots take the plain argmax (still
    penalized). presence [S, V] bool marks tokens already in each slot's
    sequence (CTRL-style penalty)."""
    s, v = logits.shape
    lf = logits.to(torch.float32)
    if presence is not None:
        rp = params.repetition_penalty[:, None]
        penalized = torch.where(lf > 0, lf / rp, lf * rp)
        lf = torch.where(presence & (rp != 1.0), penalized, lf)

    greedy = torch.argmax(lf, dim=-1)
    scaled = _masked_logits(lf, params)
    gumbel = -torch.log(-torch.log(_uniform((s, v), generator, lf.device)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(params.temperature > 0, sampled, greedy)


def spec_accept(
    logits: torch.Tensor, draft: torch.Tensor, lens: torch.Tensor,
    params: SamplingParams, generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact speculative acceptance for point-mass (prompt-lookup) drafts.

    logits [S, C, V]: position j's logits predict the token at column j+1.
    draft [S, C]: column 0 is the slot's committed last token, columns
    1..lens-1 the drafted continuation; lens [S] valid columns (>= 1 for a
    live slot), so a row carries k = lens-1 drafts.

    Draft j is accepted with probability p_j(draft) under the slot's
    processed distribution (temperature / top-k / top-p / min-p, the masks
    sample() applies); greedy slots (temperature <= 0) accept iff the draft
    equals the argmax. At the first rejection the emitted token is drawn
    from p with the rejected token masked out (the residual of a point-mass
    proposal), so the emitted sequence is distributed exactly as
    token-by-token sampling; when all k drafts are accepted a bonus token is
    drawn from p_k. The repetition penalty is not applied (the engine
    speculates only for slots without one). Uniforms and Gumbel noise come
    from `generator`.

    Returns (tokens [S, C] int64, logprobs [S, C] f32, accepted [S] int64):
    row i emits tokens[i, :accepted[i]+1]; logprobs are under the
    unfiltered model distribution."""
    s, c, v = logits.shape
    dev = logits.device
    lf = logits.to(torch.float32)
    params_c = SamplingParams(*(getattr(params, f.name).repeat_interleave(c)
                                for f in dataclasses.fields(params)))
    masked = _masked_logits(lf.reshape(s * c, v), params_c).reshape(s, c, v)
    probs = torch.softmax(masked, dim=-1)
    greedy_tok = torch.argmax(masked, dim=-1)        # == argmax(lf)

    # the token judged by position-j logits sits at draft column j+1
    draft = draft.to(device=dev, dtype=torch.int64)
    draft_next = torch.cat([draft[:, 1:], draft.new_zeros((s, 1))], dim=1)   # [S, C]
    p_draft = torch.gather(probs, 2, draft_next[..., None])[..., 0]
    u = _uniform((s, c), generator, dev)
    sampled = (params.temperature > 0)[:, None]
    accept = torch.where(sampled, u < p_draft, draft_next == greedy_tok)
    k = torch.clamp_min(lens.to(device=dev, dtype=torch.int64) - 1, 0)      # drafts per row
    cols = torch.arange(c, device=dev)[None, :]
    accept = accept & (cols < k[:, None])
    a = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)            # [S]

    # final token at position a: the residual (rejected draft masked) when
    # a < k, else the bonus draw from p_k
    rows = torch.arange(s, device=dev)
    m_a = masked[rows, a]                                                  # [S, V]
    rejected = draft_next[rows, a]
    mask_rej = (a < k)[:, None] & (torch.arange(v, device=dev)[None, :] == rejected[:, None])
    m_final = torch.where(mask_rej, -torch.inf, m_a)
    gumbel = -torch.log(-torch.log(_uniform((s, v), generator, dev)))
    final = torch.where(params.temperature > 0, torch.argmax(m_final + gumbel, dim=-1),
                        torch.argmax(m_final, dim=-1))

    out = torch.where(cols < a[:, None], draft_next, 0)
    out = torch.where(cols == a[:, None], final[:, None], out)
    lp = torch.gather(lf, 2, out[..., None])[..., 0] - torch.logsumexp(lf, dim=-1)
    return out, lp, a


def sample_with_logprobs(
    logits: torch.Tensor, params: SamplingParams,
    generator: Optional[torch.Generator] = None,
    presence: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """sample() + the chosen token's log-probability under the UNFILTERED
    distribution + the presence mask with the sampled tokens marked (in
    place). Returns (tokens [S] int64, logprobs [S] f32, presence|None)."""
    toks = sample(logits, params, generator, presence)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    chosen = torch.gather(lf, 1, toks[:, None])[:, 0]
    lp = chosen - lse
    if presence is not None:
        presence = mark_presence(presence, toks)
    return toks, lp, presence
