"""Speculative decoding's limits in tpuserve_torch's engine (split from
tests/test_torch_spec.py): slots with a repetition penalty fall back to
plain decoding, a history without a repeated n-gram never drafts, the
break-even guard suppresses the fused dispatches, and sequences that reach
max_seq_len or EOS inside an accepted run stop where plain decoding stops.
The helpers and fixtures are tests/test_torch_spec_engine.py's.
"""

import pytest

from test_torch_spec_engine import SPEC_MODES, _port, plain_tokens, spec_prompts  # noqa: F401


def test_penalized_slots_fall_back(tmp_path, spec_prompts):
    """repetition_penalty != 1 disables speculation for the step."""
    out, _, stats = _port(tmp_path, "pen", spec_prompts, n=8,
                          kw=dict(repetition_penalty=1.3), **SPEC_MODES["fused"])
    assert [len(o) for o in out] == [8] * 3 and "spec_drafted" not in stats


def test_random_prompts_never_draft(tmp_path):
    """The n-gram gate: a history without a repeated n-gram pays no verify."""
    prompts = [[7, 21, 3, 44, 8, 100, 62, 115, 31], [400, 2, 90, 17]]
    out, _, stats = _port(tmp_path, "rand", prompts, n=12, **SPEC_MODES["fused"])
    ref, _, _ = _port(tmp_path, "rand_ref", prompts, n=12)
    assert out == ref and "spec_drafted" not in stats


def test_break_even_guard(tmp_path, spec_prompts, plain_tokens):
    """speculation_min_gain above any expected gain suppresses the fused
    dispatches (but for one probe in 16) and keeps the tokens exact."""
    out, _, stats = _port(tmp_path, "guard", spec_prompts,
                          **dict(SPEC_MODES["fused"], speculation_min_gain=1e9))
    assert out == plain_tokens and "spec_drafted" not in stats


@pytest.mark.parametrize("mode", ["fused", "single"])
def test_capacity_and_eos_inside_a_run(tmp_path, spec_prompts, mode):
    """Sequences that reach max_seq_len or EOS inside an accepted run stop
    exactly where plain decoding stops."""
    gen = dict(max_seq_len=64)
    ref, ref_reasons, _ = _port(tmp_path, f"cap_ref_{mode}", spec_prompts, n=48, **gen)
    out, reasons, stats = _port(tmp_path, f"cap_{mode}", spec_prompts, n=48,
                                **SPEC_MODES[mode], **gen)
    assert out == ref and reasons == ref_reasons and "max_seq_len" in reasons
    assert stats["spec_accepted"] > 0
    eos = dict(eos_token_id=ref[0][10])
    ref, ref_reasons, _ = _port(tmp_path, f"eos_ref_{mode}", spec_prompts, **eos)
    out, reasons, _ = _port(tmp_path, f"eos_{mode}", spec_prompts, **SPEC_MODES[mode], **eos)
    assert out == ref and reasons == ref_reasons and reasons[0] == "eos"
    assert len(out[0]) == 11
