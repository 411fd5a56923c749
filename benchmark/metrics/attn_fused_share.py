"""Masked-attention calls that took the fused kernel, in %: the program's
counter attn.fused over its counter attn.masked
(qnnpack_tpu_torch/models/mimo_v2_flash.py:attention), both counted at each
call over the whole run, so at the eager warm-up and the capture, and never
at a replay.  None where the program counted no masked attention, or has no
such counters."""

from benchmark import spans


def read(view):
    calls = spans.counter("attn.masked")
    if not calls:
        return None
    return 100.0 * (spans.counter("attn.fused") or 0) / calls
