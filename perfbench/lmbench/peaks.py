"""The language-model cells' yardstick: the card's dense bf16 peak and the
model FLOPs a served request needs, fixed here whatever implements them.

The count is the convention of ``repro_torch.models.counting.model_flops``
(2 N a token, N every parameter a token touches, the embeddings and the
head included; a test holds the two equal), with the parameters counted
from the reference's own shapes, plus the attention term the convention
leaves to its callers (the family's ``attention_flops``).
"""

from __future__ import annotations

import math

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, no sparsity).
PEAK_BF16_FLOPS = 989e12


def model_params(ref, cfg: dict) -> int:
    """The parameters a token touches: the family's
    ``active_param_count`` where it has one (sparse experts), else every
    leaf of its ``param_shapes``."""
    if hasattr(ref, "active_param_count"):
        return ref.active_param_count(cfg)
    return sum(math.prod(s) for s in ref.param_shapes(cfg).values())


def fed_positions(traffic: dict, answer: int) -> int:
    """The positions of one request whose forward its answer of ``answer``
    tokens needs: the prompt and every served token but the last, each
    once (a preempted request's re-prefill is recomputation and does not
    count, nor are the steps the engine runs a finished request's row
    on)."""
    return traffic["prompt_len"] + answer - 1


def request_flops(ref, cfg: dict, traffic: dict, answer: int) -> float:
    """Model FLOPs of one request of the mix answering ``answer`` tokens:
    ``2 N`` a fed position and the attention over the positions before
    it."""
    t = fed_positions(traffic, answer)
    return 2.0 * model_params(ref, cfg) * t + ref.attention_flops(cfg, t)


def call_flops(ref, cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one call of the mix: every call serves the mix's
    answer lengths (in another order)."""
    from .program import answer_lengths
    return sum(request_flops(ref, cfg, traffic, a)
               for a in answer_lengths(traffic))
