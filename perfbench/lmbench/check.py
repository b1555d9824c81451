"""Whether what the served path produced is correct.

Once the window has closed, the program's state is freed and the memory
peak read, the family's plain reference (``perfbench/lmref/<family>.py``:
float32, TF32 off, no cache) runs teacher-forced over each checked
request's prompt and served tokens, on the benchmark's own weights, and
judges:

* ``logits``: every step's logits of the last window call's
  ``check.logit_rows`` requests (``program.logit_rows``: the longest and
  others drawn from the seed), from every engine the call ran (where the
  mix preempts: the first engine's steps and the resuming engine's
  re-prefill and decode), against the reference's at the same position,
  at every position whose fed token is the request's own (its prompt and
  served tokens; the engine runs a finished request's row on to the
  batch's end), over the published vocabulary only (the port pads it).
  The number is the largest share of its element's allowance that a
  difference takes, the allowance being ``2^-7 |ref| + 2^-6 rms(ref's
  row)`` (the form of ``chip_smoke.attn_limit``: one bf16 rounding of the
  element, and a share of its row's scale for the sums before it);
* ``served_gap``: for those requests and ``check.sampled_requests`` more
  drawn from the seed over the other calls, the widest gap by which a
  served token's logit lies below the reference's best at its position,
  over that row's rms.  Greedy decoding serves the best token, so a sound
  run's gap is what rounding can swap between near-equal logits;
* ``resume``, where the mix preempts its calls: the last call's requests
  served again by one engine, not preempted: its tokens against the
  preempted call's, token by token (mismatches; limit 0);
* ``count``: every request of every window call served its own answer
  length, no token more or fewer (tokens off; limit 0).

A preemption the mix asks for is no failed request.
"""

from __future__ import annotations

import math

import numpy as np

from . import program

#: The allowance of an element: ``ULP * |ref| + ROW * rms(ref's row)``.
ULP, ROW = 2.0 ** -7, 2.0 ** -6


def rms(x):
    return x.square().mean(-1, keepdim=True).sqrt()


def reference_logits(torch, ref, cfg: dict, params: dict, tokens,
                     layer_out=None, block: int = 16384):
    """The reference's logits (B, S, V) float32 of ``tokens`` (B, S) over
    the published vocabulary, the head applied a block of ``block`` ids at
    a time."""
    V = cfg["vocab_size"]
    with ref.exact_f32():
        h = ref.hidden(cfg, params, tokens, layer_out)
        w = ref.head(cfg, params)
        return torch.cat([h @ w[:, v:min(v + block, V)].to(torch.float32)
                          for v in range(0, V, block)], dim=-1)


def logits_share(got, want) -> float:
    """The largest share of its allowance a difference takes (rows of
    ``got`` and ``want`` alike)."""
    allow = ULP * want.abs() + ROW * rms(want)
    return float(((got - want).abs() / allow).max())


def padded(torch, seqs: list, device):
    """``(tokens (B, longest), lengths (B,))`` of ``seqs``, each padded on
    the right with id 0 (a causal model's earlier positions never see
    it)."""
    longest = max(map(len, seqs))
    return (torch.tensor([s + [0] * (longest - len(s)) for s in seqs],
                         device=device),
            torch.tensor([len(s) for s in seqs], device=device))


def served_gaps(want, served, lengths, start: int):
    """Per request, the widest ``(best - served) / rms`` of the rows that
    chose its served tokens: row ``start + t`` chose token ``t``, for ``t``
    below the request's length (``served`` padded to the longest)."""
    n = served.shape[1]
    rows = want[:, start:start + n]
    best = rows.max(-1).values
    got = rows.gather(-1, served[..., None])[..., 0]
    gap = (best - got) / rms(rows)[..., 0]
    col = served.new_tensor(range(n))[None, :]
    return gap.masked_fill(col >= lengths[:, None], -math.inf).max(-1).values


def sample_requests(seed: int, rows: list, n_calls: int, per_call: int,
                    extra: int) -> list[tuple]:
    """``(call, request)`` pairs: the last call's ``rows``, then ``extra``
    drawn from the seed over the other calls."""
    last = [(n_calls - 1, j) for j in rows]
    others = [(c, j) for c in range(n_calls - 1) for j in range(per_call)]
    rng = np.random.default_rng(program.derive(seed, program.SAMPLE))
    pick = rng.choice(len(others), size=min(extra, len(others)),
                      replace=False) if others else []
    return last + [others[int(k)] for k in sorted(pick)]


def step_logits(captured: list[dict], V: int) -> list[tuple]:
    """``(position, logits (rows, V))`` of every captured step."""
    return [(c["pos"], c["logits"][:, :V].float()) for c in captured]


def rows_share(captured: list[dict], want, own, V: int) -> float:
    """:func:`logits_share` of every captured step against ``want`` (rows
    alike), at each row's positions below ``own`` (prompt and served
    tokens: the positions that fed the request's own token); infinite
    where a step kept no rows."""
    if any(c["logits"] is None for c in captured):
        return math.inf
    share = 0.0
    for pos, got in step_logits(captured, V):
        mine = pos < own
        if bool(mine.any()):
            share = max(share, logits_share(got[mine], want[mine, pos]))
    return share


def judge(torch, ref, cell, params: dict, window: dict, resumed,
          seed: int, device) -> tuple:
    """Every comparison of a run: ``(correct, [(name, value, limit)],
    requests checked, requests failed)``.  ``window`` holds the calls'
    prompts (``ids``), answer lengths (``answers``), served tokens
    (``served``, ``{rid: tokens}`` a call), and the last call's captured
    steps (``captured``) of its ``rows``; ``resumed`` is the last call
    served again unpreempted, or None where the mix does not preempt."""
    cfg, traffic = cell.config, cell.traffic
    limits = traffic["limits"]
    V, plen = cfg["vocab_size"], traffic["prompt_len"]
    ids, served, answers = window["ids"], window["served"], window["answers"]
    rows = window["rows"]
    n_calls, per_call = len(ids), traffic["requests"]
    last = n_calls - 1

    def tokens(c, j):
        return served[c].get(f"r{j}", [])

    off = [[abs(answers[c][j] - len(tokens(c, j))) for j in range(per_call)]
           for c in range(n_calls)]
    resume_bad = [] if resumed is None else [
        sum(a != b for a, b in zip(tokens(last, j), resumed.get(f"r{j}", [])))
        + abs(len(tokens(last, j)) - len(resumed.get(f"r{j}", [])))
        for j in range(per_call)]

    picks = [(c, j) for c, j in sample_requests(
        seed, rows, n_calls, per_call, traffic["check"]["sampled_requests"])
        if not off[c][j]]
    whole_rows = all(not off[last][j] for j in rows)
    gaps, share = {}, 0.0
    for lo in range(0, len(picks), len(rows)):
        block = picks[lo:lo + len(rows)]
        seq, lengths = padded(torch, [list(map(int, ids[c][j]))
                                      + tokens(c, j) for c, j in block],
                              device)
        want = reference_logits(torch, ref, cfg, params, seq)
        for (c, j), g in zip(block, served_gaps(
                want, seq[:, plen:], lengths - plen, plen - 1).tolist()):
            gaps[(c, j)] = g
        if lo == 0 and whole_rows:
            # the first block is the last call's rows, in order
            share = rows_share(window["captured"], want, lengths, V)
        del want
    if not whole_rows or not window["captured"]:
        share = math.inf
    served_gap = max(gaps.values(), default=math.inf)

    checks = [("logits", share, limits["logits"]),
              ("served_gap", served_gap, limits["served_gap"])]
    if resumed is not None:
        checks.append(("resume", sum(resume_bad), 0))
    checks.append(("count", sum(map(sum, off)), 0))
    correct = all(v <= lm and not math.isnan(v) for _n, v, lm in checks)
    failed = set()
    for c in range(n_calls):
        failed |= {(c, j) for j in range(per_call) if off[c][j]}
    failed |= {k for k, g in gaps.items() if not g <= limits["served_gap"]}
    failed |= {(last, j) for j, bad in enumerate(resume_bad) if bad}
    if not share <= limits["logits"]:
        failed |= {(last, j) for j in rows}
    return correct, checks, len(picks), len(failed)
