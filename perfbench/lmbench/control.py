"""The check's control for a language-model cell, beside the program's own
readings, on some seeds in one process.

For each seed: the benchmark's weights from the seed; one call of the mix
served by the program (preempted and resumed where the mix preempts, as in
the window), every step's logits of its ``check.logit_rows`` requests
captured; then the reference teacher-forced over those requests' prompts
and served tokens, and the control: the same reference with
every layer's output rounded to float8 e4m3 (scaled a token at a time to
the format's largest value, as an fp8 activation path scales it), the
nearest precision below the configuration's bfloat16.  A line a seed:

* the program's ``logits`` and ``served_gap`` (``check``'s numbers);
* the control's ``logits`` (its logits at every position of the
  request's own tokens against the reference's) and ``served_gap`` (at
  each position that chose a served token, the reference's best less its
  logit of the token the control puts first, over the row's rms).

The control has to fail one of the cell's numbers on every seed.  It needs
the cell's card:

    python3 perfbench/control.py --workload <cell> --seed <n> [<n> ...]
"""

from __future__ import annotations

import math
import time

from . import check, program

#: float8 e4m3's largest finite value.
E4M3_MAX = 448.0


def fp8_round(torch):
    def rnd(x):
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return rnd


def control_gap(want, control, lengths, start: int) -> float:
    """The widest ``(best - want[control's first]) / rms`` over the rows
    ``start .. start + length - 1`` of every request."""
    n = int(lengths.max())
    rows, crow = want[:, start:start + n], control[:, start:start + n]
    pick = crow.argmax(-1)
    best = rows.max(-1).values
    got = rows.gather(-1, pick[..., None])[..., 0]
    gap = (best - got) / check.rms(rows)[..., 0]
    col = pick.new_tensor(range(n))[None, :]
    return float(gap.masked_fill(col >= lengths[:, None], -math.inf).max())


def reading(cell, seed: int, device: str = "cuda", lmref=None,
            state=None) -> dict:
    """The program's and the control's numbers on one seed (``lmref`` and
    ``state`` as the runner's)."""
    import torch

    from .runner import LMREF, Run

    cfg, traffic = cell.config, cell.traffic
    run = Run(cell, None, 0.0, device=device, lmref=lmref or LMREF,
              state=state)
    ref, port, params, dev = run.setup(seed)
    batch = run.requests(traffic, seed, 0)
    rows = program.logit_rows(batch[1], seed, 0,
                              traffic["check"]["logit_rows"])
    with program.captured(run.engine.ServeEngine) as capture:
        capture.new_call(rows=rows)
        served = run.serve(port, params, traffic, batch)
    run.clear_state()
    t = time.perf_counter()
    plen, V = traffic["prompt_len"], cfg["vocab_size"]
    seq, lengths = check.padded(
        torch, [list(map(int, batch[0][j])) + served[f"r{j}"] for j in rows],
        dev)
    want = check.reference_logits(torch, ref, cfg, params, seq)
    share = check.rows_share(capture.call, want, lengths, V)
    gap = float(check.served_gaps(want, seq[:, plen:], lengths - plen,
                                  plen - 1).max())
    ctl = check.reference_logits(torch, ref, cfg, params, seq,
                                 fp8_round(torch))
    own = (torch.arange(seq.shape[1], device=dev)[None, :]
           < lengths[:, None])
    out = {"workload": cell.name, "seed": seed,
           "program": {"logits": share, "served_gap": gap},
           "control": {"logits": check.logits_share(ctl[own], want[own]),
                       "served_gap": control_gap(want, ctl, lengths - plen,
                                                 plen - 1)},
           "limits": {k: traffic["limits"][k]
                      for k in ("logits", "served_gap")},
           "steps": len(capture.call), "seconds": time.perf_counter() - t}
    lim = out["limits"]
    out["control_fails"] = any(out["control"][k] > lim[k] for k in lim)
    out["program_passes"] = all(out["program"][k] <= lim[k] for k in lim)
    return out


def main(cell, seeds, argv=()) -> int:
    """A line a seed; 1 if a seed's control would pass the check."""
    import json

    if argv:
        raise SystemExit(f"perfbench: unknown arguments {list(argv)}")
    failed = 0
    for s in seeds:
        r = reading(cell, s)
        failed += not r["control_fails"]
        print(json.dumps(r), flush=True)
    return 1 if failed else 0
