"""Batched serving driver.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
      --smoke --requests 4 --prompt-len 8 --max-new 16 [--device cpu]

Random weights from seed 0, prompts from numpy's seed 0, greedy tokens
printed a request a line.  ``--device`` defaults to ``cuda``; ``--smoke``
serves the config's ``scaled_down()`` widths.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

from ..configs import ARCHS, get_config
from ..models import get_model
from ..serving import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--state-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=args.device)
    state_dir = args.state_dir or tempfile.mkdtemp(prefix="repro_serve_")
    eng = ServeEngine(cfg, params, state_dir,
                      max_len=args.prompt_len + args.max_new + 1)
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}",
                    rng.integers(0, cfg.vocab_size,
                                 size=args.prompt_len).tolist(),
                    args.max_new)
            for i in range(args.requests)]
    out = eng.run(reqs)
    for rid, toks in out.items():
        print(f"{rid}: {toks}")
    return out


if __name__ == "__main__":
    main()
