"""Preemption-safe batched serving on the PyTorch port: generation survives
a kill because every emitted token is committed through a
loop-continuation cursor.  The twin of ``examples/serve_preemptible.py``
at the same widths.

  PYTHONPATH=src python examples/serve_preemptible_torch.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np    # noqa: E402

from repro_torch.configs import get_config          # noqa: E402
from repro_torch.models import get_model            # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("llama3-8b").scaled_down(num_layers=2, d_model=64,
                                              vocab_size=512, d_ff=128)
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=args.device)
    state = Path(tempfile.mkdtemp(prefix="repro_serve_"))
    reqs = lambda: [Request(f"req{i}", rng_i.integers(0, 512, 8).tolist(), 16)
                    for i, rng_i in
                    enumerate([np.random.default_rng(s) for s in range(4)])]

    print("== serving 4 requests; preempting after 5 tokens")
    eng = ServeEngine(cfg, params, state, max_len=32)
    try:
        eng.run(reqs(), fail_after_tokens=5)
    except RuntimeError:
        print("   !! preempted (spot instance reclaimed)")
    print("== new replica resumes from the durable cursors")
    out = ServeEngine(cfg, params, state, max_len=32).run(reqs())
    for rid, toks in sorted(out.items()):
        print(f"   {rid}: {toks}")
    ref = ServeEngine(cfg, params, Path(tempfile.mkdtemp()), max_len=32
                      ).run(reqs())
    print(f"   identical to an unpreempted run: {out == ref}")
    return out, ref


if __name__ == "__main__":
    main()
