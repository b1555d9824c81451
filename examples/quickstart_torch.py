"""Quickstart on the PyTorch port: train a small LM with intermittence-safe
progress, kill it, resume it, and serve from it -- the whole system in one
script.  The twin of ``examples/quickstart.py`` at the same widths and
steps.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import SlotStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import SimulatedFailure, train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-0.6b").scaled_down(num_layers=2, d_model=64,
                                               vocab_size=512, d_ff=128)
    workdir = Path(tempfile.mkdtemp(prefix="repro_quickstart_"))
    print(f"== training (with an injected failure) in {workdir}")
    try:
        train(cfg, steps=30, batch=4, seq=32, ckpt_dir=workdir,
              ckpt_interval=10, fail_at_step=17, log_every=10,
              device=args.device)
    except SimulatedFailure as e:
        print(f"   !! {e} -- restarting (loop continuation resumes "
              f"from the last committed checkpoint)")
    res = train(cfg, steps=30, batch=4, seq=32, ckpt_dir=workdir,
                ckpt_interval=10, log_every=10, device=args.device)
    print(f"   resumed and finished: ran {res.steps_run} more steps, "
          f"loss -> {res.losses[-1]:.4f}")

    print("== serving the trained model (preemption-safe decode)")
    api = get_model(cfg)
    # the parameter tree gives the structure; the checkpoint's first leaves
    # (the parameters, before the optimizer state) fill it
    like = api.init_params(cfg, seed=0, device=args.device)
    params, meta = SlotStore(workdir / "state").restore(like=like)
    eng = ServeEngine(cfg, params, workdir / "serve", max_len=64)
    out = eng.run([Request("demo", [1, 2, 3, 4], max_new=12)])
    print(f"   generated: {out['demo']}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
