"""End-to-end training driver on the PyTorch port: the twin of
``examples/train_llm.py`` at the same widths and steps.

Default runs a ~25M-param qwen3-family model for a few hundred steps;
pass ``--full`` for the ~100M-param configuration (same code path, longer
wall time), or use ``repro_torch.launch.train`` with ``--arch`` for any
of the 10 assigned architectures.

  PYTHONPATH=src python examples/train_llm_torch.py [--steps 200] [--full] \\
      [--device cpu]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config            # noqa: E402
from repro_torch.launch.train import train            # noqa: E402
from repro_torch.models.counting import param_count   # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="~100M params instead of ~25M")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("qwen3-0.6b")
    if args.full:
        cfg = base.scaled_down(
            num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=65536, q_chunk=128,
            k_chunk=128, moe_group_size=256)
    else:
        cfg = base.scaled_down(
            num_layers=4, d_model=256, num_heads=8, num_kv_heads=4,
            head_dim=32, d_ff=1024, vocab_size=32768, q_chunk=128,
            k_chunk=128)
    print(f"config: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} -> {param_count(cfg)/1e6:.1f}M params")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_llm_")
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=ckpt_dir, ckpt_interval=50, lr=1e-3,
                log_every=20, device=args.device)
    print(f"trained {res.steps_run} steps in {res.wall_s:.0f}s; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    return res


if __name__ == "__main__":
    main()
