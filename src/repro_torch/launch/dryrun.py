"""Dry run of every (arch x shape) cell on the production meshes, without
XLA: the counterpart of the JAX package's ``repro.launch.dryrun``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--both-meshes] [--strategy tp|dp|ep] [--remat none|full|dots] [--force]

The JAX dry run lowers and compiles each cell for 256 or 512 forced host
devices and reads XLA's memory analysis, cost analysis and HLO.  The port
compiles no XLA, so it reports none of ``live_bytes``, ``xla_cost``,
``hlo`` or ``compile_s``; one process drives every shard and no
``torch.distributed`` process group is involved.  For each cell it
computes, on the abstract mesh of ``launch.mesh.make_production_mesh``:

  * ``status`` and ``skip_reason`` from ``models.cell_applicable``;
  * ``memory.state_bytes_per_device``: ``launch.shardings.sharded_bytes``
    of the parameters plus, for a train cell, the AdamW state under ZeRO-1,
    or, for a decode cell, the caches (``models.cache_spec_shapes``) -- the
    JAX dry run's arithmetic;
  * ``flops_global``: one step traced on torch's ``meta`` device (nothing
    allocated, no kernel launched) under
    ``torch.utils.flop_counter.FlopCounterMode`` at the cell's global batch
    and length: for a train cell ``loss_fn`` and its backward, for prefill
    the forward, for decode one ``decode_step``; printed beside
    ``models.counting.model_flops``.  Every layer of a stack is the same
    computation, so the count is affine in the layer counts: it is traced
    at one and two layers of each stack (super-blocks and tail of a hybrid
    model, encoder and decoder of an encdec one) and extrapolated to the
    published depth, which gives the full-depth trace's count exactly
    (``tests/test_torch_dryrun.py``);
  * ``memory.fits_hbm``: the state bytes against the visible card's
    ``total_memory``, or null where no card is visible.  The JAX record's
    16 GB is a TPU's memory, so it is not carried over.

A cell whose trace fails is written with ``status: "error"`` and the
reason.  Results are JSON files under ``--out`` (default: a directory in
the system's temporary directory), one a cell, so the matrix is
resumable.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..models import (cache_spec_shapes, cell_applicable, counting,
                      get_model, input_spec_shapes, shardctx)
from ..models.api import abstract_params
from ..models.config import SHAPES
from ..models.layers import dt
from ..optim import adamw
from .mesh import make_production_mesh, mesh_chips
from .shardings import (batch_spec, cache_specs, set_strategy,
                        sharded_bytes, spec_entry, tree_leaves,
                        tree_specs)

RESULTS_DIR = Path(tempfile.gettempdir()) / "repro_torch_dryrun"

META = torch.device("meta")


def _meta(shape, dtype_name: str) -> torch.Tensor:
    if dtype_name == "int32":
        return torch.zeros(shape, dtype=torch.long, device=META)
    return torch.empty(shape, dtype=dt(dtype_name), device=META)


def _meta_tree(spec_shapes: dict) -> dict:
    return {k: _meta(*v) for k, v in spec_shapes.items()}


def state_bytes(cfg, cell, mesh) -> int:
    """Per-device bytes of the cell's state on ``mesh``: the parameters,
    plus the AdamW state under ZeRO-1 (train) or the caches (decode)."""
    params = abstract_params(cfg)
    total = sharded_bytes(params, tree_specs(params, mesh), mesh)
    if cell.kind == "train":
        opt = adamw(lr=3e-4).init(params)
        total += sharded_bytes(opt, tree_specs(opt, mesh, zero1=True), mesh)
    elif cell.kind == "decode":
        shapes = cache_spec_shapes(cfg, cell)
        total += sharded_bytes(_meta_tree(shapes),
                               cache_specs(cfg, cell, mesh, shapes), mesh)
    return total


def _step(cfg, cell) -> None:
    """One step of the cell on meta tensors."""
    api = get_model(cfg)
    params = abstract_params(cfg)
    batch = _meta_tree(input_spec_shapes(cfg, cell))
    if cell.kind == "train":
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        api.loss_fn(cfg, params, batch).backward()
        return
    with torch.no_grad():
        if cell.kind == "prefill":
            if cfg.family == "encdec":
                api.forward(cfg, params, batch)
            elif cfg.family == "vlm":
                api.forward(cfg, params, batch["tokens"], batch["patches"])
            else:
                api.forward(cfg, params, batch["tokens"])
            return
        cache = _meta_tree(cache_spec_shapes(cfg, cell))
        api.decode_step(cfg, params, cache, batch["token"],
                        cell.seq_len - 1)


def traced_flops(cfg, cell) -> int:
    """The FLOPs ``FlopCounterMode`` counts over one step of ``cell`` at
    ``cfg``'s depth, traced on meta tensors."""
    with FlopCounterMode(display=False) as fc:
        _step(cfg, cell)
    return int(fc.get_total_flops())


def _depths(cfg) -> tuple:
    """(the published layer counts, a function giving ``cfg`` at other
    counts): one count per stack (encdec: encoder, decoder; hybrid:
    super-blocks, tail), or None where the stacks cannot be cut apart."""
    if cfg.family == "encdec":
        return ((cfg.encoder_layers, cfg.num_layers),
                lambda e, d: dataclasses.replace(cfg, encoder_layers=e,
                                                 num_layers=d))
    if cfg.family == "hybrid":
        a = cfg.attn_every
        if a < 3:                      # a tail of 2 would be a super-block
            return None
        n_super = cfg.num_layers // a
        return ((n_super, cfg.num_layers - n_super * a),
                lambda s, t: dataclasses.replace(cfg, num_layers=s * a + t))
    return (cfg.num_layers,), lambda n: dataclasses.replace(cfg, num_layers=n)


def step_flops(cfg, cell, extrapolate: bool = True) -> int:
    """``traced_flops`` of ``cell`` at the published depth: traced at one
    layer of every stack and at one more in each stack in turn, then
    extrapolated linearly (exact: the layers of a stack are the same
    computation); ``extrapolate=False`` or a model no deeper than the
    probes traces the full depth."""
    plan = _depths(cfg) if extrapolate else None
    if plan is None:
        return traced_flops(cfg, cell)
    counts, at = plan
    base = (1,) * len(counts)
    if sum(counts) <= sum(base) + len(counts):
        return traced_flops(cfg, cell)
    f0 = traced_flops(at(*base), cell)
    total = f0
    for i, n in enumerate(counts):
        probe = tuple(c + (j == i) for j, c in enumerate(base))
        total += (traced_flops(at(*probe), cell) - f0) * (n - 1)
    return total


def _rules(strategy: str, cell, mesh) -> dict:
    """The activation specs the JAX dry run installs for ``strategy``."""
    b = spec_entry(batch_spec(mesh, cell.global_batch))
    seq_ax = "model" if cell.kind in ("train", "prefill") else None
    if strategy == "dp":
        return dict(logits=(b, None, None), moe_xe=(b, None, None, None),
                    residual=(b, None, None), heads=(b, None, None, None),
                    heads_kv=(b, None, None, None),
                    ssm_heads=(b, None, None, None))
    if strategy == "ep":
        return dict(logits=(b, None, None),
                    moe_xe=("data", "model", None, None),
                    residual=(b, None, None), heads=(b, None, None, None),
                    heads_kv=(b, None, None, None),
                    ssm_heads=(b, None, None, None))
    return dict(logits=(b, None, "model"), moe_xe=(b, "model", None, None),
                residual=(b, seq_ax, None), heads=(b, "model", None, None),
                heads_kv=(b, "model", None, None),
                ssm_heads=(b, None, "model", None))


def run_cell(arch: str, shape: str, multi_pod: bool, cfg_override=None,
             strategy: str = "tp", remat: str = "") -> dict:
    """One cell's record (see the module docstring)."""
    set_strategy(strategy)
    cfg = cfg_override or get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape, "strategy": strategy,
           "remat": remat or cfg.remat,
           "mesh": "x".join(str(s) for s in mesh.shape.values()),
           "multi_pod": multi_pod, "chips": mesh_chips(mesh),
           "kind": cell.kind, "status": "ok"}
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        return rec

    state = state_bytes(cfg, cell, mesh)
    hbm = torch.cuda.get_device_properties(0).total_memory \
        if torch.cuda.is_available() else None
    rec["memory"] = {"state_bytes_per_device": int(state),
                     "hbm_bytes": hbm,
                     "fits_hbm": None if hbm is None else bool(state < hbm)}
    shardctx.set_rules(**_rules(strategy, cell, mesh))
    try:
        t0 = time.perf_counter()
        flops = step_flops(cfg, cell)
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
    finally:
        shardctx.clear()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model = counting.model_flops(cfg, tokens, cell.kind)
    rec["flops_global"] = flops
    rec["model_flops"] = model
    rec["flops_over_model_flops"] = flops / model
    return rec


def cell_list():
    return [(a, s) for a in ARCHS for s in SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "dp", "ep"])
    ap.add_argument("--remat", default="", choices=["", "none", "full",
                                                    "dots"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = cell_list() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    records = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}" + (
                f"__{args.strategy}" if args.strategy != "tp" else "") + (
                f"__{args.remat}" if args.remat else "")
            path = out_dir / f"{tag}.json"
            if path.exists() and not args.force:
                print(f"[cached] {tag}")
                records.append(json.loads(path.read_text()))
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp, strategy=args.strategy,
                               remat=args.remat)
            except Exception as e:           # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            path.write_text(json.dumps(rec, indent=1))
            records.append(rec)
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_fail += st == "error"
            if st == "ok":
                m = rec["memory"]
                print(f"  ok: state/dev="
                      f"{m['state_bytes_per_device'] / 2**30:.2f} GiB "
                      f"fits_hbm={m['fits_hbm']} "
                      f"flops={rec['flops_global']:.3e} "
                      f"model_flops={rec['model_flops']:.3e} "
                      f"trace={rec['trace_s']}s", flush=True)
            elif st == "skipped":
                print(f"  skipped: {rec['skip_reason']}")
            else:
                print(f"  ERROR: {rec['error']}")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return records


if __name__ == "__main__":
    main()
