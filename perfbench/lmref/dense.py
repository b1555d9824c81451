"""The dense family's plain reference: a decoder-only transformer as the
Qwen3 and Llama model cards describe it, in plain ``torch`` float32 with
TF32 off, with no cache, no kernel and no batching trick.

Each layer: ``h = RMSNorm(x) * ln1``; ``q, k, v = h wq (+ bq), h wk (+ bk),
h wv (+ bv)`` split into heads of ``head_dim``; with ``qk_norm`` each head of
q and k RMS-normed over its ``head_dim`` and scaled by ``q_norm``,
``k_norm``; rotary embeddings on q and k (the half-split layout:
``[x1 cos - x2 sin, x2 cos + x1 sin]`` at angle ``pos * theta^(-2i/d)``);
causal softmax attention at scale ``1/sqrt(head_dim)``, query head ``h``
reading key-value head ``h // (heads / kv_heads)``; the heads joined and
projected by ``wo`` onto the residual; then ``h = RMSNorm(x) * ln2`` and
the SwiGLU MLP ``(silu(h w_gate) * (h w_up)) w_down`` onto the residual.
After the last layer ``RMSNorm(x) * final_norm`` and the head: ``lm_head``,
or ``embed`` transposed where the embeddings are tied.

It reads the configuration file's published keys and a parameter tree the
benchmark made, with the leaves named as ``param_shapes`` names them (the
harness holds those names and shapes equal to the program's before a run).
It imports ``torch`` alone.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

F32 = torch.float32


def dims(cfg: dict) -> dict:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], D=d, H=h,
                KV=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // h,
                F=cfg["intermediate_size"],
                rows=cfg.get("vocab_rows", cfg["vocab_size"]),
                V=cfg["vocab_size"])


def param_shapes(cfg: dict) -> dict:
    """Every leaf's shape by its dotted name; a layer's leaves carry a
    leading dimension of the layers."""
    n = dims(cfg)
    L, D, H, KV, hd, F = n["L"], n["D"], n["H"], n["KV"], n["hd"], n["F"]
    layer = {"ln1": (D,), "ln2": (D,), "attn.wq": (D, H * hd),
             "attn.wk": (D, KV * hd), "attn.wv": (D, KV * hd),
             "attn.wo": (H * hd, D), "mlp.w_gate": (D, F),
             "mlp.w_up": (D, F), "mlp.w_down": (F, D)}
    if cfg.get("attention_bias"):
        layer |= {"attn.bq": (H * hd,), "attn.bk": (KV * hd,),
                  "attn.bv": (KV * hd,)}
    if cfg.get("qk_norm"):
        layer |= {"attn.q_norm": (hd,), "attn.k_norm": (hd,)}
    shapes = {f"layers.{k}": (L, *v) for k, v in layer.items()}
    shapes |= {"embed": (n["rows"], D), "final_norm": (D,)}
    if not cfg.get("tie_word_embeddings"):
        shapes["lm_head"] = (D, n["rows"])
    return shapes


def param_init(name: str) -> tuple[float, float]:
    """The mean and standard deviation the benchmark draws a leaf from:
    the norms' scales about 1, every other leaf about 0."""
    base = name.rsplit(".", 1)[-1]
    if base.startswith("ln") or base.endswith("norm"):
        return 1.0, 0.1
    return 0.0, 0.02


def attention_flops(cfg: dict, positions: int) -> float:
    """The attention term of one sequence of ``positions`` fed tokens, each
    scored against itself and every earlier one: per layer and head,
    ``2 head_dim`` for q k and ``2 head_dim`` for p v a key."""
    n = dims(cfg)
    keys = positions * (positions + 1) // 2
    return 4.0 * n["L"] * n["H"] * n["hd"] * keys


@contextmanager
def exact_f32():
    """float32 products without TF32, as the reference has them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x: (B, heads, S, hd) at positions 0..S-1."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(cfg: dict, p: dict, x):
    """One layer on x (B, S, D) float32; ``p``: the layer's leaves in f32."""
    n = dims(cfg)
    b, s, _ = x.shape
    H, KV, hd = n["H"], n["KV"], n["hd"]
    eps = cfg.get("rms_norm_eps", 1e-6)
    theta = cfg.get("rope_theta", 10000.0)
    h = rms_norm(x, p["ln1"], eps)
    q, k, v = h @ p["attn.wq"], h @ p["attn.wk"], h @ p["attn.wv"]
    if cfg.get("attention_bias"):
        q, k, v = q + p["attn.bq"], k + p["attn.bk"], v + p["attn.bv"]
    q = q.view(b, s, H, hd).transpose(1, 2)
    k = k.view(b, s, KV, hd).transpose(1, 2)
    v = v.view(b, s, KV, hd).transpose(1, 2)
    if cfg.get("qk_norm"):
        q = rms_norm(q, p["attn.q_norm"], eps)
        k = rms_norm(k, p["attn.k_norm"], eps)
    q, k = rope(q, theta), rope(k, theta)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    sc = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    sc = sc.masked_fill(~causal, -math.inf)
    a = (torch.softmax(sc, dim=-1) @ v).transpose(1, 2).reshape(b, s, H * hd)
    x = x + a @ p["attn.wo"]
    h = rms_norm(x, p["ln2"], eps)
    mlp = torch.nn.functional.silu(h @ p["mlp.w_gate"]) * (h @ p["mlp.w_up"])
    return x + mlp @ p["mlp.w_down"]


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _leaves(v, f"{prefix}{k}.")
        else:
            out[prefix + k] = v
    return out


def hidden(cfg: dict, params: dict, tokens, layer_out=None):
    """The final-normed hidden states (B, S, D) float32 of ``tokens`` (B, S)
    from position 0, layer by layer (each layer's leaves widened to f32 in
    turn); ``layer_out``, if given, is applied to every layer's output."""
    n = dims(cfg)
    flat = _leaves(params["layers"])
    with exact_f32():
        x = params["embed"][tokens].to(F32)
        for i in range(n["L"]):
            x = layer(cfg, {k: v[i].to(F32) for k, v in flat.items()}, x)
            if layer_out is not None:
                x = layer_out(x)
        return rms_norm(x, params["final_norm"].to(F32),
                        cfg.get("rms_norm_eps", 1e-6))


def head(cfg: dict, params: dict):
    """The output head (D, rows), in the parameters' dtype."""
    return params["embed"].T if cfg.get("tie_word_embeddings") \
        else params["lm_head"]
