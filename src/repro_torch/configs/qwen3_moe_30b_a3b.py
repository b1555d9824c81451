"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768
vocab=151936, MoE 128 experts top-8, qk_norm. [hf:Qwen/Qwen3-30B-A3B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    num_experts=128,
    experts_per_tok=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
