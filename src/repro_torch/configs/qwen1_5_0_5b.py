"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
)
