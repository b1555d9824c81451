"""zamba2-7b [hybrid]: 81 Mamba2 blocks, d_model=3584, shared attention
block (32H kv=32, d_ff=14336) applied every 6 blocks, ssm_state=64.
LoRA-per-invocation and embedding-concat of the real Zamba2 are omitted
(DESIGN.md section Arch-applicability). [arXiv:2411.15242; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    attn_every=6,
)
