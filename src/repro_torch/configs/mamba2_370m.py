"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50_280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
)
