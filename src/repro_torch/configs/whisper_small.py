"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (kv=12)
d_ff=3072 vocab=51865; conv audio frontend is a stub supplying precomputed
frame embeddings per the assignment. [arXiv:2212.04356; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
)
