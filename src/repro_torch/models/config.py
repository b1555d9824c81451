"""Model configuration for every architecture family in the zoo.

A copy of the JAX package's ``repro.models.config``, field for field, so a
config carries across unchanged (``repro_torch.convert.model_config_from_fields``).
One field reads differently here: ``use_pallas_attention`` selects the
port's hand-written CUDA attention kernel (``kernels/csrc/flash_attention.cu``)
on the card and its plain PyTorch version on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0             # 0 => d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0             # per-expert FFN width
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    moe_group_size: int = 256     # tokens per GShard dispatch group
    # -- SSM (Mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # -- hybrid (zamba2): shared attention block applied every N mamba blocks
    attn_every: int = 0
    # -- encoder-decoder (whisper) / VLM (internvl) ---------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper: 30s of audio at 50 fps
    num_patches: int = 0          # internvl: stub ViT patch embeddings
    # -- misc -----------------------------------------------------------------
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    #: KV-cache storage dtype ("" = compute dtype). float8_e4m3fn halves
    #: decode's dominant HBM term; dequant fuses into the attention tiles.
    kv_dtype: str = ""
    # attention chunking (flash-style blockwise attention)
    q_chunk: int = 1024
    k_chunk: int = 1024
    # remat policy for the scanned layer stack: none | full | dots
    remat: str = "full"
    #: in the port: run attention through ``kernels.flash_attention`` -- the
    #: CUDA kernel on CUDA tensors, its plain PyTorch version on CPU
    #: tensors (the name is kept so a config carries across field for
    #: field); False runs ``layers.blockwise_attention`` on either device
    use_pallas_attention: bool = False

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 16 so embedding/head shard over
        the model axis (Megatron-style; pad logits masked in the loss)."""
        return -(-self.vocab_size // 16) * 16

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def scaled_down(self, **overrides) -> "ModelConfig":
        """A reduced config of the same family for CPU smoke tests."""
        small = dict(
            num_layers=2,
            d_model=64,
            num_heads=max(4, 0 if not self.num_heads else 4),
            num_kv_heads=0 if not self.num_kv_heads else
            (4 if self.num_kv_heads >= self.num_heads else 2),
            head_dim=16 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            moe_d_ff=64 if self.moe_d_ff else 0,
            num_experts=min(self.num_experts, 4),
            experts_per_tok=min(self.experts_per_tok, 2),
            moe_group_size=32,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=min(self.attn_every, 1) if self.attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else 1500,
            num_patches=8 if self.num_patches else 0,
            q_chunk=16,
            k_chunk=16,
            param_dtype="float32",
            compute_dtype="float32",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)


# Shape cells assigned to every LM architecture.
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

#: Families with sub-quadratic sequence mixing (may run long_500k).
SUBQUADRATIC = ("ssm", "hybrid")
