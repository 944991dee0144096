"""Model configuration dataclass and the registry of the port's models.

A copy of the reference package's ``configs/base.py``, cut to what the
embedding-serving and generation paths read: ``ModelConfig`` with its
derived sizes, its ``smoke()`` reduced variant, ``get_config`` and the
serving steps' ``ShapeConfig``/``INPUT_SHAPES``.  The registry lists the
models the port serves so far: the two embedders, the decoder LMs
hymba-1.5b, stablelm-1.6b, starcoder2-7b, falcon-mamba-7b, internlm2-20b,
the MoE decoders granite-moe-3b-a800m and qwen3-moe-30b-a3b, internvl2-2b
(its vision frontend a stub of patch embeddings) and the encoder-decoder
whisper-tiny (its audio frontend a stub of frame embeddings), each with
its published dimensions.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, replace
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | vlm | audio | encoder
    block: str                # attn | mamba | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0         # 0 -> d_model // num_heads
    d_ff: int = 0             # dense FFN hidden (per-expert hidden for MoE)
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_dt_rank: int = 0      # 0 -> max(16, d_model // 16)
    ssm_conv: int = 4
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0   # 0 = full attention
    # --- enc-dec / modality frontend ---
    frontend: str = "none"    # none | vision | audio
    encoder_layers: int = 0
    cross_attention: bool = False
    num_patches: int = 256
    num_frames: int = 1500
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "silu"         # silu -> SwiGLU MLP; gelu -> plain GELU MLP
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    pool: str = "none"        # embedder pooling: none | cls | mean
    embed_dim: int = 0        # embedder output dim (bge: 1024)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(16, self.d_model // 16)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.block in ("attn", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.block in ("mamba", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return self.arch_type != "encoder"

    def smoke(self) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=128,
            vocab_size=512,
            head_dim=32,
        )
        if self.num_heads:
            changes["num_heads"] = 4
            changes["num_kv_heads"] = max(1, min(self.num_kv_heads, 2))
        if self.d_ff:
            changes["d_ff"] = 256 if not self.is_moe else 64
        if self.is_moe:
            changes["num_experts"] = 4
            changes["experts_per_token"] = 2
        if self.encoder_layers:
            changes["encoder_layers"] = 2
        if self.frontend == "vision":
            changes["num_patches"] = 16
        if self.frontend == "audio":
            changes["num_frames"] = 32
        if self.sliding_window:
            changes["sliding_window"] = 16
        if self.embed_dim:
            changes["embed_dim"] = 64
        return replace(self, **changes)

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# architecture id -> module name in this package
ARCH_MODULES = {
    "bge-large-zh-v1.5": "bge_large_zh",
    "jina-v2": "jina_v2",
    "hymba-1.5b": "hymba_1_5b",
    "stablelm-1.6b": "stablelm_1_6b",
    "starcoder2-7b": "starcoder2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internlm2-20b": "internlm2_20b",
    "qwen2-72b": "qwen2_72b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-2b": "internvl2_2b",
    "whisper-tiny": "whisper_tiny",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG
