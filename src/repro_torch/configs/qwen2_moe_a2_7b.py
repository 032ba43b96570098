"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B]."""

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=151_936, act="silu", qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408, num_shared=4,
                  capacity_factor=1.25),
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="qwen2-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512, act="silu", qkv_bias=True,
    moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=32, num_shared=2),
    dtype="float32",
)

ARCH = LMArch("qwen2-moe-a2.7b", CONFIG, SMOKE)
