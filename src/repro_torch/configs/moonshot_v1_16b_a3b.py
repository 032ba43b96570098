"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6, 2 shared (kimi/moonlight)
[hf:moonshotai/Moonlight-16B-A3B]."""

from ..models.moe import MoEConfig
from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=163_840, act="silu", qkv_bias=False,
    rope_theta=50_000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
                  capacity_factor=1.25),
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="moonshot-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512, act="silu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1),
    dtype="float32",
)

ARCH = LMArch("moonshot-v1-16b-a3b", CONFIG, SMOKE)
