"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b]."""

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab=100_352, act="silu", qkv_bias=False,
    rope_theta=10_000.0,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, d_head=8,
    d_ff=160, vocab=512, act="silu", dtype="float32",
)

ARCH = LMArch("stablelm-1.6b", CONFIG, SMOKE)
