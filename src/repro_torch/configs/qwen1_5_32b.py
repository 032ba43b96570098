"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064, QKV bias [hf:Qwen/Qwen1.5-32B family]."""

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMConfig(
    name="qwen1.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_head=128,
    d_ff=27_392, vocab=152_064, act="silu", qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="qwen32b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=192, vocab=512, act="silu", qkv_bias=True, dtype="float32",
)

ARCH = LMArch("qwen1.5-32b", CONFIG, SMOKE)
