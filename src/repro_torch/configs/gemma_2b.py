"""gemma-2b [dense]: 18L d_model=2048 8H MQA (kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, tied embeddings [arXiv:2403.08295]."""

from ..models.transformer import LMConfig
from .base import LMArch

CONFIG = LMConfig(
    name="gemma-2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16_384, vocab=256_000, act="gelu_tanh", qkv_bias=False,
    tie_embeddings=True, rope_theta=10_000.0,
    dtype="bfloat16",
)

SMOKE = LMConfig(
    name="gemma-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_head=32,
    d_ff=256, vocab=512, act="gelu_tanh", tie_embeddings=True,
    dtype="float32",
)

ARCH = LMArch("gemma-2b", CONFIG, SMOKE)
