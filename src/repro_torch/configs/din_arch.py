"""din [recsys]: embed_dim=18, seq_len=100, attention MLP 80-40,
MLP 200-80, target attention [arXiv:1706.06978].

Tables sized for the huge-embedding regime: 10M items, 100k categories.
On one H100 both tables (727.2 MB in float32) sit whole on the card."""

from ..models.recsys.din import DINConfig
from .base import DINArch

CONFIG = DINConfig(
    name="din",
    n_items=10_000_000, n_cats=100_000, embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80),
)

SMOKE = DINConfig(
    name="din-smoke",
    n_items=1_000, n_cats=50, embed_dim=8, seq_len=10,
    attn_mlp=(16, 8), mlp=(24, 12),
)

ARCH = DINArch("din", CONFIG, SMOKE)
