"""Architecture registry of the port: ``get_arch(<id>)``.

Holds the architectures ported so far for their serving kinds: the five
LMs (two of them mixture-of-experts) and DIN. The JAX package's other
architectures (the GNNs, the PPR workload's arch entry) come with later
slices, and asking for one raises a ``KeyError`` that says so.
"""

from __future__ import annotations

from . import (din_arch, gemma_2b, moonshot_v1_16b_a3b, qwen1_5_32b,
               qwen2_moe_a2_7b, stablelm_1_6b)
from .base import DIN_SHAPES, LM_SHAPES, ArchDef, DINArch, LMArch

REGISTRY: dict[str, ArchDef] = {
    a.arch_id: a for a in [
        moonshot_v1_16b_a3b.ARCH,
        qwen2_moe_a2_7b.ARCH,
        stablelm_1_6b.ARCH,
        qwen1_5_32b.ARCH,
        gemma_2b.ARCH,
        din_arch.ARCH,
    ]
}

# the JAX package's other arch ids, ported in later slices
LATER = ("pna", "gcn-cora", "graphcast", "dimenet", "ppr-fora")


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet (a later slice "
                       f"of the port); have {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")


__all__ = ["ArchDef", "DINArch", "DIN_SHAPES", "LATER", "LMArch",
           "LM_SHAPES", "REGISTRY", "get_arch"]
