"""Architecture registry of the port: ``get_arch(<id>)``.

Holds the architectures ported so far, gemma-2b and DIN, for their serving
kinds. The JAX package's other architectures (the other LMs, the GNNs, the
PPR workload's arch entry) come with later slices, and asking for one
raises a ``KeyError`` that says so.
"""

from __future__ import annotations

from . import din_arch, gemma_2b
from .base import DIN_SHAPES, LM_SHAPES, ArchDef, DINArch, LMArch

REGISTRY: dict[str, ArchDef] = {
    a.arch_id: a for a in [gemma_2b.ARCH, din_arch.ARCH]
}

# the JAX package's other arch ids, ported in later slices
LATER = ("moonshot-v1-16b-a3b", "qwen2-moe-a2.7b", "stablelm-1.6b",
         "qwen1.5-32b", "pna", "gcn-cora", "graphcast", "dimenet",
         "ppr-fora")


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet (a later slice "
                       f"of the port); have {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")


__all__ = ["ArchDef", "DINArch", "DIN_SHAPES", "LATER", "LMArch",
           "LM_SHAPES", "REGISTRY", "get_arch"]
