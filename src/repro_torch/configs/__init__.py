"""Architecture registry of the port: ``get_arch(<id>)``.

Holds the architectures ported so far: the five LMs (two of them
mixture-of-experts) and DIN for their serving kinds, and the four GNNs
for the forward half of their train cells. The JAX package's other arch
entry (the PPR workload's) comes with a later slice, and asking for it
raises a ``KeyError`` that says so.
"""

from __future__ import annotations

from . import (dimenet_arch, din_arch, gcn_cora, gemma_2b, graphcast_arch,
               moonshot_v1_16b_a3b, pna_arch, qwen1_5_32b, qwen2_moe_a2_7b,
               stablelm_1_6b)
from .base import (DIN_SHAPES, GNN_SHAPES, LM_SHAPES, ArchDef, DINArch,
                   GNNArch, LMArch)

REGISTRY: dict[str, ArchDef] = {
    a.arch_id: a for a in [
        moonshot_v1_16b_a3b.ARCH,
        qwen2_moe_a2_7b.ARCH,
        stablelm_1_6b.ARCH,
        qwen1_5_32b.ARCH,
        gemma_2b.ARCH,
        din_arch.ARCH,
        pna_arch.ARCH,
        gcn_cora.ARCH,
        graphcast_arch.ARCH,
        dimenet_arch.ARCH,
    ]
}

# the JAX package's other arch id, ported in a later slice
LATER = ("ppr-fora",)


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id in LATER:
        raise KeyError(f"arch {arch_id!r} is not ported yet (a later slice "
                       f"of the port); have {sorted(REGISTRY)}")
    raise KeyError(f"unknown arch {arch_id!r}; have {sorted(REGISTRY)}")


__all__ = ["ArchDef", "DINArch", "DIN_SHAPES", "GNNArch", "GNN_SHAPES",
           "LATER", "LMArch", "LM_SHAPES", "REGISTRY", "get_arch"]
