"""PyTorch and CUDA port of the D&A / FORA system in ``repro``.

``repro_torch`` imports torch and numpy only: nothing of JAX and nothing of
the JAX package, whose numpy-only parts it keeps copies of. Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU, and
raise when asked for a card that is not there.
"""

from . import (checkpoint, configs, core, dyn, ft, index, kernels, models,
               ppr, serving)

__all__ = ["checkpoint", "configs", "core", "dyn", "ft", "index", "kernels",
           "models", "ppr", "serving"]
