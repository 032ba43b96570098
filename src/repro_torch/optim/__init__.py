"""Optimizers of the port: AdamW (``repro/optim/adamw.py``'s rule)."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm, state_from_numpy)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "state_from_numpy"]
