"""Optimizers of the port: AdamW (``repro/optim/adamw.py``'s rule) and the
int8 gradient compression with error feedback (``repro/optim/compress.py``)."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    global_norm, state_from_numpy)
from .compress import (CompressState, compress_grads, dequantize, quantize,
                       step_noise)
from .compress import init_state as compress_init

__all__ = ["AdamWConfig", "AdamWState", "CompressState", "adamw_init",
           "adamw_update", "compress_grads", "compress_init", "dequantize",
           "global_norm", "quantize", "state_from_numpy", "step_noise"]
