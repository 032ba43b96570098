"""End-to-end LM training with the PyTorch/CUDA port: the reference's
~100M-parameter LM (``--preset lm100m``) for a few hundred steps.

Wraps the port's driver (``repro_torch.launch.train``), as
``examples/train_lm.py`` wraps the JAX package's: token pipeline -> train
step (the loss's gradient, attention through K6 and its backward on the
card) -> AdamW -> async checkpoints -> elastic restart on an injected
failure. On the card by default; ``--device cpu`` runs the plain versions
(a few minutes at the default 200 steps; use ``--steps 50`` for a smoke
run).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
        [--device cpu]
"""

import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    args = sys.argv[1:]
    defaults = ["--arch", "stablelm-1.6b", "--preset", "lm100m",
                "--batch", "4", "--seq", "128",
                "--ckpt-dir", "build/torch_lm100m",
                "--ckpt-every", "50", "--fail-at", "120:3"]
    if "--steps" not in " ".join(args):
        defaults += ["--steps", "200"]
    main(defaults + args)
