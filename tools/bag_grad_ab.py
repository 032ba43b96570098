#!/usr/bin/env python3
"""K5's table gradient (``bag_grad_table``) at DIN's train shape on one
NVIDIA card, for comparing two trees of the port on the same card:

    python3 tools/bag_grad_ab.py OLD
    python3 tools/bag_grad_ab.py .
    python3 tools/bag_grad_ab.py .
    python3 tools/bag_grad_ab.py OLD

The argument is the root of a checkout (``.`` for this one); run each in
its own process. It builds that tree's kernels, makes B = 65,536 bags of
L = 100 ids (the port's ``RecsysStream`` at seed 0: Zipf ids, one item at
a quarter of the positions) into a 10M x 18 float32 table, random weights
and output gradient from seed 0, and prints one line: the kernel's device
microseconds a call (CUDA events around 20 queued calls, after 3) and
whether its dT has the bits of ``segment_reduce_cuda`` over the float32
products w[b, l] g[b], materialised, on the same plan (and how many cells
differ).
"""

from __future__ import annotations

import sys
from pathlib import Path

REPS, WARM = 20, 3
V, D, B, L = 10_000_000, 18, 65_536, 100


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.modules["jax"] = None
    import torch

    from repro_torch.data import RecsysStream
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_bag import embedding_bag_grad_cuda
    from repro_torch.kernels.segment_reduce import segment_reduce_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((V, D), generator=gen, device=dev)
    batch = next(iter(RecsysStream(n_items=V, n_cats=100_000, seq_len=L,
                                   batch=B, seed=0)))
    ids = torch.from_numpy(batch["hist_items"]).to(dev)
    w = torch.randn((B, L), generator=gen, device=dev)
    g = torch.randn((B, D), generator=gen, device=dev)
    plan = ops.segment_plan(ids.reshape(-1), V, keep_index=False)

    def run():
        return embedding_bag_grad_cuda(table, ids, w, g, plan.order,
                                       plan.keys, plan.offsets,
                                       weights_grad=False)[0]

    d_t = run().view(torch.int32)
    terms = (w[..., None] * g[:, None, :]).reshape(B * L, D)
    bits = segment_reduce_cuda(terms, plan.order, plan.keys, plan.offsets,
                               "sum").view(torch.int32)
    differ = int((d_t != bits).sum())
    del terms, bits
    for _ in range(WARM):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        run()
    stop.record()
    torch.cuda.synchronize()
    print(f"AB {root.name}: bag_grad_table "
          f"{start.elapsed_time(stop) / REPS * 1e3:.2f} us (queued events, "
          f"{REPS} reps); dT bits = segment_reduce over the products: "
          f"{differ == 0} ({differ} cells differ)")


if __name__ == "__main__":
    main()
