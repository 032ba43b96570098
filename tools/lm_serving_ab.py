#!/usr/bin/env python3
"""gemma-2b serving end to end on one NVIDIA card, for comparing two trees
of the port on the same card:

    python3 tools/lm_serving_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one); each runs in
its own process, in the order given, and prints one JSON line: gemma-2b at
full width and depth with random bf16 weights from seed 0, 4 prompts of
4,096 tokens prefilled (the median of 3, host clock to a device
synchronisation) and 32 greedy decode steps against a cache of 4,128
(median and mean a step), then one prefill and 4 decode steps under
``torch.profiler``: wall, device time and K6's device time (kernels whose
name holds ``flash_``), per call, and the card's idle share. The shapes
are phase 6 of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

B, S, STEPS, SLACK = 4, 4096, 32, 32


def leg(tree: str) -> dict:
    sys.path.insert(0, f"{tree}/src")
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer

    _build.build(["flash_attention"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    arch = get_arch("gemma-2b")
    params = arch.init_params(gen, dev)
    prompt = arch.make_inputs("prefill_32k", gen, dev, batch=B, seq=S)
    prefill = arch.build_step("prefill_32k")
    decode = arch.build_step("decode_32k")
    prefill(params, {"tokens": prompt["tokens"][:, :128]})      # warm up

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    pre = []
    for _ in range(3):
        t, (logits, kv) = timed(lambda: prefill(params, prompt))
        pre.append(t)
    cache = transformer.make_kv_cache(arch.cfg, B, S + SLACK, device=dev)
    cache[:, :, :, :S] = kv
    del kv
    token = logits.argmax(-1, keepdim=True).to(torch.int32)
    dec = []
    for t in range(STEPS):
        sec, (lg, _) = timed(lambda: decode(
            params, {"token": token, "kv_cache": cache, "cache_len": S + t}))
        dec.append(sec * 1e3)
        token = lg.argmax(-1, keepdim=True).to(torch.int32)

    def profiled(fn, calls: int) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = timed(lambda: [fn() for _ in range(calls)])
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        k6 = sum(e.time_range.elapsed_us() for e in ev
                 if "flash_" in e.name) / 1e3
        return {"wall_ms": wall * 1e3 / calls, "device_ms": busy / calls,
                "k6_ms": k6 / calls, "idle": 1 - busy / (wall * 1e3)}

    mid = sorted(pre)[1]
    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "prefill_s": mid, "prefill_tok_s": B * S / mid,
            "decode_ms_median": float(np.median(dec)),
            "decode_ms_mean": float(np.mean(dec)),
            "prefill_profile": profiled(lambda: prefill(params, prompt), 1),
            "decode_profile": profiled(lambda: decode(
                params, {"token": token, "kv_cache": cache,
                         "cache_len": S}), 4)}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--leg":
        print(json.dumps(leg(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        rc = subprocess.run([sys.executable, __file__, "--leg", tree]
                            ).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
