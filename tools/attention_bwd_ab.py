#!/usr/bin/env python3
"""K6's backward (``csrc/flash_attention_bwd.cu``, route A) at the three LM
layer-0 shapes on one NVIDIA card, for comparing two trees of the port on
the same card:

    python3 tools/attention_bwd_ab.py OLD
    python3 tools/attention_bwd_ab.py .
    python3 tools/attention_bwd_ab.py .
    python3 tools/attention_bwd_ab.py OLD

The argument is the root of a checkout (``.`` for this one); run each in
its own process. It builds that tree's kernels and prints the card's name
and power limit, then ptxas's registers, spills and stack of each route-A
kernel as built (``-Xptxas -v``), with its dynamic shared memory where the
tree reports it. Then, at gemma-2b's, stablelm-1.6b's and qwen1.5-32b's
train_4k layer 0 (B 1, S 4,096, causal; 8 query heads on 1 KV head at Dh
256, 32 on 32 at Dh 64, 40 on 40 at Dh 128; bf16 q, k, v and dO from
seed 0, o and the logsumexp from K6's forward):

* the whole call and each kernel alone (``bwd_dot``, the dK/dV kernel with
  its fold, the dQ kernel), L2 warm (after a run of the same) and cold
  (after a 64 MiB write that evicts the 50 MB L2): the device time of one
  run by CUDA events, the card held by a sleep while the host queues it,
  the median of REPS after WARM;
* the call taken in turns with ``F.scaled_dot_product_attention``'s
  backward on the same inputs (TURNS rounds of call, SDPA, SDPA, call,
  each timed so, L2 warm; medians, and their ratio);
* the bound: 10 Dh flops a visible pair at 989 TFLOP/s (bf16 dense);
* the largest difference from the float32 plain version, against its
  largest entry (a sanity check; ``chip_smoke.py`` holds the limits).

Each shape ends with one JSON line.

With ``--variants`` (``python3 tools/attention_bwd_ab.py --variants
ROOT``) it times the dK/dV and dQ kernels of ROOT's source as it is and of
copies edited in one place each (:data:`VARIANTS`: a kernel without one
of its products, or without its producer's copies of the streamed tiles),
at gemma-2b's and stablelm-1.6b's shapes, L2 warm. Each copy is built
with ROOT's nvcc flags into ``build/tools/`` and called through ROOT's own
wrapper; a variant whose text is not in ROOT's source is listed as such
and skipped. The times of a kernel without a part bound what that part
costs; the variants do not compute the gradients.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPS, WARM, TURNS = 20, 3, 5
SLEEP_CYCLES = 5_000_000          # ~3 ms at the H100's clock
SHAPES = {"gemma-2b": (1, 4096, 8, 1, 256),
          "stablelm-1.6b": (1, 4096, 32, 32, 64),
          "qwen1.5-32b": (1, 4096, 40, 40, 128)}
BF16_FLOPS_PER_S = 989e12
FLUSH_BYTES = 64 << 20
ROUTE_A = ("bwd_dot", "bwd_dkdv", "bwd_dq", "bwd_fold")
SRC = "flash_attention_bwd.cu"

# name -> ((text as it is, text instead), ...), edits of SRC
VARIANTS: dict[str, tuple[tuple[str, str], ...]] = {
    "as built": (),
    "dkdv without dV, dK products": ((
        "      wgmma_rs<DH>(acc, hi[kk], od + ((kk * 16 * kPanelRow) >> 4));\n"
        "      wgmma_rs<DH>(acc, lo[kk], od + ((kk * 16 * kPanelRow) >> 4));\n",
        ""),),
    "dkdv without S^T, dP^T products": ((
        "      wgmma_ss<64>(sc, ad + off, bd + off, kk > 0);\n", ""),),
    "dkdv without Q, dO copies": ((
        "      mbar_arrive_tx(full + s, 2 * G::kTile);\n"
        "      for (int p = 0; p < G::kPanels; ++p) {\n"
        "        tma_load(&qmap,",
        "      mbar_arrive(full + s);\n"
        "      for (int p = 0; p < 0; ++p) {\n"
        "        tma_load(&qmap,"),),
    "dq without dQ product": ((
        "      wgmma_rs<DH>(acc, hi[kk], bd + ((kk * 16 * kPanelRow) >> 4));\n"
        "      wgmma_rs<DH>(acc, lo[kk], bd + ((kk * 16 * kPanelRow) >> 4));\n",
        ""),),
    "dq without S, dP products": ((
        "      wgmma_ss<KQ>(sc, qd + qo, kd + ko, kk > 0);\n"
        "      wgmma_ss<KQ>(dp, gd + qo, vd + ko, kk > 0);\n", ""),),
    "dkdv without the lse, D copies": ((
        "      cp_async4(ls + s * kRowsA + j, lse + x, ok);\n"
        "      cp_async4(dd + s * kRowsA + j, dsum + x, ok);\n", ""),),
    "no exp": (("ok ? ex2(", "ok ? ("),),
    "two stages": ((
        "  static constexpr int kStages = DH >= 256 ? 2 : 4;",
        "  static constexpr int kStages = 2;"), (
        "  static constexpr int kDqStages = DH >= 256 ? 2 : 3;",
        "  static constexpr int kDqStages = 2;")),
    "dq with four stages below Dh 256": ((
        "  static constexpr int kDqStages = DH >= 256 ? 2 : 3;",
        "  static constexpr int kDqStages = DH >= 256 ? 2 : 4;"),),
    "dq without its turns": (
        ("    bar_sync(kBarTurn + wg, kThreadsA);\n", ""),
        ("    bar_arrive(kBarTurn + 1 - wg, kThreadsA);\n", ""),
        ("  if (wg == 1 && n_kt > 0) bar_arrive(kBarTurn, kThreadsA);\n", ""),
        ("  if (wg == 0 && n_kt > 0) bar_sync(kBarTurn, kThreadsA);\n", "")),
    "dq without K, V copies": ((
        "    mbar_arrive_tx(full + s, 2 * G::kDqKV);\n"
        "    for (int p = 0; p < G::kPanels; ++p) {",
        "    mbar_arrive(full + s);\n"
        "    for (int p = 0; p < 0; ++p) {"),),
}


def print_ptxas(log: str) -> None:
    """Registers, spills and stack of each route-A kernel (bf16 instances)
    as built, from nvcc -Xptxas -v."""
    fn, spills = None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            spills = (f"stack {m.group(1)}, spill stores {m.group(2)}, "
                      f"loads {m.group(3)}")
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and fn:
            # route A's kernels are templated on Dh alone (route B's on T)
            if any(k in fn for k in ROUTE_A) and "ILi" in fn:
                print(f"ptxas {fn}: {m.group(1)} registers{m.group(2)}; "
                      f"{spills}")
            fn = None


def device_ms(fn, flush=None) -> float:
    """The device time of one run of ``fn`` by CUDA events: the card is
    held by a sleep while the host queues the run (so that no host time
    falls between the events), after ``flush`` where given (else after a
    run of ``fn``, which leaves the L2 warm); the median of REPS."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(WARM + REPS):
        if flush is None:
            fn()
        else:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times[WARM:])


def bound_ms(B: int, S: int, Hq: int, Dh: int) -> float:
    pairs = S * (S + 1) // 2
    return 10.0 * Dh * B * Hq * pairs / BF16_FLOPS_PER_S * 1e3


def build_variants(root: Path, build_mod) -> dict:
    """Each variant of ROOT's source built in parallel into build/tools/:
    name -> library path (None where its text is not in the source)."""
    text = (build_mod.CSRC / SRC).read_text()
    out_dir = root / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        src = text
        if any(old not in src for old, _ in edits):
            paths[name] = None
            continue
        for old, new in edits:
            src = src.replace(old, new)
        cu = out_dir / f"fab_variant{i}.cu"
        cu.write_text(src)
        lib = out_dir / f"libfab_variant{i}.so"
        cmd = [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS,
               f"-I{build_mod.CSRC}", "-o", str(lib), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
        paths[name] = lib
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return paths


def run_variants(root: Path) -> int:
    import ctypes

    import torch

    from repro_torch.kernels import _build, flash_attention
    from repro_torch.kernels import flash_attention_bwd as fab

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {root}; variants")
    _build.build(["flash_attention"])
    paths = build_variants(root, _build)
    dev = torch.device("cuda")
    kept = fab._lib
    for shape in ("gemma-2b", "stablelm-1.6b"):
        B, S, Hq, Hkv, Dh = SHAPES[shape]
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((B, S, Hq, Dh), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        dout = torch.randn((B, S, Hq, Dh), generator=g, device=dev,
                           dtype=torch.bfloat16)
        o, lse = flash_attention.flash_attention_cuda(q, k, v,
                                                      return_lse=True)
        dsum = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        fab.flash_attention_bwd_cuda(q, k, v, o, lse, dout, kernels=("dot",),
                                     dsum=dsum)
        for name, path in paths.items():
            if path is None:
                print(f"  {shape} {name}: not in this source")
                continue
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in fab._SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            fab._lib = lambda lib=lib: lib
            try:
                t = {kn: device_ms(lambda kn=kn: fab.flash_attention_bwd_cuda(
                    q, k, v, o, lse, dout, kernels=(kn,), dsum=dsum))
                    for kn in ("dkdv", "dq")}
            finally:
                fab._lib = kept
            print(f"  {shape} {name}: dkdv {t['dkdv']:.4f} ms, dq "
                  f"{t['dq']:.4f} ms  [{card}]", flush=True)
        del q, k, v, o, lse, dout, dsum
        torch.cuda.empty_cache()
    return 0


def main(argv: list[str]) -> int:
    root = Path(argv[-1] if argv else ".").resolve()
    sys.path.insert(0, str(root / "src"))
    sys.modules["jax"] = None
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--variants"]:
        return run_variants(root)
    from repro_torch.kernels import _build, flash_attention, ref
    from repro_torch.kernels import flash_attention_bwd as fab

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {root}")
    _build.build(["flash_attention", "flash_attention_bwd"])
    print_ptxas(_build.log_path("flash_attention_bwd").read_text())
    if hasattr(fab, "shared_bytes"):
        for Dh in fab.MMA_HEAD_DIMS:
            print(f"dynamic shared memory at Dh {Dh}: {fab.shared_bytes(Dh)}")
    dev = torch.device("cuda")
    junk = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        junk.fill_(1)

    for name, (B, S, Hq, Hkv, Dh) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((B, S, Hq, Dh), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, Dh), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        dout = torch.randn((B, S, Hq, Dh), generator=g, device=dev,
                           dtype=torch.bfloat16)
        o, lse = flash_attention.flash_attention_cuda(q, k, v,
                                                      return_lse=True)
        bwd = fab.flash_attention_bwd_cuda
        got = bwd(q, k, v, o, lse, dout)
        want = ref.flash_attention_bwd_ref(q, k, v, o, dout)
        rel = [float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for a, b in zip(got, want)]
        del got, want
        dsum = torch.empty(lse.shape, dtype=torch.float32, device=dev)
        bwd(q, k, v, o, lse, dout, kernels=("dot",), dsum=dsum)
        parts = {kn: (lambda kn=kn: bwd(q, k, v, o, lse, dout,
                                        kernels=(kn,), dsum=dsum))
                 for kn in fab.KERNELS}
        call = lambda: bwd(q, k, v, o, lse, dout)   # noqa: E731
        warm = {"call": device_ms(call),
                **{kn: device_ms(fn) for kn, fn in parts.items()}}
        cold = {"call": device_ms(call, flush),
                **{kn: device_ms(fn, flush) for kn, fn in parts.items()}}
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=Hq != Hkv)
        gt = dout.transpose(1, 2)
        sdpa = lambda: torch.autograd.grad(   # noqa: E731
            out, (qt, kt, vt), gt, retain_graph=True)
        mine, theirs = [], []
        for _ in range(TURNS):
            mine.append(device_ms(call))
            theirs.append(device_ms(sdpa))
            theirs.append(device_ms(sdpa))
            mine.append(device_ms(call))
        del out, qt, kt, vt
        m_ms, s_ms = statistics.median(mine), statistics.median(theirs)
        bound = bound_ms(B, S, Hq, Dh)
        print(f"{name} B={B} S={S} Hq={Hq} Hkv={Hkv} Dh={Dh} route "
              f"{fab.route(q.dtype, Dh)}: warm ms " + ", ".join(
                  f"{kn} {t:.4f}" for kn, t in warm.items())
              + "; cold ms " + ", ".join(f"{kn} {t:.4f}"
                                         for kn, t in cold.items())
              + f"; in turns: call {m_ms:.4f} ms, sdpa backward {s_ms:.4f} "
              f"ms, ratio {m_ms / s_ms:.3f}; bound {bound:.4f} ms "
              f"(operations); max |diff| / max |plain f32| dQ {rel[0]:.2e} "
              f"dK {rel[1]:.2e} dV {rel[2]:.2e}  [{card}]", flush=True)
        print(json.dumps({"shape": name, "tree": str(root), "card": card,
                          "warm_ms": warm, "cold_ms": cold,
                          "turns_ms": m_ms, "sdpa_ms": s_ms,
                          "ratio": m_ms / s_ms, "bound_ms": bound,
                          "rel_diff": rel}))
        del q, k, v, o, lse, dout, dsum
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
