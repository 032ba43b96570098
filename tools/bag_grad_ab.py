#!/usr/bin/env python3
"""K5's backward (``csrc/embedding_bag_grad.cu``) at DIN's train shape on
one NVIDIA card, for comparing two trees of the port on the same card:

    python3 tools/bag_grad_ab.py OLD
    python3 tools/bag_grad_ab.py .
    python3 tools/bag_grad_ab.py .
    python3 tools/bag_grad_ab.py OLD

The argument is the root of a checkout (``.`` for this one); run each in
its own process. It builds that tree's kernels, makes B = 65,536 bags of
L = 100 ids (the port's ``RecsysStream`` at seed 0: Zipf ids, one item at
a quarter of the positions) into a 10M x 18 float32 table, random weights
and output gradient from seed 0, and prints one line: the table
gradient's device microseconds a call (CUDA events around 20 queued
calls, after 3) and whether its dT has the bits of ``segment_reduce_cuda``
over the float32 products w[b, l] g[b], materialised, on the same plan
(and how many cells differ).

With ``--variants`` (``python3 tools/bag_grad_ab.py --variants ROOT``) it
times the split of both kernels instead, on the item table (10M x 18,
``hist_items``) and the category table (100k x 18, ``hist_cats``) of the
same batch: ROOT's source as it is, and copies of it edited in one place
each (:data:`VARIANTS`: level 1 alone, level 1 without its zero fill, the
fill alone, the weights' gradient with its table-row loads only, and so
on), each built with ROOT's nvcc flags into ``build/tools/`` and called
through ROOT's own wrapper. A variant whose text is not in ROOT's source
(it was written for another version of the kernels) is listed as such and
skipped, so one run on the parent and one on the change time the old and
the new design. Each time is queued CUDA events; each variant that still
computes the whole gradient says whether dT keeps ``segment_reduce``'s
bits. It prints the card's name and power limit first and ptxas's
registers and spills of each kernel as built.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

REPS, WARM = 20, 3
V, D, B, L = 10_000_000, 18, 65_536, 100
N_CATS = 100_000

# One edit of csrc/embedding_bag_grad.cu (or of a header it includes) a
# variant: name -> (part timed, whole gradient computed, ((file, text as it
# is, text instead), ...)). The old design's edits (the level-1 fold with
# the zero fill in its own warps, a group of lanes a dw) and the new
# design's (a staged level 1 beside fill blocks in the same launch, a lane
# a dw); each applies to the source that holds its text.
SRC = "embedding_bag_grad.cu"
LEVEL_1_ONLY = (SRC, "    if (err != cudaSuccess || last) return err;",
                "    if (err != cudaSuccess || last || level == 0) "
                "return err;")
# an edit that changes nothing, whose text only the old launcher holds: a
# variant with it applies to the old design's source alone
_OLD_CHECK = "(group & (group - 1)) != 0 || d / width > kUnitsALane * group) {"
OLD_WEIGHTS = (SRC, _OLD_CHECK, _OLD_CHECK)
NO_FILL = (SRC, "  const int fill = kFillPerSM * a.sms;",
           "  const int fill = 0;")
NO_FOLD = (SRC, "      const int64_t fold = used;",
           "      const int64_t fold = 0;")


def FILL_PER_SM(n: int) -> tuple[str, str, str]:
    return (SRC, "constexpr int kFillPerSM = 1;",
            f"constexpr int kFillPerSM = {n};")


def STAGED(n: int) -> tuple[str, str, str]:
    return (SRC, "constexpr int kStagedBlocks = 4;",
            f"constexpr int kStagedBlocks = {n};")


VARIANTS: dict[str, tuple[str, bool, tuple]] = {
    "table as built": ("table", True, ()),
    "table level 1 with its fill": ("table", False, (LEVEL_1_ONLY,)),
    # old: the fold's warps write the zeros after their runs
    "table level 1 without its fill (old)": ("table", False, (
        LEVEL_1_ONLY,
        (SRC, "      g, order, keys, nullptr, out, part, part_keys, offsets, "
              "n, S, d, R,",
         "      g, order, keys, nullptr, out, part, part_keys, nullptr, "
         "n, S, d, R,"))),
    "table fill alone (old)": ("table", False, (
        LEVEL_1_ONLY,
        (SRC, "      g, order, keys, nullptr, out, part, part_keys, offsets, "
              "n, S, d, R,",
         "      g, order, keys, nullptr, out, part, part_keys, offsets, "
         "0, S, d, R,"))),
    # new: fill blocks first in the level-1 grid, then the fold's blocks
    "table level 1 without its fill (new)": ("table", False, (
        LEVEL_1_ONLY, NO_FILL)),
    "table fill alone (new)": ("table", False, (LEVEL_1_ONLY, NO_FOLD)),
    "table fill alone, 2 blocks an SM (new)": ("table", False, (
        LEVEL_1_ONLY, NO_FOLD, FILL_PER_SM(2))),
    "table fill alone, every word written (new)": ("table", False, (
        LEVEL_1_ONLY, NO_FOLD,
        (SRC, "      if (words - w0 < 4) zero &= (1u << (words - w0)) - 1u;",
         "      zero = 0xfu;\n"
         "      if (words - w0 < 4) zero &= (1u << (words - w0)) - 1u;"))),
    "table level 1 fold, no g rows read (new)": ("table", False, (
        LEVEL_1_ONLY, NO_FILL,
        ("segment_units.cuh", "        const float2 t = __ldg(reinterpret_"
         "cast<const float2*>(row) + c);",
         "        const float2 t = make_float2(1.0f, 1.0f);"))),
    "table level 1 fold, no w read (new)": ("table", False, (
        LEVEL_1_ONLY, NO_FILL,
        ("segment_units.cuh", "  const float wr = live ? __ldg(w + r) : 0.0f;",
         "  const float wr = 1.0f;"))),
    "table level 1 formed as loaded (new)": ("table", True, (
        (SRC, "  if constexpr (V == 1) {\n    // a run a warp",
         "  if constexpr (false) {\n    // a run a warp"),)),
    "table fill blocks after the fold's (new)": ("table", True, (
        (SRC, "  if (blockIdx.x < fill_blocks) {",
         "  if (blockIdx.x >= gridDim.x - fill_blocks) {"),
        (SRC, "    fill_unnamed(offsets, out, S, d, blockIdx.x, fill_blocks);",
         "    fill_unnamed(offsets, out, S, d, blockIdx.x - (gridDim.x - "
         "fill_blocks), fill_blocks);"),
        (SRC, "      group, w, L, stage, stride, fill_blocks);",
         "      group, w, L, stage, stride, 0);"))),
    "table 2 fill blocks an SM (new)": ("table", True, (FILL_PER_SM(2),)),
    "table staged, 3 blocks an SM (new)": ("table", True, (STAGED(3),)),
    "table staged, 5 blocks an SM (new)": ("table", True, (STAGED(5),)),
    "weights as built": ("weights", True, ()),
    # old: a group of 4 lanes an item; new: a lane an item
    "weights row loads only (old)": ("weights", False, (
        OLD_WEIGHTS,
        (SRC, "            const float2 e = __ldg(reinterpret_cast<const "
              "float2*>(gb) + c);",
         "            const float2 e = make_float2(1.0f, 1.0f);"))),
    "weights ids and dw only, no rows read (new)": ("weights", False, (
        (SRC, "        const float2 a = __ldg(reinterpret_cast<const float2*>(row)"
              " + c);\n        t[2 * c] = a.x;",
         "        const float2 a = make_float2(1.0f, 1.0f);\n"
         "        t[2 * c] = a.x;"),)),
    "weights row loads only (new)": ("weights", False, (
        (SRC, "        const float2 e = reinterpret_cast<const float2*>(gs)"
              "[c];",
         "        const float2 e = make_float2(1.0f, 1.0f);"),)),
}


def build_variants(root: Path, build_mod, signatures) -> dict:
    """Each variant that applies to ROOT's source: name -> loaded library,
    built in parallel into build/tools/ (None where its text is not in
    the source)."""
    csrc = build_mod.CSRC
    out = build_mod.BUILD_DIR.parent / "tools"
    out.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for i, (name, (_, _, edits)) in enumerate(VARIANTS.items()):
        texts = {SRC: (csrc / SRC).read_text(),
                 "segment_units.cuh": (csrc / "segment_units.cuh").read_text()}
        if any(texts[f].count(old) != 1 for f, old, _ in edits):
            libs[name] = None
            continue
        for f, old, new in edits:
            texts[f] = texts[f].replace(old, new)
        vdir = out / f"bag_variant_{i}"
        vdir.mkdir(exist_ok=True)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        so = vdir / "lib.so"
        procs[name] = (subprocess.Popen(
            [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS, "-o", str(so),
             str(vdir / SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        print_ptxas(log, name)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def print_ptxas(log: str, name: str) -> None:
    """Registers and spills of each kernel as built, and of the level-1
    kernel at DIN's shape in a variant, from nvcc -Xptxas -v."""
    fn = None
    spills = ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            spills = (f"stack {m.group(1)}, spill stores {m.group(2)}, "
                      f"loads {m.group(3)}")
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            if name == "table as built" or "bag_table_firstILi1ELi1ELi32" in fn:
                print(f"ptxas [{name}] {fn}: {m.group(1)} registers, "
                      f"{spills}")
            fn = None


def events_us(fn) -> float:
    import torch

    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / REPS * 1e3


def main(argv: list[str]) -> int:
    variants = argv[:1] == ["--variants"]
    root = Path(argv[-1]).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.modules["jax"] = None
    import torch

    if not torch.cuda.is_available():
        print("bag_grad_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data import RecsysStream
    from repro_torch.kernels import _build, embedding_bag, ops
    from repro_torch.kernels.embedding_bag import embedding_bag_grad_cuda
    from repro_torch.kernels.segment_reduce import segment_reduce_cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = next(iter(RecsysStream(n_items=V, n_cats=N_CATS, seq_len=L,
                                   batch=B, seed=0)))
    w = torch.randn((B, L), generator=gen, device=dev)
    g = torch.randn((B, D), generator=gen, device=dev)
    cases = [("items", V, "hist_items")]
    if variants:
        cases.append(("cats", N_CATS, "hist_cats"))
        libs = build_variants(root, _build, embedding_bag._GRAD_SIGNATURES)
    else:
        libs = {"table as built": None}
    for case, rows, key in cases:
        table = torch.randn((rows, D), generator=gen, device=dev)
        ids = torch.from_numpy(batch[key]).to(dev)
        plan = ops.segment_plan(ids.reshape(-1), rows, keep_index=False)
        terms = (w[..., None] * g[:, None, :]).reshape(B * L, D)
        bits = segment_reduce_cuda(terms, plan.order, plan.keys, plan.offsets,
                                   "sum").view(torch.int32)
        del terms
        for name, lib in libs.items():
            if variants and lib is None:
                print(f"AB {root.name} {case}: {name:40s} not in this source")
                continue
            part, whole, _ = VARIANTS[name]
            if lib is not None:
                _build._loaded["embedding_bag_grad"] = lib

            def run(part=part):
                return embedding_bag_grad_cuda(
                    table, ids, w, g, plan.order, plan.keys, plan.offsets,
                    table_grad=part == "table",
                    weights_grad=part == "weights")

            same = "n/a"
            if part == "table" and whole:
                differ = int((run()[0].view(torch.int32) != bits).sum())
                same = f"{differ == 0} ({differ} cells differ)"
            us = events_us(run)
            print(f"AB {root.name} {case}: {name:40s} {us:10.2f} us (queued "
                  f"events, {REPS} reps); dT bits = segment_reduce over the "
                  f"products: {same}", flush=True)
        del table, ids, plan, bits
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
