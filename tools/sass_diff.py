#!/usr/bin/env python3
"""Whether CUDA sources of the port compile to the same machine code in two
trees, for a change to a shared header that must leave some of its users
as they were:

    python3 tools/sass_diff.py OLD NEW segment_reduce.cu segment_grad.cu

OLD and NEW are roots of checkouts; each named source under
``src/repro_torch/kernels/csrc/`` is compiled in both with the port's
target and optimisation flags to a cubin in ``build/tools/sass/``, and
``cuobjdump -sass`` of the two is compared, the anonymous namespace's
file hash aside. It prints one line a source (the same, or how many lines
differ, and each kernel's instruction count) and exits 1 where any
differs. Needs ``nvcc`` and ``cuobjdump`` (a card's toolkit), no card.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def sass(root: Path, source: str, tag: str) -> str:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import nvcc_path

    out = ROOT / "build" / "tools" / "sass" / f"{tag}_{source}.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc_path(), *FLAGS, "-o", str(out),
                    str(root / "src/repro_torch/kernels/csrc" / source)],
                   check=True, capture_output=True, text=True)
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(out)], check=True,
                          capture_output=True, text=True).stdout
    return _ANON.sub("ANON", text)


def main(argv: list[str]) -> int:
    old, new, *sources = argv
    differ = 0
    for source in sources:
        a = sass(Path(old).resolve(), source, "old").splitlines()
        b = sass(Path(new).resolve(), source, "new").splitlines()
        changed = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        kernels = len([x for x in b if x.strip().startswith("Function :")])
        instructions = len([x for x in b if re.match(r"\s+/\*[0-9a-f]{4}\*/",
                                                     x)])
        print(f"sass {source}: {'the same' if changed == 0 else 'DIFFERS'} "
              f"({changed} of {len(b)} lines differ; {kernels} kernels, "
              f"{instructions} instructions)")
        differ += changed > 0
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
