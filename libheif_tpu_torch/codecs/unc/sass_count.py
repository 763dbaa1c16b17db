"""Instructions per output pixel in a kernel's loop body, read from the
SASS of the built kernel library.

    python3 -m libheif_tpu_torch.codecs.unc.sass_count [--function] \\
        LIBRARY.so REGEX PIXELS [REGEX PIXELS ...]

For each kernel whose mangled name matches REGEX (the first match), it
takes the loop body -- the instructions between the target of the
widest backward branch and that branch -- and divides its instruction
count by PIXELS, the output pixels one thread computes in one pass of
that loop.  With ``--function`` it takes the whole function instead
(up to its last EXIT; functions it calls are not counted), for a kernel
whose thread runs its body once: PIXELS is then what one thread
computes.  The count is static: every instruction once, both arms of a
branch included, a loop's body once.  Needs ``cuobjdump`` from the CUDA
toolkit (next to ``nvcc``).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Tuple

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"([^;]*);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")

CLASSES = (
    ("fp32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK")),
    ("conversion", ("F2I", "I2F", "F2F", "I2FP", "F2FP", "F2IP", "FRND",
                    "I2I", "I2IP")),
    ("mufu", ("MUFU",)),
    ("load", ("LDG", "LD", "LDS", "LDC", "LDL", "ULDC")),
    ("store", ("STG", "ST", "STS", "STL", "ATOM", "RED")),
    ("shuffle", ("SHFL",)),
    ("control", ("BRA", "CALL", "EXIT", "RET", "BSSY", "BSYNC", "WARPSYNC",
                 "BAR", "NOP", "YIELD")),
)


def _class(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "integer"


def functions(sass: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """Mangled name → [(address, opcode, operands)] from cuobjdump -sass."""
    out: Dict[str, List[Tuple[int, str, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def loop_body(instrs: List[Tuple[int, str, str]]) -> List[Tuple[int, str, str]]:
    """The instructions of the widest loop: from the target of the
    backward branch that jumps furthest back, to that branch."""
    best = None
    for addr, op, args in instrs:
        if not op.startswith("BRA"):
            continue
        m = _TARGET.search(args)
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[1] - span[0] > best[1] - best[0]:
                best = span
    if best is None:
        raise ValueError("no loop in this function")
    return [i for i in instrs if best[0] <= i[0] <= best[1]]


def function_body(instrs: List[Tuple[int, str, str]]
                  ) -> List[Tuple[int, str, str]]:
    """The instructions up to the last EXIT (not the padding after it)."""
    last = max(i for i, (_, op, _) in enumerate(instrs)
               if op.startswith("EXIT"))
    return instrs[:last + 1]


def count(sass: str, pattern: str, pixels: int,
          whole: bool = False) -> dict:
    """Per-pixel instruction count of the first kernel matching
    `pattern`, by class: of its widest loop's body, or with ``whole`` of
    the whole function."""
    funcs = functions(sass)
    names = [n for n in funcs if re.search(pattern, n)]
    if not names:
        raise ValueError(f"no kernel matches {pattern!r}")
    body = (function_body if whole else loop_body)(funcs[names[0]])
    by_class = Counter(_class(op) for _, op, _ in body)
    return {"kernel": names[0], "body_instructions": len(body),
            "pixels_per_pass": pixels,
            "per_pixel": len(body) / pixels,
            "per_pixel_by_class": {k: v / pixels
                                   for k, v in sorted(by_class.items())}}


def cuobjdump_sass(library: str) -> str:
    nvcc_dir = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    tool = os.path.join(nvcc_dir, "cuobjdump")
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout


def main(argv: List[str]) -> int:
    whole = argv[:1] == ["--function"]
    argv = argv[whole:]
    if len(argv) < 3 or len(argv) % 2 == 0:
        print(__doc__, file=sys.stderr)
        return 2
    import json
    sass = cuobjdump_sass(argv[0])
    for pattern, pixels in zip(argv[1::2], argv[2::2]):
        print(json.dumps(count(sass, pattern, int(pixels), whole)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
