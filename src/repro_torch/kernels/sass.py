"""Compare the SASS of the kernels in two builds of a source.

    python -m repro_torch.kernels.sass OLD.so NEW.so [NAME_PART]

For each kernel (mangled name) whose name holds ``NAME_PART``, prints its
instruction count in each library and whether the instruction streams are
equal, with addresses and encodings stripped (``cuobjdump -sass``, from
the CUDA toolkit). A change that must leave a kernel's code as it was
(a moved helper, a kernel that shares a source) is checked this way.
Exits nonzero if a matching kernel differs or is in one library only.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from typing import Dict, List


def functions(lib: str) -> Dict[str, List[str]]:
    """{kernel name: its SASS instructions, addresses stripped}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out: Dict[str, List[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if name is not None and m:
            out[name].append(m.group(1).strip())
    return out


def main(argv: List[str]) -> int:
    old, new = functions(argv[0]), functions(argv[1])
    part = argv[2] if len(argv) > 2 else ""
    same = True
    for name in sorted(set(old) | set(new)):
        if part not in name:
            continue
        a, b = old.get(name), new.get(name)
        if a is None or b is None:
            print(f"{name}: only in {'the new' if a is None else 'the old'}")
            same = False
        else:
            print(f"{name}: {len(a)} vs {len(b)} instructions, "
                  f"{'identical' if a == b else 'DIFFERENT'}")
            same &= a == b
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
