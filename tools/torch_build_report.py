"""Build the port's CUDA kernels and print what ``ptxas -v`` says of every
kernel instance: registers, stack frame (local memory, which a dynamically
indexed array or struct takes), spills, shared memory, and the seconds ``nvcc``
took. Needs ``nvcc``; run from the repository root:

    python3 tools/torch_build_report.py
"""

import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pigeons_tpu_torch import _build  # noqa: E402


def main() -> None:
    out = Path(_build.BUILD_DIR) / "report.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in _build.SOURCES:
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(out), str(_build.CSRC / name)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        print(f"{name}: nvcc {time.perf_counter() - t0:.1f} s, exit {res.returncode}")
        if res.returncode != 0:
            print(res.stdout + res.stderr)
            sys.exit(1)
        text = res.stderr + res.stdout
        rows = []
        for m in re.finditer(r"Compiling entry function '(\S+)' for 'sm_90a'.*?"
                             r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                             r"(\d+) bytes spill loads.*?Used (\d+) registers", text, re.S):
            demangled = subprocess.run(["c++filt", m.group(1)], capture_output=True, text=True).stdout.strip()
            short = demangled.replace("(anonymous namespace)::", "").replace("pigeons::", "")
            short = short[: short.index(">(") + 1] if ">(" in short else short
            rows.append((short, int(m.group(5)), int(m.group(2)), int(m.group(3)), int(m.group(4))))
        for short, regs, frame, st, ld in sorted(rows):
            print(f"  {short}: {regs} registers, stack frame {frame} B, spill stores {st} B, "
                  f"loads {ld} B")
    out.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
