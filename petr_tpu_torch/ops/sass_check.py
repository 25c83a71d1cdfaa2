"""A check of the machine code nvcc made for the wgmma kernels: no
instruction may read or write a wgmma accumulator while the products that
write it are still in flight.

``wgmma.mma_async`` (SASS ``HGMMA``) writes its accumulator registers
asynchronously; only ``wgmma.wait_group`` (SASS ``WARPGROUP.DEPBAR.LE gsb0,
N``) makes them safe to touch. The compiler does not always keep the two in
order: with one group left in flight across the bf16 K4's chunks, ptxas
scheduled the epilogue's bf16 conversions of the accumulators above the
``wait_group 0`` after the loop, and the last chunk's products were partly
lost (``csrc/deform_conv.cu``'s note). This reads ``cuobjdump -sass`` and
reports every such instruction.

The scan follows each function in address order and does not follow
branches: a group left in flight across a loop's back edge is seen where the
loop ends, not at its top, and an ``EXIT`` starts a new path. Groups are the
HGMMAs up to one marked ``gsb0`` (one commit); ``DEPBAR.LE gsb0, N`` leaves
the last N in flight.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import List, Set, Tuple

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)\s*([^;]*);")
_GMMA = re.compile(r"[HI]GMMA\.64x(\d+)x\d+")
_DEPBAR = re.compile(r"gsb0,\s*0x([0-9a-f]+)")
_REGISTER = re.compile(r"(?<![A-Z_])R(\d+)\b")


def _registers(opcode: str, operands: str) -> Set[int]:
    """The general registers an instruction names, a 64- or 128-bit operand
    as its 2 or 4 registers."""
    width = 4 if ".128" in opcode else 2 if ".64" in opcode else 1
    return {int(r) + i for r in _REGISTER.findall(operands) for i in range(width)}


def inflight_accumulator_uses(sass: str) -> List[Tuple[str, str, str]]:
    """(function, address, instruction) for every instruction that names a
    register an HGMMA still in flight writes; empty when the code is safe."""
    found: List[Tuple[str, str, str]] = []
    function = ""
    groups: List[Set[int]] = []  # committed groups in flight, oldest first
    open_group: Set[int] = set()  # HGMMAs not yet committed
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            function, groups, open_group = m.group(1), [], set()
            continue
        m = _INSTRUCTION.search(line)
        if not m:
            continue
        address, opcode, operands = m.groups()
        h = _GMMA.match(opcode)
        if h:
            dest = int(_REGISTER.search(operands).group(1))
            open_group |= set(range(dest, dest + int(h.group(1)) // 2))
            if "gsb0" in operands:
                groups.append(open_group)
                open_group = set()
            continue
        if opcode.startswith("WARPGROUP.DEPBAR"):
            keep = int(_DEPBAR.search(operands).group(1), 16)
            groups = groups[len(groups) - keep:] if keep else []
            continue
        if opcode == "EXIT":
            groups, open_group = [], set()
            continue
        pending = set().union(open_group, *groups)
        if pending and _registers(opcode, operands) & pending:
            found.append((function, address, f"{opcode} {operands.strip()}"))
    return found


def library_sass(path: Path) -> str:
    """``cuobjdump -sass`` of a built library (the CUDA toolkit's, beside nvcc)."""
    from petr_tpu_torch.ops import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
