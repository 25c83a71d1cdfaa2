"""The check of the wgmma kernels' machine code (``petr_tpu_torch/ops/
sass_check.py``) on SASS text in ``cuobjdump -sass``'s format: the pattern
it must find (an accumulator converted while its products are in flight,
as ptxas scheduled the bf16 K4's epilogue with one group left in flight)
and the patterns it must pass. No GPU needed."""

import pytest

from petr_tpu_torch.ops.sass_check import inflight_accumulator_uses

HEAD = "\t\tFunction : _Z6kernelv\n"


def sass(*instructions):
    return HEAD + "".join(f"        /*{16 * i:04x}*/                   {ins} ;   /* 0x0 */\n"
                          for i, ins in enumerate(instructions))


LOOP = [
    "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R9+URZ+0x2bf00], R2",
    "WARPGROUP.ARRIVE",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR20], R24",
    "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR20], R24, gsb0",
]
EPILOGUE = ["F2FP.BF16.F32.PACK_AB R9, R87, R85", "STS [R2], R9"]


def test_finds_the_epilogue_read_above_the_last_wait():
    code = sass(*LOOP, "WARPGROUP.DEPBAR.LE gsb0, 0x1", "@!P0 BRA 0x0", *EPILOGUE, "WARPGROUP.DEPBAR.LE gsb0, 0x0")
    found = inflight_accumulator_uses(code)
    assert [(f, ins) for f, _, ins in found] == [("_Z6kernelv", "F2FP.BF16.F32.PACK_AB R9, R87, R85")]


@pytest.mark.parametrize("tail", [
    ["WARPGROUP.DEPBAR.LE gsb0, 0x0", "@!P0 BRA 0x0", *EPILOGUE],  # each chunk waited for
    ["WARPGROUP.DEPBAR.LE gsb0, 0x1", "@!P0 BRA 0x0", "WARPGROUP.DEPBAR.LE gsb0, 0x0", *EPILOGUE],  # waited after
    ["WARPGROUP.DEPBAR.LE gsb0, 0x1", "IADD3 R12, R12, 0x1, RZ", "EXIT", *EPILOGUE],  # another path
])
def test_passes_reads_after_their_wait(tail):
    assert inflight_accumulator_uses(sass(*LOOP, *tail)) == []


def test_a_group_left_in_flight_holds_only_its_own_registers():
    # S = Q K^T into R24.. (waited for), then P V into R88.. left in flight while S is read
    code = sass("HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT, gsb0", "WARPGROUP.DEPBAR.LE gsb0, 0x0",
                "HGMMA.64x32x16.F32.BF16 R88, R40, gdesc[UR8], R88, gsb0", "FMUL R30, R24, R55",
                "WARPGROUP.DEPBAR.LE gsb0, 0x0", "FMUL R88, R88, R30")
    assert inflight_accumulator_uses(code) == []
    late = sass("HGMMA.64x32x16.F32.BF16 R88, R40, gdesc[UR8], R88, gsb0", "STS.128 [R3], R100")
    assert [ins for _, _, ins in inflight_accumulator_uses(late)] == ["STS.128 [R3], R100"]
