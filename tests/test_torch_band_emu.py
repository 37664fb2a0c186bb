"""csrc/band_align.cu itself, run on the CPU by the thread-per-lane
emulation of nextpolish_tpu_torch/emu_band.py (g++ and the stand-in
csrc/emu/cuda_runtime.h): both kernels' outputs equal their plain versions
in every mode, on both routes of band_align (a warp per read up to B =
256, and up to 512 from 256 reads; a block per read for the rest) and
both tile layouts of band_traceback (whole rows
up to B = 64, column windows above), with reads built to tie and reads
with long indels.  The card's build is held to the same plain versions by
tests/test_torch_gpu.py; this keeps the source's logic checked where there
is no card."""
import shutil

import pytest

from nextpolish_tpu_torch import emu_band


@pytest.mark.parametrize("case", ["band_case", "band_indel_case"])
def test_band_source_matches_plain_under_emulation(case):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    # (R, B, reads): warp route K = 1, 4 and 16 (pads at B = 100 and 300),
    # block route (B = 512 with few reads, 544, 1,150); more reads than a
    # block's four; rows past one staged chunk are left to the card tests
    # (R > 1,024 is slow here)
    assert emu_band.main(["--case", case, "40,32,6", "36,100,5",
                          "12,300,256", "30,512,2", "40,544,2",
                          "24,1150,2"]) == 0
