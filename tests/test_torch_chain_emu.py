"""csrc/chain_scan.cu itself, run on the CPU by the thread-per-lane
emulation of nextpolish_tpu_torch/emu_chain.py (g++ and the stand-in
csrc/emu/cuda_runtime.h): chain_traceback's choices equal
traceback_batch_plain's on random pointer tables padded with identity maps
past each row's n_dp, for one row and for many, at shapes that reach
every route: groups of one, two, four and eight chunks; tb_walk with
fewer groups a row than a warp's threads, with one group a thread, and
(in a build with tb_walk's threads cut to 64) with several warps and
several groups a thread; and chain_forward's f bit-equal to
forward_states_plain at rows of 1, 2 and 4 chunks (units of four chunks
spanning rows, a unit whose last groups run past the end) and at 64
chunks a row and 16 a row over four rows (16 and 4 units a row: the
look-back four and two levels deep), also with products past 2^24, where
another order of combining the units gives other bits.  The card's build
is held to the same plain versions by tests/test_torch_gpu.py; this
keeps the source's logic checked where there is no card."""
import shutil

import pytest

from nextpolish_tpu_torch import emu_chain


@pytest.mark.parametrize("args", [
    ["1,1", "1,2", "1,256", "64,1", "64,2", "2,4", "3,2"],
    ["--lg-walk", "6", "1,1024", "2,64"],
    ["--big", "1,64", "4,16", "5,1"],
], ids=["card-build", "walk-64-threads", "forward-big"])
def test_chain_source_matches_plain_under_emulation(args):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    assert emu_chain.main(args) == 0
