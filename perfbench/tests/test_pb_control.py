"""The control: the plain reference in the program's place, computed in
float8 (the precision below the configurations' bfloat16), read at the
served positions and judged by the harness's own comparison, with each
committed cell's numbers compared and limits: it comes out not correct
where the program comes out correct.

Here at a size a CPU test run holds (small float32 cells, whose program
readings are 0), on three seeds. At the cells' own sizes on the card
``perfbench/readings.py`` reads the same verdicts, and PERF.md gives the
readings each limit was set from."""
import pytest
import torch

from perfbench.harness import check, main
from perfbench.tests import tiny

CELLS = {"granite-moe.chat": (tiny.MOE, "chat"),
         "granite-moe.decode.host": (tiny.MOE, "decode"),
         "rwkv6.decode": (tiny.RWKV, "decode")}


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9])
@pytest.mark.parametrize("like", sorted(CELLS))
def test_control_fails_where_the_program_passes(like, seed):
    torch.set_num_threads(2)
    cfg, mix = CELLS[like]
    cell = tiny.cell(cfg, mix, like)
    out = main.one_run(cell, seed, 2.0, False, "cpu", control=True)
    compared = cell.settings["check"]["compare"]
    assert set(compared) <= set(check.NUMBERS)
    assert out["correct"] is True, out["check"]
    assert out["run"]["control_correct"] is False, \
        out["run"]["control_compared"]
    assert all(k in out["run"]["control_compared"] for k in compared)
