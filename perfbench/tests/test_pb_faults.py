"""``correct`` comes out false when the timed path is broken underneath,
and true when it is not. Each test drives a whole run of a small cell on
the CPU (the harness's look for a card is the one step skipped), with
the committed cell's decision plane, numbers compared and limits, and
one fault of ``perfbench/faults.py`` planted in the program: a decode
step that returns its state unchanged, half of the batch's rows left
out, a token altered where the decision plane produces it, on every row
or on the greedy rows alone, and the filters switched off. One card runs
each cell, so no exchange between chips exists to leave out."""
import pytest
import torch

from perfbench import faults
from perfbench.harness import main
from perfbench.tests import tiny

CELLS = {"granite-moe.chat": (tiny.MOE, "chat"),
         "granite-moe.decode.host": (tiny.MOE, "decode"),
         "rwkv6.decode": (tiny.RWKV, "decode")}
SEED = 2 ** 31 + 101


def _run(like):
    cfg, mix = CELLS[like]
    torch.set_num_threads(2)
    return main.one_run(tiny.cell(cfg, mix, like), SEED, 2.0, False, "cpu")


@pytest.mark.parametrize("like", sorted(CELLS))
def test_sound_run_is_correct(like):
    out = _run(like)
    assert out["correct"] is True, out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("like", sorted(CELLS))
def test_fault_makes_the_run_incorrect(like, fault):
    with faults.FAULTS[fault]():
        out = _run(like)
    assert out["correct"] is False, out["check"]


def test_faults_are_taken_out_again():
    from repro_torch.core.decision_plane import DecisionPlane
    from repro_torch.models.model import Model
    before = (DecisionPlane.step, Model.decode_step)
    for make in faults.FAULTS.values():
        with make():
            pass
    assert (DecisionPlane.step, Model.decode_step) == before
