"""`correct` comes out false when the timed path is broken underneath or
the control takes the program's place, and true for the program: a run
driven on the CPU at a size a test run holds, with the cell's own
limits (the look for a card skipped)."""
import pytest

from harness import check, spec
from harness.cell import run
from harness.readings import readings

CELLS = ["bench2d.n100", "gv9d.splits", "bench2d.predict"]


def _small(name):
    cell = spec.load_cell(name)
    if cell.config["data"] == "function":
        cell.config.update(n=14, lattice=6)
    cell.config.update(n_max=2000, samp_size=150, net_samp_size=150)
    cell.traffic["check"] = dict(requests=1)
    if cell.traffic["kind"] == "predict":
        cell.traffic["sizes"] = {"count": 4, "low": 1, "high": 40}
    return cell


def _correct(cell, seed=2**31 + 3):
    res = run(cell, seed, 0.5, False, "cpu")
    return check.judge(res["numbers"], cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    ok, checks = _correct(_small(name))
    assert ok, checks


def _faults(name):
    """Every fault the cell can have. `laplace_at_start` is read at the
    cell's size on the card (`harness/readings.py --fault`): at this
    test's 14-point designs the start can lie within the limit of the
    mode, which is set at 100 points."""
    cell = spec.load_cell(name)
    faults = spec.load_module("faults", cell.config["system"]).FAULTS
    return [f for f in sorted(faults) if f != "laplace_at_start"
            and (f != "bfgs_truncated" or cell.config["plugin"] == "bfgs")]


@pytest.mark.parametrize("name, fault", [(n, f) for n in CELLS
                                         for f in _faults(n)])
def test_fault_is_not_correct(name, fault):
    cell = _small(name)
    plant = spec.load_module("faults", cell.config["system"]).plant
    with plant(fault):
        ok, checks = _correct(cell)
    assert not ok, checks


@pytest.mark.parametrize("name", ["bench2d.n100", "gv9d.splits"])
def test_control_is_not_correct(name):
    cell = _small(name)
    r = readings(cell, 11, "cpu", True)
    ok_program, _ = check.judge(r["program"], cell.limits)
    ok_control, checks = check.judge(r["control"], cell.limits)
    assert ok_program
    assert not ok_control, checks
