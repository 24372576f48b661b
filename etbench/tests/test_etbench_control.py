"""The control on the card: the reference in float32 with TF32 on, put in
the program's place, fails the cell's limits on three seeds (at the small
size; `readings.py` reads it at the cell's own)."""
import pytest

from conftest import SMALL
from etbench.readings import readings
from etbench.run import load_json


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(cuda, name):
    limits = load_json("etbench", "workloads", f"{name}.json")["checks"]
    seeds = [7, 8, 2 ** 31 + 9]
    got = list(readings(name, seeds, seeds, 1.0, device=cuda, traffic_overrides=SMALL[name]))
    for rec in got:
        failed = [k for k, lim in limits.items() if rec["numbers"][k] > lim["limit"]]
        if rec["role"] == "control":
            assert failed, rec
        else:
            assert not failed and rec["failed"] == 0, rec
