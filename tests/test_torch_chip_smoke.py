"""chip_smoke.py's check that a profiler trace of the device holds every
record of the calls it traced (``trace_losses``), on made-up traces."""
import importlib.util
from pathlib import Path

import pytest


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(**counts):
    """Activities (name, us, start, end) with ``counts[name]`` of each."""
    return [(name, 1.0, 0, 1) for name, n in counts.items()
            for _ in range(n)]


@pytest.mark.parametrize("counts, lost", [
    ({}, True),                             # the trace is empty
    ({"kernel": 100}, False),               # one launch a call
    ({"kernel": 99}, True),                 # one record gone
    ({"memset": 100, "kernel": 100}, False),
    ({"memset": 150, "kernel": 50}, True),  # the total is still 200
    ({"mul": 300, "add": 100}, False),      # one name three times a call
])
def test_trace_losses(counts, lost):
    assert _chip_smoke().trace_losses(_trace(**counts), 100) is lost
