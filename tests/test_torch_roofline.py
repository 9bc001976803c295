"""The port's roofline analysis and report against the JAX package's.

``parse_collective_bytes`` and ``roofline`` on ``tests/test_roofline.py``'s
HLO text and the tuple form, ``terms_from_monitoring`` and
``verdict_from_monitoring`` over a grid of duty, step time and HBM that
includes 0: each equals the reference's with the reference's ``hw``
figures patched to the port's H100 figures (for the test only).  The
port's figures are held to their values and the sources they name.  The
report's four tables and the summary give the reference's strings on the
same cells (ok, skipped and error).
"""
import dataclasses
import inspect
import itertools
import json

import pytest

pytest.importorskip("torch")

from repro.roofline import analysis as jax_analysis  # noqa: E402
from repro.roofline import hw as jax_hw  # noqa: E402
from repro.roofline import report as jax_report  # noqa: E402
from repro_torch import roofline as roofline_pkg  # noqa: E402
from repro_torch.roofline import analysis, hw, report  # noqa: E402

from test_roofline import HLO  # noqa: E402

TUPLE_HLO = ('%ar = (bf16[4,8]{1,0}, bf16[4,8]{1,0}) all-reduce-start('
             'bf16[4,8]{1,0} %p), replica_groups={}\n'
             '%ag = (f32[16,4]{1,0}, s32[2]{0}) all-gather-start('
             'f32[4,4]{1,0} %q), dimensions={0}')


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's analysis with the port's H100 figures."""
    monkeypatch.setattr(jax_hw, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jax_hw, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(jax_hw, "ICI_BW_PER_LINK", hw.LINK_BW)
    return jax_analysis


def _terms(t):
    return dataclasses.asdict(t)


@pytest.mark.parametrize("text", [HLO, TUPLE_HLO, HLO + TUPLE_HLO, ""])
def test_parse_collective_bytes_equals_the_reference(text):
    assert analysis.parse_collective_bytes(text) == \
        jax_analysis.parse_collective_bytes(text)


@pytest.mark.parametrize("text", [HLO, TUPLE_HLO, ""])
@pytest.mark.parametrize("cost", [
    {"flops": 989e12, "bytes accessed": 3.35e12 / 2},
    {"flops": 1e9, "bytes accessed": 1e6},
    {"flops": 0.0},
    {}])
def test_roofline_equals_the_reference(h100_reference, text, cost):
    for n, mf in ((256, 0.0), (512, 3e18), (1, 1e12)):
        got = analysis.roofline(cost, text, n_devices=n, model_flops_global=mf)
        want = h100_reference.roofline(cost, text, n_devices=n,
                                       model_flops_global=mf)
        assert _terms(got) == _terms(want)
        assert got.bound_s() == want.bound_s()
        assert got.roofline_fraction() == want.roofline_fraction()


GRID = list(itertools.product((0.0, 0.05, 0.43, 1.0, 1.5),
                              (0.0, 1e-3, 0.127139, 2.0),
                              (0.0, 0.5, 3.99, 80.0)))


def test_monitoring_terms_and_verdicts_equal_the_reference(h100_reference):
    seen = set()
    for duty, step, hbm in GRID:
        assert _terms(analysis.terms_from_monitoring(duty, step, hbm)) == \
            _terms(h100_reference.terms_from_monitoring(duty, step, hbm))
        verdict = analysis.verdict_from_monitoring(duty, step, hbm)
        assert verdict == h100_reference.verdict_from_monitoring(
            duty, step, hbm), (duty, step, hbm)
        seen.add(verdict.split(" ")[0])
    # the grid reaches every kind of verdict
    assert seen == {"no", "compute-bound", "memory-bound"}


def test_h100_figures_and_their_sources():
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.PEAK_FLOPS_FP32 == 67e12
    assert hw.HBM_BW == 3.35e12
    assert hw.LINK_BW == 50e9              # one 400 Gb/s port per GPU
    assert hw.DTYPE_BYTES == jax_hw.DTYPE_BYTES
    assert not hasattr(hw, "ICI_BW_PER_LINK")
    src = inspect.getsource(hw)
    for source in ("H100 SXM data sheet, 700 W", "DGX H100 data sheet",
                   "ConnectX-7", "NVLink 4", "450e9"):
        assert source in src, source


def test_the_package_exports_what_the_references_does():
    import repro.roofline as jax_pkg

    assert roofline_pkg.__all__ == jax_pkg.__all__


def _cells():
    ok = dict(status="ok", compute_s=2.5, memory_s=4e-3, collective_s=7e-7,
              dominant="memory", useful_flops_ratio=0.4172,
              flops_per_device=1.234e15, hbm_bytes_per_device=3.2e12,
              collective_bytes_per_device=912.0, compile_s=0.0,
              probe_s=12.4, memory_analysis={
                  "argument_size_in_bytes": 2_000_000,
                  "output_size_in_bytes": None,
                  "temp_size_in_bytes": 5.5e9})
    return [
        dict(ok, arch="qwen1.5-4b", shape="train_4k", multi_pod=True),
        dict(ok, arch="qwen1.5-4b", shape="train_4k", multi_pod=False,
             compute_s=0.2, dominant="compute"),
        dict(ok, arch="gemma3-1b", shape="decode_32k", multi_pod=False,
             memory_analysis={}, collective_bytes_per_device=2.5e3),
        dict(arch="gemma3-1b", shape="long_500k", multi_pod=False,
             status="skipped", reason="pure full-attention arch"),
        dict(arch="gemma3-1b", shape="long_500k", multi_pod=True,
             status="skipped", reason="pure full-attention arch"),
        dict(arch="mamba2-370m", shape="prefill_32k", multi_pod=True,
             status="error", error="NotImplementedError('aten.foo')"),
    ]


def test_report_strings_equal_the_reference(tmp_path):
    cells = _cells()
    for mp in (None, False, True):
        assert report.markdown_table(cells, multi_pod=mp) == \
            jax_report.markdown_table(cells, multi_pod=mp)
    assert report.skipped_table(cells) == jax_report.skipped_table(cells)
    assert report.memory_table(cells) == jax_report.memory_table(cells)
    for i, c in enumerate(cells):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(c))
    assert report.load_cells(str(tmp_path)) == \
        jax_report.load_cells(str(tmp_path))
    assert report.summarize(str(tmp_path)) == \
        jax_report.summarize(str(tmp_path))
    assert "1 error" in report.summarize(str(tmp_path))


@pytest.mark.parametrize("x", [0.0, 5e-7, 1e-3, 0.5, 1.0, 123.4])
def test_formatters_equal_the_reference(x):
    assert report._fmt_s(x) == jax_report._fmt_s(x)
    assert report._fmt_b(x * 1e13) == jax_report._fmt_b(x * 1e13)
