"""The port's examples on the CPU (reduced llsc-100m): the training demo
crashes at an injected failure and resumes on a second invocation; the
overloading view measures 1, 2, 4 and 8 streams beside the packing model.
Without a card and without ``--device cpu`` both exit 1."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.overload import packed_throughput_model  # noqa: E402
from repro_torch.examples import overloading_throughput  # noqa: E402
from repro_torch.examples import train_with_monitoring  # noqa: E402

CPU = ["--device", "cpu", "--reduced"]


def test_train_with_monitoring_crashes_then_resumes(tmp_path, capsys):
    args = CPU + ["--peak-flops", "1e12", "--mem-total-gb", "16", "--steps",
                  "8", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    assert train_with_monitoring.main(args + ["--crash-at", "5"]) == 1
    err = capsys.readouterr().err
    assert "injected node failure at step 5" in err and "again" in err
    assert train_with_monitoring.main(args) == 0
    out = capsys.readouterr().out
    assert "(resumed from step 4)" in out
    assert "LLload view of this job:" in out and "duty cycle:" in out
    assert train_with_monitoring.main(CPU) == 2     # no device figures


def test_overloading_throughput_measures_four_slot_counts(capsys):
    assert overloading_throughput.main(CPU) == 0
    rows = [line.split() for line in capsys.readouterr().out.splitlines()[1:]]
    assert [int(r[0]) for r in rows] == [1, 2, 4, 8]
    assert all(float(r[1]) > 0 for r in rows) and float(rows[0][2]) == 1.0
    for r in rows:
        pred = (packed_throughput_model(0.35, int(r[0]))
                / packed_throughput_model(0.35, 1))
        assert r[3] == f"{pred:.2f}x"


def test_examples_need_a_card_unless_given_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert overloading_throughput.main([]) == 1
    assert train_with_monitoring.main(["--steps", "1"]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 2
