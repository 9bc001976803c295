import os
import sys
import types

# Tests run with PYTHONPATH=src, but make it robust when invoked otherwise.
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

try:
    from hypothesis import settings

    settings.register_profile("repro", max_examples=25, deadline=None)
    settings.load_profile("repro")
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    # hypothesis is optional: property-based tests are skipped (not errored)
    # when it is absent.  Install a minimal stub so `from hypothesis import
    # given, settings, strategies as st` keeps importing; @given marks the
    # test skipped and strategy constructors return inert placeholders.
    HAVE_HYPOTHESIS = False
    import pytest

    def _given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)
        return deco

    class _Settings:
        def __init__(self, *_a, **_k):
            pass

        def __call__(self, fn):
            return fn

        @staticmethod
        def register_profile(*_a, **_k):
            pass

        @staticmethod
        def load_profile(*_a, **_k):
            pass

    class _Strategies(types.ModuleType):
        def __getattr__(self, name):
            return lambda *a, **k: None

    _st = _Strategies("hypothesis.strategies")
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _Settings
    _hyp.strategies = _st
    _hyp.assume = lambda *a, **k: True
    _hyp.HealthCheck = types.SimpleNamespace(all=lambda: [])
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
