"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_with_jax_and_repro_blocked():
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for m in {_modules()!r}:
    importlib.import_module(m)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]
assert not bad, bad
print('ok', len({_modules()!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
def test_no_import_of_jax_or_repro(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {n}"


def test_no_triton_and_no_library_kernels_in_the_package():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for word in ("triton", "scaled_dot_product_attention", "rms_norm(",
                     "torch.compile", "conv1d"):
            assert word not in text, f"{path} mentions {word}"


def test_entry_points_need_a_card_unless_given_cpu(monkeypatch, capsys):
    from repro_torch import resolve_device
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.train import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("llsc-100m")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_lib.init_params(cfg, gen)
    params = model_lib.init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, EngineConfig())
    assert launch_serve.main(["--reduced", "--requests", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainerConfig(steps=1))
    assert launch_train.main(["--reduced", "--steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert resolve_device("cpu").type == "cpu"


def test_launcher_exit_codes(capsys):
    from repro_torch.launch import serve as launch_serve

    assert launch_serve.main(["--flags", "no_such_flag"]) == 2
    assert launch_serve.main(["--arch", "no-such-arch"]) == 2
    assert launch_serve.main(["--device", "cpu", "--reduced"]) == 2
    capsys.readouterr()
    rc = launch_serve.main(["--device", "cpu", "--reduced", "--requests", "2",
                            "--slots", "2", "--max-new", "3",
                            "--flags", "flash_kernel", "--peak-flops", "1e12",
                            "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "2 requests" in out and "Overload controller" in out


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "mamba2-370m", "--reduced", "--device",
                            "cpu", "--requests", "3", "--slots", "2",
                            "--prompt-len", "20", "--max-new", "4",
                            "--peak-flops", "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve:mamba2-370m-reduced] 3 requests, 12 tokens" in out


def test_launcher_serves_granite_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                            "--device", "cpu", "--requests", "3", "--slots",
                            "2", "--prompt-len", "16", "--max-new", "4",
                            "--flags", "flash_kernel", "--peak-flops",
                            "1e12", "--mem-total-gb", "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve:granite-moe-1b-a400m-reduced] 3 requests, 12 tokens" in out
