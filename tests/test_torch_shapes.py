"""The port's assigned shapes and input specs against the JAX package's.

``SHAPES`` field for field; ``shape_applicable`` for every registered arch
and shape; ``input_specs`` leaf for leaf (shape and dtype, caches
included) for every ``ASSIGNED`` arch and shape: the reference's
``ShapeDtypeStruct``s against the port's ``meta`` tensors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs import shape_applicable as jax_applicable  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeSpec, get_config,  # noqa: E402
                                 input_specs, list_archs, shape_applicable)
from repro_torch.configs.archs import ASSIGNED  # noqa: E402


def _leaves(node, path=""):
    """path -> (shape, dtype name) of every array leaf of a dict tree."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(node, torch.Tensor):
        return {path: (tuple(node.shape), str(node.dtype).split(".")[-1])}
    return {path: (tuple(node.shape), np.dtype(node.dtype).name)}


def _tensors(node):
    if isinstance(node, dict):
        return [t for v in node.values() for t in _tensors(v)]
    return [node]


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, spec in SHAPES.items():
        assert isinstance(spec, ShapeSpec)
        assert dataclasses.asdict(spec) == dataclasses.asdict(JAX_SHAPES[name])


def test_registered_archs_are_the_references():
    assert sorted(list_archs()) == sorted(jax_list_archs())


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_shape_applicable_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == \
            jax_applicable(jcfg, JAX_SHAPES[name]), (arch, name)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_the_reference(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = jax_input_specs(jax_get_config(arch), JAX_SHAPES[shape])
    for t in _tensors(got):
        assert t.device.type == "meta"
    assert _leaves(got) == _leaves(want)
