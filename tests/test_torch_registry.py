"""Port parity, the architecture registry and the model's declarations
(``repro_torch/configs/registry.py``, ``models/config.py``, the logical
axes of ``models/{layers,ssm,lm}.py``'s ``ParamDef``s and
``models/quantize.py``'s abstract int8 tree and ``quantize_spec_tree``)
against the reference's: ``SHAPES``, each arch's ``rules`` and ``skip``,
``ModelConfig``'s fields, defaults and the registered values (and its refusal
of a value for a field the port does not read), the inputs
of all 10 × 4 cells, ``cache_axes_for``, ``param_axes`` leaf by leaf and
``abstract_params``' shapes and dtypes for the ten full configs and their
int8 trees, and the int8 layouts.  Also: ``init_params`` draws the bits it
drew before the parameter definitions carried axes.

Everything here is a declaration, so every comparison is exact.  Nothing
is allocated: the port's trees are meta tensors, the reference's
``ShapeDtypeStruct``s.
"""
import dataclasses
import hashlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import cache_axes_for as ref_cache_axes_for  # noqa: E402
from repro.configs import get as ref_get  # noqa: E402
from repro.configs import input_specs as ref_input_specs  # noqa: E402
from repro.distributed.sharding import param_specs as ref_param_specs  # noqa: E402
from repro.models import ModelConfig as RefModelConfig  # noqa: E402
from repro.models import abstract_params as ref_abstract_params  # noqa: E402
from repro.models import param_axes as ref_param_axes  # noqa: E402
from repro.models import quantize as ref_q  # noqa: E402

from repro_torch.configs import (SHAPES, all_archs, cache_axes_for,  # noqa: E402
                                 get, input_specs)
from repro_torch.distributed.sharding import spec_tree  # noqa: E402
from repro_torch.models import (ModelConfig, abstract_params,  # noqa: E402
                                init_params, param_axes, quantize_params)
from repro_torch.models.config import UNREAD  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.quantize import (abstract_quantized,  # noqa: E402
                                         quantize_spec_tree)

ARCHS = ["command-r-plus-104b", "h2o-danube-1.8b", "internvl2-76b",
         "jamba-1.5-large-398b", "mamba2-130m", "mixtral-8x22b",
         "musicgen-medium", "olmoe-1b-7b", "phi3-mini-3.8b", "qwen1.5-0.5b"]
# sha256 (first 16 hex digits) of every SMOKE config's init_params(seed=3)
# leaves in tree order, drawn by the port before ParamDef had axes
INIT_DIGESTS = {
    "command-r-plus-104b": "123f704010fa5fa9",
    "h2o-danube-1.8b": "12bc9789241497e9",
    "internvl2-76b": "a0815f46aeec2815",
    "jamba-1.5-large-398b": "8bc5ecab2cf65eae",
    "mamba2-130m": "9f8515f03166a42f",
    "mixtral-8x22b": "c527fea2281609b9",
    "musicgen-medium": "4687e314eb0f8885",
    "olmoe-1b-7b": "99bb375e421fe8eb",
    "phi3-mini-3.8b": "61ba16264b4d604b",
    "qwen1.5-0.5b": "ed6e204b37371be6",
}
MESH_AXES = ("data", "model")


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def _flat(tree, path=()):
    """(path, leaf) pairs of a tree of dicts, lists and NamedTuples (a
    QTensor's two halves apart), dict keys sorted as jax orders them; a
    tuple of axis names is a leaf."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for f in tree._fields
                for p in _flat(getattr(tree, f), path + (f,))]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not _is_axes(tree)):
        return [p for i, v in enumerate(tree) for p in _flat(v, path + (i,))]
    return [(path, tree)]


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _shapes(tree):
    return [(p, tuple(x.shape), _dtype(x.dtype)) for p, x in _flat(tree)]


def _ref_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), MESH_AXES)


def _port_mesh():
    return types.SimpleNamespace(mesh_dim_names=MESH_AXES)


def test_shapes_are_the_references():
    assert list(SHAPES) == list(REF_SHAPES)
    for name in SHAPES:
        assert dataclasses.asdict(SHAPES[name]) == \
            dataclasses.asdict(REF_SHAPES[name])


def test_every_arch_is_registered_with_the_references_rules_and_skips():
    assert list(all_archs()) == ARCHS
    for arch in ARCHS:
        spec, ref = get(arch), ref_get(arch)
        assert spec.rules == ref.rules, arch
        assert spec.skip == ref.skip, arch
        assert spec.source == ref.source, arch


def test_model_config_fields_and_defaults_are_the_references():
    port = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(RefModelConfig)}
    assert list(port) == list(ref)
    assert port == ref


@pytest.mark.parametrize("field,value", [("attn_q_chunk", 512),
                                         ("scan_layers", False),
                                         ("max_seq_len", 4096)])
def test_a_field_the_port_does_not_read_refuses_another_value(field, value):
    cfg = get("qwen1.5-0.5b").smoke_config
    assert field in UNREAD
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(cfg, **{field: value})


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_registered_configs_have_the_references_values(which):
    for arch in ARCHS:
        got = dataclasses.asdict(getattr(get(arch), which))
        want = dataclasses.asdict(getattr(ref_get(arch), which))
        assert got == want, arch
        assert getattr(get(arch), which).is_subquadratic == \
            getattr(ref_get(arch), which).is_subquadratic


@pytest.mark.parametrize("shape", list(REF_SHAPES))
def test_input_specs_match_the_references(shape):
    """Shapes, dtypes and logical axes of every input of the 10 cells of
    one shape (the caches of a decode shape leaf by leaf)."""
    for arch in ARCHS:
        got, want = input_specs(arch, shape), ref_input_specs(arch, shape)
        assert sorted(got["specs"]) == sorted(want["specs"]), arch
        assert _shapes(got["specs"]) == _shapes(want["specs"]), arch
        assert all(x.device.type == "meta"
                   for _, x in _flat(got["specs"])), arch
        assert _flat(got["axes"]) == _flat(want["axes"]), arch
        assert dataclasses.asdict(got["shape"]) == \
            dataclasses.asdict(want["shape"])


def test_cache_axes_for_matches_the_references():
    for arch in ARCHS:
        for which in ("config", "smoke_config"):
            cfg = getattr(get(arch), which)
            ref_cfg = getattr(ref_get(arch), which)
            got, want = cache_axes_for(cfg), ref_cache_axes_for(ref_cfg)
            assert [type(a).__name__ for a in got] == \
                [type(a).__name__ for a in want]
            assert _flat(got) == _flat(want), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_abstract_params_match_the_references(arch):
    """The full config's logical axes leaf by leaf, and its abstract tree's
    shapes and dtypes, bf16 and int8, on meta tensors (nothing allocated:
    jamba-1.5-large is 398B parameters)."""
    cfg, ref_cfg = get(arch).config, ref_get(arch).config
    assert _flat(param_axes(cfg)) == _flat(ref_param_axes(ref_cfg))
    port = abstract_params(cfg)
    ref = ref_abstract_params(ref_cfg)
    assert _shapes(port) == _shapes(ref)
    assert all(t.device.type == "meta" for t in tree_leaves(port))
    qref = jax.eval_shape(lambda p: ref_q.quantize_params(p, ref_cfg), ref)
    assert _shapes(abstract_quantized(port)) == _shapes(qref)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "olmoe-1b-7b",
                                  "mamba2-130m"])
def test_abstract_quantized_is_what_quantize_params_makes(arch):
    cfg = get(arch).smoke_config
    real = quantize_params(init_params(cfg, seed=0, device="cpu"), cfg)
    assert _shapes(abstract_quantized(abstract_params(cfg))) == \
        _shapes(real)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_spec_tree_resolves_as_the_references(arch):
    """Under each arch's rules on a ("data", "model") mesh: every int8
    leaf's data and scale layouts, and every other leaf's, as the
    reference resolves them."""
    cfg, ref_cfg = get(arch).config, ref_get(arch).config
    rules = get(arch).rules
    got = quantize_spec_tree(abstract_params(cfg),
                             spec_tree(param_axes(cfg), _port_mesh(), rules))
    mesh = _ref_mesh()
    want = ref_q.quantize_spec_tree(
        ref_abstract_params(ref_cfg),
        ref_param_specs(ref_param_axes(ref_cfg), mesh, rules), mesh)
    want_flat = [(p, tuple(s.spec)) for p, s in _flat(want)]
    assert _flat(got) == want_flat
    assert any(p[-1] == "scale" for p, _ in want_flat)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_same_bits(arch):
    params = init_params(get(arch).smoke_config, seed=3, device="cpu")
    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == INIT_DIGESTS[arch]
