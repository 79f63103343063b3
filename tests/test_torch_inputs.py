"""The dry run's pure parts against the JAX package's: ``InputShape`` and
``INPUT_SHAPES`` (``models/common.py``), ``launch/inputs.py``
(``LONG_CONTEXT_WINDOW``, ``config_for_shape``, ``decode_dims``, the
shapes of ``input_specs``) and ``launch/dryrun.py``'s ``ASSIGNED``,
``SHAPES``, ``default_policy``, ``depth_scaled``, ``probe_depths`` and
``_model_flops_global``, for every assigned arch and every input shape.

The port's ``input_specs`` returns empty ``meta`` tensors where the
reference returns ``ShapeDtypeStruct``\\ s: the shapes are the
reference's; tokens and labels are ``torch.int32`` (the port's token
dtype, ``TOKEN_DTYPE``, as ``data/pipeline.py`` draws them) where the
reference's are ``jnp.int32``, patches and frames ``torch.float32`` where
its are ``jnp.float32``.  ``_model_flops_global`` is pure NumPy through
``configs/specs.py::layerspecs_for`` on both sides, so it is held equal
exactly, not within a tolerance.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

# the reference's dry-run module sets XLA_FLAGS to 512 host devices when it
# is imported: start this process's backend with its own flags first, and
# put the variable back so that no later subprocess inherits the edit
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import inputs as ref_inputs  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, inputs  # noqa: E402
from repro_torch.models import common  # noqa: E402

torch.set_num_threads(1)

PAIRS = [(a, s) for a in ref_dryrun.ASSIGNED for s in ref_dryrun.SHAPES]
JAX_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
              jnp.dtype(jnp.float32): torch.float32}


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    dt = d.pop("dtype")
    return d, (str(dt).split(".")[-1] if isinstance(dt, torch.dtype)
               else dt.__name__)


def test_input_shapes_are_the_reference():
    assert [f.name for f in dataclasses.fields(common.InputShape)] == \
        [f.name for f in dataclasses.fields(ref_common.InputShape)]
    assert list(common.INPUT_SHAPES) == list(ref_common.INPUT_SHAPES)
    for name, want in ref_common.INPUT_SHAPES.items():
        assert dataclasses.asdict(common.INPUT_SHAPES[name]) == \
            dataclasses.asdict(want)


def test_dryrun_lists_and_window_are_the_reference():
    assert dryrun.ASSIGNED == ref_dryrun.ASSIGNED
    assert dryrun.SHAPES == ref_dryrun.SHAPES
    assert inputs.LONG_CONTEXT_WINDOW == ref_inputs.LONG_CONTEXT_WINDOW
    assert inputs.TOKEN_DTYPE == torch.int32


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_config_for_shape_and_decode_dims(arch, shape):
    sj, st = ref_common.INPUT_SHAPES[shape], common.INPUT_SHAPES[shape]
    cj = ref_inputs.config_for_shape(jax_get_config(arch), sj)
    ct = inputs.config_for_shape(get_config(arch), st)
    assert _cfg_dict(ct) == _cfg_dict(cj)
    assert inputs.decode_dims(ct, st) == ref_inputs.decode_dims(cj, sj)


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_shapes_and_dtypes(arch, shape):
    sj, st = ref_common.INPUT_SHAPES[shape], common.INPUT_SHAPES[shape]
    cj = ref_inputs.config_for_shape(jax_get_config(arch), sj)
    ct = inputs.config_for_shape(get_config(arch), st)
    want = ref_inputs.input_specs(cj, sj)
    got = inputs.input_specs(ct, st)
    assert list(got) == list(want)
    for k, spec in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(spec.shape), k
        assert t.dtype == JAX_DTYPES[jnp.dtype(spec.dtype)], k
    assert ("labels" in got) == (shape == "train_4k")


@pytest.mark.parametrize("arch", ref_dryrun.ASSIGNED)
def test_policy_depths_and_model_flops(arch):
    cj, ct = jax_get_config(arch), get_config(arch)
    for mode in ("train", "serve"):
        for over in (None, {"seq_shard": True}, {"zero": False}):
            assert dataclasses.asdict(dryrun.default_policy(ct, mode, over)) \
                == dataclasses.asdict(ref_dryrun.default_policy(cj, mode,
                                                                over))
    assert dryrun.probe_depths(ct) == ref_dryrun.probe_depths(cj)
    for n in dryrun.probe_depths(ct):
        assert _cfg_dict(dryrun.depth_scaled(ct, n)) == \
            _cfg_dict(ref_dryrun.depth_scaled(cj, n))
    for shape in ref_dryrun.SHAPES:
        sj, st = ref_common.INPUT_SHAPES[shape], common.INPUT_SHAPES[shape]
        for train in (False, True):
            got = dryrun._model_flops_global(ct, st, train)
            assert got == ref_dryrun._model_flops_global(cj, sj, train)
            assert got > 0
