"""The port's model configs default as sps_tpu's do: every field that
sps_torch's SPSConfig, MinkUNetConfig and Capacities share with sps_tpu's
has sps_tpu's default (a dtype compared by name). Defaults the port cannot
run raise NotImplementedError where they take effect
(tests/test_torch_model.py::test_unported_options_raise,
test_default_engine_raises below)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.models.minkunet import MinkUNetConfig as JUNetConfig
from sps_tpu.models.spsnet import SPSConfig as JSPSConfig
from sps_tpu.structs import Capacities as JCaps
from sps_torch.models import spsnet as tsps
from sps_torch.models.minkunet import MinkUNetConfig as TUNetConfig
from sps_torch.structs import Capacities as TCaps
from sps_torch.structs import pad_point_batch as tpad


def _norm(v):
    """A default in comparable form: dataclasses field by field, dtypes by name."""
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):  # a jnp scalar type
        return jnp.dtype(v).name
    return v


def _shared(mine, theirs):
    """mine's fields with theirs' values (nested configs likewise)."""
    assert set(mine) <= set(theirs), set(mine) - set(theirs)
    return {k: _shared(v, theirs[k]) if isinstance(v, dict) else theirs[k]
            for k, v in mine.items()}


@pytest.mark.parametrize("port,ref", [(tsps.SPSConfig, JSPSConfig), (TUNetConfig, JUNetConfig),
                                      (TCaps, JCaps)], ids=["SPSConfig", "MinkUNetConfig",
                                                             "Capacities"])
def test_defaults_equal_sps_tpu(port, ref):
    mine = _norm(port())
    assert mine == _shared(mine, _norm(ref()))


def test_default_engine_raises():
    """The default engine ("brick", brick side 4, no row levels) is not
    ported: building its pyramid raises instead of taking the atlas path."""
    cfg = tsps.SPSConfig()
    rng = np.random.default_rng(0)
    pb = tpad(rng.uniform(-3, 3, (64, 3)).astype(np.float32), np.zeros(64, np.int32),
              np.zeros(64, np.int32), np.zeros(64, np.float32), 128, device="cpu")
    with pytest.raises(NotImplementedError):
        tsps.build_pyramid(pb, dataclasses.replace(cfg, atlas_extent=(1, 4, 4, 4)))
