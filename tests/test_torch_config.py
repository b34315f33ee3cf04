"""The port's model configs default as sps_tpu's do: every field that
sps_torch's SPSConfig, MinkUNetConfig and Capacities share with sps_tpu's
has sps_tpu's default (a dtype compared by name; MinkUNetConfig's sp_axis
and sp_ghost_frac included), the sp / dp entry points' keyword defaults are
sps_tpu's, and the default engine (brick, conv_mode region) scores as
sps_tpu's (sps_tpu's scores pinned by scripts/export_torch_assets.py --only
spsmodel in sps_torch/assets/spsmodel_pin.npz)."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import model_record, pinned

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


def default_config(sps_config, caps, unet_config):
    """Either package's default SPSConfig with the capacities and widths cut."""
    c = dict(points=128, voxels=(256, 128, 64, 64, 64), bricks=(128, 64, 64, 64, 64))
    narrow = dict(init_dim=4, planes=(4, 8, 8, 8, 8, 8, 8, 4))
    return dataclasses.replace(sps_config(), caps=caps(**c),
                               unet=dataclasses.replace(unet_config(), **narrow))


def default_inputs():
    """pad_point_batch's arguments for the default engine's test."""
    rng = np.random.default_rng(0)
    return (rng.uniform(-3, 3, (64, 3)).astype(np.float32), np.zeros(64, np.int32),
            rng.integers(0, 2, 64).astype(np.int32), np.zeros(64, np.float32), 128)


def test_default_engine_scores_as_sps_tpu():
    """The default engine ("brick", brick side 4, conv_mode "region", no row
    levels) builds its hash pyramid and scores as sps_tpu's default config
    does on the same weights; only the capacities and the widths are cut
    (f32, rtol 1e-3 / atol 1e-4)."""
    cfg = default_config(tsps.SPSConfig, TCaps, TUNetConfig)
    assert (cfg.engine, cfg.brick_side, cfg.unet.conv_mode) == ("brick", 4, "region")
    args = default_inputs()
    sd = tsps.init_state_dict(cfg, seed=0)
    model = tsps.SPSModel(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    with torch.inference_mode():
        got, aux = model(tpad(*args, device="cpu"))
    pin = pinned("spsmodel_pin.npz", "default_engine", model_record(cfg, sd, args))
    want, aux_j = pin["scores"], {"overflow": pin["overflow"]}
    assert not bool(aux["overflow"].any()) and not bool(np.asarray(aux_j["overflow"]).any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert bool((got[:64] > 0).all())


def _sp_dp_pairs():
    from sps_torch import train as ttrain
    from sps_torch.parallel import mesh as tmesh
    from sps_torch.parallel import spatial as tsp
    from sps_torch.stream import engine as tengine
    from sps_tpu import train as jtrain
    from sps_tpu.parallel import mesh as jmesh
    from sps_tpu.parallel import spatial as jsp
    from sps_tpu.stream import engine as jengine

    return {"StreamingFilter": (tengine.StreamingFilter.__init__, jengine.StreamingFilter.__init__),
            "sp_config": (tsp.sp_config, jsp.sp_config),
            "slice_levels": (tsp.slice_levels, jsp.slice_levels),
            "make_mesh": (tmesh.make_mesh, jmesh.make_mesh),
            "make_dp_train_step": (tmesh.make_dp_train_step, jmesh.make_dp_train_step),
            "grad_step": (ttrain.grad_step, jtrain.grad_step),
            "fit": (ttrain.fit, jtrain.fit)}


@pytest.mark.parametrize("entry", ["StreamingFilter", "sp_config", "slice_levels", "make_mesh",
                                   "make_dp_train_step", "grad_step", "fit"])
def test_sp_dp_defaults_equal_sps_tpu(entry):
    """Every keyword default the port's sp / dp entry point shares with
    sps_tpu's (mesh, sp_axis "sp", sp_ghost_frac / ghost_frac 0, the "dp"
    axis, augment, axis_name / sp_axis None, devices 1) is sps_tpu's."""
    mine, theirs = (inspect.signature(f).parameters for f in _sp_dp_pairs()[entry])
    empty = inspect.Parameter.empty
    shared = [k for k, v in mine.items()
              if k in theirs and v.default is not empty and theirs[k].default is not empty]
    assert shared or entry == "make_dp_train_step"
    for k in shared:
        assert mine[k].default == theirs[k].default, (entry, k)
    want = {"StreamingFilter": {"mesh", "sp_axis", "sp_ghost_frac"}, "sp_config": {"axis",
            "ghost_frac"}, "slice_levels": {"ghost_frac"}, "make_mesh": {"n_devices", "axis"},
            "make_dp_train_step": {"augment"}, "grad_step": {"axis_name", "sp_axis", "map_vm"},
            "fit": {"devices"}}[entry]
    assert want <= set(shared), (entry, want - set(shared))
