"""The int8 shipping path against sps_tpu, layer by layer (CPU, f32 master
weights): where the port's filter and sps_tpu's part, and why.

test_torch_shipping.py's configuration (config_small.yaml with the TPU
options of config/config.yaml: atlas engine, CONV_MODE halo, INT8,
HEAD_FOLD; bf16 off; MinkUNet14 narrowed) and seeded weights, on one scan
of each of two 12 m worlds: ROADMAP.md §3's world
(`make_world(seed=3, extent=6, n_stable=8, ground_points=4000)`, one
`sample_scan` at (0.5, 0) with 400 rays, no clutter) and a second seeded
world. On both the port's scores differ from jitted sps_tpu's by more than
the int8 score tolerance of tests/test_torch_halo.py (2e-3; measured
3.05e-3 and 2.08e-3, printed by the last test).

Every call of brick_conv_int8 is recorded on both sides: its input, the
activation codes q and scale s_in, the weight codes and s_w, and, on
sps_tpu's side, the pre-round values x / s_in (x * (1 / s_in)) from inside
the jitted filter (jax.debug.callback). What the tests hold:

1. No departure of semantics: given sps_tpu's input at a call, the port's
   quantize_act gives sps_tpu's codes and s_in exactly, and its
   quantize_weight sps_tpu's weight codes and s_w exactly, at every call.
2. The first call whose codes differ gets inputs that agree within f32
   summation order (rtol 1e-5 / atol 1e-6: the float layers before it sum
   in another order in the two frameworks), every call before it has
   equal codes, and each differing code there lies at a rounding tie: the
   port's and sps_tpu's pre-round values lie on either side of k + 0.5,
   within TIE_RTOL of each other. One code step of that conv changes its
   output by up to s_in * max|w|, which moves the next layer's per-tensor
   abs-max and so the scale of every later int8 conv: hundreds of codes
   differ downstream, and the score moves by more than one step's 2e-3.
3. Ties are the only cause: the port's filter with its codes at those
   ties set to sps_tpu's (the codes that differ while the two pre-round
   values straddle a tie within TIE_RTOL) holds sps_tpu's scores within
   the INT8-off tolerance (rtol 1e-3 / atol 1e-4) and has every code equal
   at every call.

sps_tpu parts the same way from itself, jitted against op by op
(jax.disable_jit()): on the first world a tie code at a later call moves a
score by 1.4e-4; on the second the port equals op-by-op sps_tpu within
3e-7 and jitted sps_tpu parts from both at a code whose pre-round value
lies exactly on a tie. So no f32 bound on int8 scores holds on every scan.

The tests read jitted sps_tpu's scores and records from a pin
(scripts/export_torch_assets.py --only int8_divergence,
sps_torch/assets/int8_divergence_pin.npz), which records the world, the
configuration and the weights they came from. The per-call tables run
sps_tpu live (with --nojit, op-by-op sps_tpu too; ~4 min):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_int8_divergence.py [--nojit]
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_halo import INT8_ATOL
from test_torch_shipping import META as SHIP_META
from test_torch_shipping import _load
from test_torch_stream import _flax_tree, _pad, pinned
from test_torch_stream import pin_record as pin_record_of

import sps_tpu.config as jcfg_mod
import sps_tpu.ops.brick as jbk
import sps_torch.config as tcfg_mod
import sps_torch.ops.brick as tbk
from sps_tpu.data import synthetic
from sps_tpu.stream.engine import StreamingFilter as JFilter
from sps_torch.models import spsnet as tsps
from sps_torch.stream.engine import StreamingFilter as TFilter

# world seed, scan rng seed: ROADMAP §3's world and a second one.
WORLDS = {"roadmap": (3, 14), "world7": (7, 4)}
# Inputs of the first differing call: f32 summation order apart.
INPUT_RTOL, INPUT_ATOL = 1e-5, 1e-6
# Two pre-round values straddling a tie lie within this relative distance.
TIE_RTOL = 4e-6
# What a record of sps_tpu's holds per call of brick_conv_int8.
RECORD_KEYS = ("feats", "q", "pre", "s_in", "w8", "s_w")
META = dict(SHIP_META, scan=dict(extent=6, n_stable=8, ground_points=4000,
                                 origin=(0.5, 0.0), n_rays=400))


def scan_args(world_seed, scan_seed, ns):
    """The world's map and its scan (map frame, padded to ns), from numpy seeds."""
    stable = synthetic.make_world(seed=world_seed, extent=6, n_stable=8, ground_points=4000)
    rng = np.random.default_rng(scan_seed)
    pts, lab = synthetic.sample_scan(rng, stable, np.zeros((0, 3), np.float32),
                                     np.array([0.5, 0.0]), n_rays=400)
    scan = np.concatenate([pts, lab[:, None]], 1).astype(np.float32)
    return stable, _pad(scan, ns) + (np.eye(4, dtype=np.float32),)


# Per thread: sps_tpu's records by call ("j"), or the port's ("t"), the
# tie-aligned port's ("a"), the port's weight codes ("w"), and sps_tpu's
# records the port aligns to (None: no alignment yet).
RECORDS: dict[int, dict] = {}


def _records():
    return RECORDS[threading.get_ident()]


def recording_sps_tpu_conv(orig):
    """sps_tpu's brick_conv_int8 `orig` (sps_tpu/ops/brick.py:703) with its
    quantization repeated beside it, the same expressions, to hand q, the
    pre-round values x * (1 / s_in), s_in, the weight codes and s_w to a
    host callback; the filter gets the original's output."""

    def conv(feats, nbr27, w_dense, occ, *, mask_out=True, center=None):
        rec = _records()["j"]
        call = len(rec)  # the call's place, fixed while tracing
        rec.append(None)
        amax = jnp.max(jnp.abs(feats)).astype(jnp.float32)
        s_in = jnp.maximum(amax, 1e-12) * (1.0 / 127.0)
        pre = feats.astype(jnp.float32) * (1.0 / s_in)
        q = jnp.clip(jnp.round(pre), -127.0, 127.0).astype(jnp.int8)
        wf = w_dense.astype(jnp.float32)
        s_w = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2, 3)), 1e-12) * (1.0 / 127.0)
        wq = jnp.clip(jnp.round(wf / s_w), -127.0, 127.0).astype(jnp.int8)

        def record(*a):
            rec[call] = dict(zip(RECORD_KEYS, (np.array(x) for x in a)))

        jax.debug.callback(record, feats, q, pre, s_in, wq, s_w)
        return orig(feats, nbr27, w_dense, occ, mask_out=mask_out, center=center)

    return conv


def recording_port_quantize(orig):
    """The port's quantize_act `orig`, recording its input, codes, scale
    and pre-round values. While aligning (sps_tpu's records of the same
    scan), a code that differs from sps_tpu's while the two pre-round
    values straddle a tie within TIE_RTOL takes sps_tpu's code."""

    def quantize(feats):
        r = _records()
        q, s_in = orig(feats)
        pre = (feats.float() * (1.0 / s_in)).numpy()
        rec, n_aligned = r["t" if r["align"] is None else "a"], 0
        if r["align"] is not None:
            want = r["align"][len(rec)]
            tie = straddles(pre, want["pre"]) & (q.numpy() != want["q"])
            n_aligned = int(tie.sum())
            q = torch.where(torch.from_numpy(tie), torch.from_numpy(want["q"]), q)
        rec.append(dict(feats=feats.numpy().copy(), q=q.numpy().copy(), s_in=s_in.numpy(),
                        pre=pre, aligned=n_aligned))
        return q, s_in

    return quantize


def recording_port_weights(orig):
    """The port's quantize_weight `orig`, recording the codes (in sps_tpu's
    (k, k, k, TCin, TCout) layout) and s_w."""

    def quantize(w_dense):
        w8, s_w = orig(w_dense)
        _records()["w"].append(dict(w8=w8.contiguous().numpy(), s_w=s_w.numpy()))
        return w8, s_w

    return quantize


def straddles(a, b):
    """Where k + 0.5 lies between a and b for some integer k, with a and b
    within TIE_RTOL of each other."""
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    tie = np.floor(hi - 0.5) + 0.5
    return (tie >= lo) & (hi - lo <= TIE_RTOL * np.maximum(np.abs(hi), 1.0))


def _setup(name):
    """Both packages' configurations, the seeded weights and the world's scan."""
    cfg_t, cfg_j = _load(tcfg_mod), _load(jcfg_mod)
    sd = tsps.init_state_dict(cfg_t.sps_config(1), seed=0)
    return (cfg_t, cfg_j, sd, *scan_args(*WORLDS[name], cfg_t.tpu.scan_points))


def pin_record(name):
    """What int8_divergence_pin.npz records of a world's inputs."""
    _, _, sd, stable, args = _setup(name)
    return pin_record_of({**META, "world": WORLDS[name]}, stable, [args], sd)


def sps_tpu_world(name, nojit=False):
    """sps_tpu's filter (jitted, or op by op) on the world's scan, its
    int8 conv patched to record: the scores and the records by call."""
    _, cfg_j, sd, stable, args = _setup(name)
    RECORDS[threading.get_ident()] = dict(j=[])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbk, "brick_conv_int8", recording_sps_tpu_conv(jbk.brick_conv_int8))
        f_j = JFilter(cfg_j, jax.tree.map(np.asarray, _flax_tree(sd)), stable)
        with jax.disable_jit(nojit):
            s_j = np.asarray(f_j(*args)[0])
    return s_j, RECORDS.pop(threading.get_ident())["j"]


def pinned_world(name):
    """sps_tpu_world(name) as scripts/export_torch_assets.py --only
    int8_divergence pinned it (sps_torch/assets/int8_divergence_pin.npz)."""
    pin = pinned("int8_divergence_pin.npz", name, pin_record(name))
    return pin["s_j"], [{k: pin[f"{i}/{k}"] for k in RECORD_KEYS} for i in range(pin["calls"])]


def run_world(name, sps_tpu):
    """The port's filter on the world's scan, then with its tie codes
    aligned to sps_tpu's, its quantization patched to record, beside
    sps_tpu's results `sps_tpu` (sps_tpu_world's)."""
    cfg_t, _, sd, stable, args = _setup(name)
    s_j, rec_j = sps_tpu
    r = RECORDS[threading.get_ident()] = dict(t=[], a=[], w=[], align=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbk, "quantize_act", recording_port_quantize(tbk.quantize_act))
        mp.setattr(tbk, "quantize_weight", recording_port_weights(tbk.quantize_weight))
        s_t = TFilter(cfg_t, sd, stable, device="cpu")(*args)[0].numpy()
        r["align"] = rec_j
        s_a = TFilter(cfg_t, sd, stable, device="cpu")(*args)[0].numpy()
    return dict(s_j=s_j, s_t=s_t, s_a=s_a, rec_j=rec_j, rec_t=r["t"], rec_a=r["a"],
                rec_w=r["w"][:len(r["t"])], valid=args[1])


@pytest.fixture(scope="module")
def worlds():
    return {name: run_world(name, pinned_world(name)) for name in sorted(WORLDS)}


@pytest.fixture(params=sorted(WORLDS))
def world(worlds, request):
    return worlds[request.param]


def first_divergence(rec_t, rec_j):
    """The first call whose codes differ, or None."""
    return next((i for i, (t, j) in enumerate(zip(rec_t, rec_j))
                 if not np.array_equal(t["q"], j["q"])), None)


def test_int8_codes_follow_sps_tpu_semantics(world):
    rec_j = world["rec_j"]
    assert len(rec_j) == len(world["rec_t"]) == len(world["rec_w"]) == 10
    for i, (j, w) in enumerate(zip(rec_j, world["rec_w"])):
        q, s_in = tbk.quantize_act(torch.from_numpy(j["feats"]))
        np.testing.assert_array_equal(q.numpy(), j["q"], err_msg=f"call {i}")
        assert np.float32(s_in) == j["s_in"], i
        np.testing.assert_array_equal(w["w8"], j["w8"], err_msg=f"call {i}")
        np.testing.assert_array_equal(w["s_w"], j["s_w"], err_msg=f"call {i}")


def test_int8_first_divergence_is_a_tie(world):
    rec_t, rec_j = world["rec_t"], world["rec_j"]
    c = first_divergence(rec_t, rec_j)
    assert c is not None  # both scans diverge (module docstring)
    for t, j in zip(rec_t[:c], rec_j[:c]):
        np.testing.assert_allclose(t["feats"], j["feats"], rtol=INPUT_RTOL, atol=INPUT_ATOL)
    t, j = rec_t[c], rec_j[c]
    np.testing.assert_allclose(t["feats"], j["feats"], rtol=INPUT_RTOL, atol=INPUT_ATOL)
    diff = t["q"] != j["q"]
    assert np.abs(t["q"].astype(int) - j["q"].astype(int)).max() == 1
    assert straddles(t["pre"][diff], j["pre"][diff]).all()
    assert diff.sum() <= 4


def test_int8_tie_aligned_port_matches_sps_tpu(world):
    rec_a, rec_j = world["rec_a"], world["rec_j"]
    assert first_divergence(rec_a, rec_j) is None
    n_aligned = sum(r["aligned"] for r in rec_a)
    assert 1 <= n_aligned <= 8
    np.testing.assert_allclose(world["s_a"], world["s_j"], rtol=1e-3, atol=1e-4)
    d = float(np.abs(world["s_t"] - world["s_j"])[world["valid"]].max())
    print(f"port vs sps_tpu (jit): max |dscore| {d:.3e} (int8 tolerance {INT8_ATOL}); "
          f"with {n_aligned} tie codes aligned "
          f"{float(np.abs(world['s_a'] - world['s_j']).max()):.3e}")


def print_table(label, w, other=None):
    """Per call of one world's scan: the inputs' max difference, the codes
    that differ and how far sps_tpu's pre-round values lie from a tie,
    for the port against sps_tpu, or for sps_tpu's records `other`
    (op by op) against them."""
    rec_t = w["rec_t"] if other is None else other["rec_j"]
    s_t = w["s_t"] if other is None else other["s_j"]
    print(f"{label}: max |dscore| {np.abs(s_t - w['s_j']).max():.3e}"
          + (f", tie-aligned port {np.abs(w['s_a'] - w['s_j']).max():.3e}" if other is None
             else ""))
    for i, (t, j) in enumerate(zip(rec_t, w["rec_j"])):
        diff = t["q"] != j["q"]
        dist = np.abs(np.abs(j["pre"][diff] - np.trunc(j["pre"][diff])) - 0.5)
        print(f"  call {i} {tuple(t['feats'].shape)}: max |dx| "
              f"{np.abs(t['feats'] - j['feats']).max():.3e} (max |x| "
              f"{np.abs(j['feats']).max():.3e}), s_in {float(t['s_in']):.9e} / "
              f"{float(j['s_in']):.9e}, codes differing {int(diff.sum())}"
              + (f" (sps_tpu's pre-round values {dist.min():.2e} to {dist.max():.2e} from "
                 f"a tie)" if diff.any() else "")
              + (f", aligned {w['rec_a'][i]['aligned']}" if other is None else ""))


def main(argv=None):
    """Print, per world, the port against jitted sps_tpu call by call; with
    --nojit also the port against sps_tpu run op by op
    (jax.disable_jit()) and jitted sps_tpu against op-by-op sps_tpu."""
    jit = {name: run_world(name, sps_tpu_world(name)) for name in sorted(WORLDS)}
    nojit = ({name: run_world(name, sps_tpu_world(name, nojit=True)) for name in sorted(WORLDS)}
             if "--nojit" in (argv or []) else {})
    for name in sorted(WORLDS):
        print_table(f"{name}: port vs sps_tpu jitted", jit[name])
        if name in nojit:
            print_table(f"{name}: port vs sps_tpu op by op", nojit[name])
            print_table(f"{name}: sps_tpu op by op vs jitted", jit[name], nojit[name])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:])
