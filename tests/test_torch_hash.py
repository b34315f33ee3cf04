"""The port's hash table (sps_torch/ops/hash.py) against sps_tpu's on the same
keys: the hash, the stored keys and rows, slot_of and every lookup bit-equal,
at n in {17, 1000, 5000} with duplicates, invalid rows and negative
coordinates, through the n > 256 compaction, a forced compaction overflow
and a max_rounds truncation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sps_tpu.ops import hash as jhash
from sps_torch.ops import hash as thash


def _keys(rng, n, lo=-50, hi=50, dup_frac=0.5):
    base = rng.integers(lo, hi, size=(max(1, int(n * (1 - dup_frac))), 4))
    return base[rng.integers(0, len(base), size=n)].astype(np.int32)


def _jbuild(coords, valid, cap, max_rounds):
    f = jax.jit(lambda c, v: jhash.build(c, v, cap, max_rounds))
    table, slot_of = f(jnp.asarray(coords), jnp.asarray(valid))
    return np.asarray(table.keys), np.asarray(table.rows), np.asarray(slot_of)


def _tbuild(coords, valid, cap, max_rounds):
    table, slot_of = thash.build(torch.as_tensor(coords), torch.as_tensor(valid), cap,
                                 max_rounds)
    return table, slot_of.numpy()


def _check_build(coords, valid, cap, max_rounds=thash.MAX_ROUNDS):
    jk, jr, js = _jbuild(coords, valid, cap, max_rounds)
    table, ts = _tbuild(coords, valid, cap, max_rounds)
    np.testing.assert_array_equal(table.keys.numpy(), jk)
    np.testing.assert_array_equal(table.rows.numpy(), jr)
    np.testing.assert_array_equal(ts, js)
    assert table.keys.dtype == torch.int32 and table.rows.dtype == torch.int32
    return table, (jk, jr)


def _check_lookup(table, jtable, queries, valid, max_rounds=thash.MAX_ROUNDS):
    jt = jhash.HashTable(keys=jnp.asarray(jtable[0]), rows=jnp.asarray(jtable[1]))
    want = np.asarray(jax.jit(lambda q, v: jhash.lookup(jt, q, v, max_rounds))(
        jnp.asarray(queries), jnp.asarray(valid)))
    got = thash.lookup(table, torch.as_tensor(queries), torch.as_tensor(valid), max_rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def test_mix_is_sps_tpus_uint32_hash():
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**31, 2**31, size=(20000, 4), dtype=np.int64).astype(np.int32)
    keys[:50] = thash.SENTINEL
    keys[50:100] = -1
    want = np.asarray(jax.jit(jhash._mix)(jnp.asarray(keys))).astype(np.int64)
    got = thash._mix(torch.as_tensor(keys)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,cap", [(17, 64), (1000, 4096), (5000, 16384)])
def test_build_and_lookup_bit_equal(n, cap):
    rng = np.random.default_rng(n)
    coords = _keys(rng, n)
    valid = rng.random(n) > 0.1
    table, jt = _check_build(coords, valid, cap)
    queries = np.concatenate([coords, _keys(rng, n, lo=-60, hi=60)])
    qvalid = rng.random(len(queries)) > 0.05
    res = _check_lookup(table, jt, queries, qvalid)
    # Sanity beyond equality: found rows hold the query's key.
    hit = res >= 0
    assert hit.any() and (coords[res[hit]] == queries[hit]).all()


def _clustered(rng, cap, slots, per_slot, n_rest):
    """Keys whose home slots pile up: per_slot distinct keys on each of
    `slots` home slots (spread over the table), then n_rest random keys."""
    cand = np.unique(rng.integers(-2000, 2000, size=(200000, 4)).astype(np.int32), axis=0)
    home = thash._slot0(torch.as_tensor(cand), cap).numpy()
    picked = []
    for s in range(0, cap, cap // slots)[:slots]:
        picked.append(cand[home == s][:per_slot])
    rest = rng.integers(-2000, 2000, size=(n_rest, 4)).astype(np.int32)
    keys = np.concatenate(picked + [rest])
    return keys[rng.permutation(len(keys))]


def test_compaction_overflow():
    """40 home slots hold 10 keys each: more than n // 4 rows still pend
    after the two full-width rounds (the build's phase 3 takes the
    overflow), and more than M // 4 queries miss their home slot (the
    lookup's phase 3); nothing is truncated."""
    rng = np.random.default_rng(1)
    cap = 4096
    coords = _clustered(rng, cap, 40, 10, 600)
    n = len(coords)
    valid = np.ones(n, bool)
    table, jt = _check_build(coords, valid, cap)
    _, ts = _tbuild(coords, valid, cap, thash.MAX_ROUNDS)
    assert (ts >= 0).all()
    c = torch.as_tensor(coords)
    st = {"rows": torch.full((cap + 1,), -1, dtype=torch.int32),
          "keys": torch.full((cap + 1, 4), thash.SENTINEL, dtype=torch.int32),
          "slot_of": torch.full((n,), -1, dtype=torch.int64)}
    pending = torch.ones(n, dtype=torch.bool)
    thash._insert_loop(c, torch.arange(n, dtype=torch.int32), thash._slot0(c, cap), cap, st,
                       pending, torch.zeros(n, dtype=torch.int64), 2, first_test=2)
    assert int(pending.sum()) > n // 4
    queries = np.concatenate([coords[:400], _keys(rng, 200, lo=-60, hi=60)])
    keys = table.keys.numpy()[thash._slot0(torch.as_tensor(queries), cap).numpy()]
    away = (keys != queries).any(-1) & (keys[:, 0] < thash.SENTINEL)
    assert away.sum() > len(queries) // 4
    res = _check_lookup(table, jt, queries, np.ones(len(queries), bool))
    assert (res[:400] >= 0).all()


def test_max_rounds_truncation():
    """With max_rounds 3 at high load some rows stay unresolved (EMPTY), as
    in sps_tpu; lookups truncate the same way."""
    rng = np.random.default_rng(2)
    n, cap = 1000, 1024
    coords = np.unique(_keys(rng, 2 * n, lo=-300, hi=300, dup_frac=0.0), axis=0)[:n]
    valid = rng.random(n) > 0.02
    table, jt = _check_build(coords, valid, cap, max_rounds=3)
    _, ts = _tbuild(coords, valid, cap, 3)
    assert (ts[valid] == thash.EMPTY).any()
    _check_lookup(table, jt, coords, np.ones(n, bool), max_rounds=3)


def test_sync_count():
    """The early-exit tests are the only host syncs, counted exactly: a
    build takes at most one per SYNC_EVERY rounds of its narrow loop and
    its cleanup, and none in its two full-width rounds."""
    rng = np.random.default_rng(3)
    bound = 2 * (1 + -(-thash.MAX_ROUNDS // thash.SYNC_EVERY))
    for n, cap in ((5000, 16384), (17, 64)):
        coords = _keys(rng, n)
        thash.reset_syncs()
        table, _ = thash.build(torch.as_tensor(coords), torch.ones(n, dtype=torch.bool), cap)
        assert 1 <= thash.SYNCS["hash"] <= bound
        thash.reset_syncs()
        thash.lookup(table, torch.as_tensor(coords))
        assert 1 <= thash.SYNCS["hash"] <= bound
