"""The port's DEO swaps and recorders against the JAX package, bitwise.

Inputs (log-ratios, acceptance statistics, recorder deltas) are made with
numpy from a seed and handed to both packages. The swap decisions, the
permutations, the acceptance probabilities, the Kahan stacks, the
round-trip machine and the streaming logsumexps must agree bit for bit: the
port evaluates ``exp``/``logaddexp`` with XLA's own float32 polynomials
(``pigeons_tpu_torch/f32math.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigeons_tpu import recorders as jrec
from pigeons_tpu import rng as jrng
from pigeons_tpu import swaps as jswaps
from pigeons_tpu_torch import recorders as trec
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch import swaps as tswaps


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [1, 2, 5, 10])
def test_deo_partner_map_bitwise(n):
    for scan_idx in range(1, 6):
        j = np.asarray(jswaps.deo_partner_map(n, scan_idx))
        t = tswaps.deo_partner_map(n, scan_idx).numpy()
        assert np.array_equal(j, t)


def _random_permutations(rs, R, n):
    chain_of = np.stack([rs.permutation(n) for _ in range(R)]).astype(np.int32)
    replica_of = np.argsort(chain_of, axis=1).astype(np.int32)
    return chain_of, replica_of


@pytest.mark.parametrize("n", [1, 2, 5, 10])
@pytest.mark.parametrize("R", [1, 4])
def test_swap_scan_bitwise(n, R):
    """One ladder (the JAX call as is) and a batch of 4 (JAX vmapped)."""
    rs = np.random.RandomState(100 * n + R)
    for scan_idx in (1, 2, 3):
        chain_of, replica_of = _random_permutations(rs, R, n)
        log_ratio = (rs.normal(size=(R, n)) * 2.0 - 0.5).astype(np.float32)
        seeds = rs.randint(0, 2**31, R)
        jkeys = jnp.stack([jax.random.key_data(jrng.scan_key(jrng.master_key(int(s)), 2, scan_idx, 1))
                           for s in seeds])
        tkeys = torch.stack([trng.scan_key(trng.master_key(int(s)), 2, scan_idx, 1) for s in seeds])

        def one(k, co, ro, lr):
            res = jswaps.swap_scan(jax.random.wrap_key_data(k), scan_idx, co, ro, lr)
            return res.chain_of, res.replica_of, res.accept_pr, res.do_swap

        jout = jax.jit(jax.vmap(one))(jkeys, jnp.asarray(chain_of), jnp.asarray(replica_of),
                             jnp.asarray(log_ratio))
        if R == 1:  # the unbatched JAX call gives the same as its vmapped form
            single = jax.jit(one)(jkeys[0], chain_of[0], replica_of[0], log_ratio[0])
            for a, b in zip(single, jout):
                assert np.array_equal(_bits(a), _bits(np.asarray(b)[0]))
        tres = tswaps.swap_scan(tkeys, scan_idx, torch.as_tensor(chain_of, dtype=torch.int64),
                                torch.as_tensor(replica_of, dtype=torch.int64),
                                torch.from_numpy(log_ratio))
        tout = (tres.chain_of, tres.replica_of, tres.accept_pr, tres.do_swap)
        for name, a, b in zip(("chain_of", "replica_of", "accept_pr", "do_swap"), jout, tout):
            a, b = np.asarray(a), b.numpy()
            assert np.array_equal(_bits(a.astype(b.dtype) if a.dtype != np.float32 else a), _bits(b)), name


@pytest.mark.parametrize("shape", [(), (3,), (4, 6)])
def test_kadd_bitwise(shape):
    rs = np.random.RandomState(len(shape))
    jacc = jrec.kinit(*shape)
    tacc = trec.kinit(*shape)
    for _ in range(300):
        delta = np.asarray(rs.normal(size=shape) * 10.0 ** rs.randint(-6, 6), dtype=np.float32)
        jacc = jrec.kadd(jacc, jnp.asarray(delta))
        tacc = trec.kadd(tacc, torch.from_numpy(delta)[None])
    assert np.array_equal(_bits(np.asarray(jacc)), _bits(tacc[0].numpy()))


def test_update_round_trips_bitwise():
    rs = np.random.RandomState(7)
    n, R = 6, 3
    jr = [jrec.init_recorders(n, 3) for _ in range(R)]
    tr = trec.init_recorders(n, 3, R=R)
    for _ in range(200):
        is_ref = rs.uniform(size=(R, n)) < 0.3
        is_tgt = rs.uniform(size=(R, n)) < 0.3
        jr = [jrec.update_round_trips(r, jnp.asarray(is_ref[i]), jnp.asarray(is_tgt[i]))
              for i, r in enumerate(jr)]
        tr = trec.update_round_trips(tr, torch.from_numpy(is_ref), torch.from_numpy(is_tgt))
    for f in ("rt_state", "rt_restarts", "rt_trips"):
        j = np.stack([np.asarray(getattr(r, f)) for r in jr])
        assert np.array_equal(j, getattr(tr, f).numpy()), f


def test_update_logsum_bitwise():
    rs = np.random.RandomState(8)
    m = 9
    jl, jn = jnp.full(m, -jnp.inf, jnp.float32), jnp.zeros(m, jnp.float32)
    tl, tn = torch.full((m,), -float("inf")), torch.zeros(m)
    for _ in range(300):
        value = (rs.normal(size=m) * 20.0).astype(np.float32)
        active = rs.uniform(size=m) < 0.7
        jl, jn = jrec.update_logsum(jl, jn, jnp.asarray(value), jnp.asarray(active))
        tl, tn = trec.update_logsum(tl, tn, torch.from_numpy(value), torch.from_numpy(active))
    assert np.array_equal(_bits(np.asarray(jl)), _bits(tl.numpy()))
    assert np.array_equal(_bits(np.asarray(jn)), _bits(tn.numpy()))


@pytest.mark.parametrize("R", [1, 3])
def test_reduce_recorders_equal(R):
    """Random recorder contents in both layouts reduce to the same numbers."""
    rs = np.random.RandomState(9 + R)
    n, dx = 5, 4
    trecs = trec.init_recorders(n, dx, 0, R=R)
    fields = {}
    for f, t in trecs._asdict().items():
        if t.dtype == torch.int32:
            v = rs.randint(0, 5, size=t.shape).astype(np.int32)
        else:
            v = np.abs(rs.normal(size=t.shape)).astype(np.float32) * 10.0
            if f.startswith("lsr"):
                v = v - 20.0
        fields[f] = v
    tred = trec.reduce_recorders(trec.Recorders(**{f: torch.from_numpy(v) for f, v in fields.items()}), R)
    jfields = {f: jnp.asarray(v if R > 1 else v[0]) for f, v in fields.items()}
    jred = jrec.reduce_recorders(jrec.Recorders(**jfields), R)
    for f in jred._fields:
        a, b = getattr(jred, f), getattr(tred, f)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
