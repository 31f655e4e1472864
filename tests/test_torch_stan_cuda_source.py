"""A Stan model on kernel K2: the CUDA source that
``pigeons_tpu_torch/models/stan_cuda.py`` writes for a model in the scalar
subset of the language, on the CPU.

* Each emitted source (Bernoulli with its beta prior, eight schools
  non-centred, a model with ``<lower, upper>`` bounds, branches and a
  ternary, and binomial likelihoods whose lgamma constants are folded on the
  host, in a loop and vectorized, and device functions of data in nested
  loops, which are folded too) is compiled for the host with ``g++``
  against ``tests/cuda_stub/`` (as ``_build.build_user`` compiles it with
  ``nvcc``) and held bit for bit to its torch form through kernel K2's twin,
  at the launcher's group and at 1, 8, 16 and 32 threads a lane.
* The torch form is held to ``StanTarget.log_density`` within float32
  tolerance (its sums are in order, the density's are torch's).
* One sweep of the eight-schools model through the JAX package's
  ``SliceSamplerPallas`` (Pallas interpreter), which traces the model's
  ``jnp`` density into K2, against the port's twin on the same seeds, 64
  lanes: the lanes whose states differ by more than 1e-5 are counted, at
  most 1.
* The text depends on the data's shapes, not their values; ints beyond 2^24
  are refused; and outside the subset ``SliceSamplerCUDA`` raises a
  ``ValueError`` naming the construct and its line, with no fallback.
"""

import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu_torch import paths
from pigeons_tpu_torch.models import stan as TS
from pigeons_tpu_torch.models import stan_cuda
from pigeons_tpu_torch.models.stan_cuda import StanSubsetError, emit_source
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

STUB = Path(__file__).resolve().parent / "cuda_stub"
sys.path.insert(0, str(STUB))
import host_call  # noqa: E402  (tests/cuda_stub/host_call.py: the children's side)

from test_torch_csrc_host import SHORT, _assert_bitwise, _bayesian_inputs, _in_child  # noqa: E402
from test_torch_user_density import (  # noqa: E402
    USER_GROUPS,
    _host_user_library,
    _jax_sweep,
    _port_sweep,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EIGHT_SCHOOLS = """
data {
  int<lower=0> J;
  array[J] real y;
  array[J] real<lower=0> sigma;
}
parameters {
  vector[J] theta_trans;
  real mu;
  real<lower=0> tau;
}
transformed parameters {
  vector[J] theta;
  theta = theta_trans * tau + mu;
}
model {
  theta_trans ~ normal(0, 1);
  y ~ normal(theta, sigma);
  mu ~ normal(0, 5);
  tau ~ cauchy(0, 5);
}
"""
EIGHT_SCHOOLS_DATA = {"J": 8, "y": [28, 8, -3, 7, -1, 1, 18, 12],
                      "sigma": [15, 10, 16, 11, 9, 11, 10, 18]}

BERNOULLI = """
data { int<lower=0> N; array[N] int<lower=0, upper=1> y; }
parameters { real<lower=0, upper=1> theta; }
model { theta ~ beta(1, 1); y ~ bernoulli(theta); }
"""
BERNOULLI_DATA = {"N": 10, "y": [0, 1, 0, 0, 0, 0, 0, 0, 0, 1]}

BOUNDED = """
data { int<lower=1> N; vector[N] y; real lo; real hi; }
parameters { real<lower=lo, upper=hi> m; real<lower=0> s; array[2] real<upper=3> z; }
model {
  s ~ lognormal(0, 1);
  z ~ logistic(0, 2);
  for (n in 1:N) {
    if (y[n] > m) target += -0.5 * square((y[n] - m) / s) - log(s);
    else y[n] ~ double_exponential(m, s);
  }
  target += z[1] > z[2] ? 0.1 : -0.1;
}
"""
BOUNDED_DATA = {"N": 6, "y": [0.3, -1.2, 2.0, 0.1, 0.9, -0.4], "lo": -2.0, "hi": 2.5}

BINOMIAL = """
data { int<lower=1> N; array[N] int<lower=0> n; array[N] int<lower=1> K; vector[N] w; }
parameters { real<lower=0, upper=1> p; vector[N] z; real<lower=0> tau; }
model {
  tau ~ exponential(1);
  z ~ std_normal();
  for (i in 1:N) {
    n[i] ~ binomial_logit(K[i], logit(p) + tau * z[i]);
    for (j in 2:3)
      target += -0.5 * square(z[i] / exp(w[i])) - log1p(exp(w[K[i] % N + 1]) * j);
  }
  n ~ binomial(K, p);
}
"""
BINOMIAL_DATA = {"N": 5, "n": [3, 0, 7, 2, 5], "K": [10, 4, 9, 6, 5],
                 "w": [0.3, -0.2, 0.1, 0.7, -0.5]}

MODELS = {"bernoulli": (BERNOULLI, BERNOULLI_DATA),
          "eight_schools": (EIGHT_SCHOOLS, EIGHT_SCHOOLS_DATA),
          "bounded": (BOUNDED, BOUNDED_DATA),
          "binomial": (BINOMIAL, BINOMIAL_DATA)}


def _target(name):
    return TS.StanTarget(*MODELS[name])


@pytest.fixture(scope="module")
def user_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("stan_host")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_stan_source_host_build_matches_twin_at_every_group(user_dir, name):
    """The source through kernel K2's host build, at the launcher's group
    and 1, 8, 16, 32 threads a lane, against the twin bit for bit: states,
    returned densities, stats. Seven lanes from the reference, two far out
    and one NaN."""
    t = _target(name)
    assert t.device_refusal is None
    path = t.create_path(t.default_reference())
    density = path.device_density()
    assert density.kind == paths.USER and density.source is t.device_source
    x, betas, seeds = _bayesian_inputs(t, 7, len(name))
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    assert not torch.equal(want[0][0], x[0])
    lib = _host_user_library(density.source, user_dir)
    params = tuple(density.params) + (0.0,) * (8 - len(density.params))
    got = _in_child(host_call.slice_sweep_user_groups, str(lib), x, betas, seeds, params, 10.0,
                    20, 1, SHORT, tuple(a.numpy() for a in density.arrays), USER_GROUPS)
    for g, group in enumerate(USER_GROUPS):
        _assert_bitwise([a[g] for a in got], want, (f"x (group {group})", "lp", "stats"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_torch_form_is_the_stan_density(name):
    """The source's torch form against ``StanTarget.log_density`` at 64
    states from the reference: within 1e-5 relative (1e-4 absolute); the
    two sum in other orders."""
    t = _target(name)
    x = t.initialization(T.rng.keys_for(T.rng.key(2), torch.arange(64)))
    np.testing.assert_allclose(t.device_source.target(x).numpy(), t.log_density(x).numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["bernoulli", "eight_schools"])
def test_stan_density_against_the_library_kind(name):
    """The Stan density against the library's model of the same law and
    data, at 16 states (both order the coordinates alike): Bernoulli with
    its beta(1, 1) prior is ``bernoulli_target()`` exactly, and eight
    schools is ``eight_schools(centered=False)`` (``tau ~ HalfCauchy(5)``)
    less log 2, as Stan's ``cauchy(0, 5)`` on ``tau >= 0`` is not
    renormalized under ``propto=false``: the offset between the two runs'
    logZ that the card's gate reads."""
    t = _target(name)
    lib, offset = {"bernoulli": (T.bernoulli_target(), 0.0),
                   "eight_schools": (T.eight_schools(centered=False), math.log(2.0))}[name]
    x = lib.initialization(T.rng.keys_for(T.rng.key(1), torch.arange(16)))
    np.testing.assert_allclose(lib.log_density(x).numpy(), t.log_density(x).numpy() + offset,
                               rtol=1e-5, atol=1e-4)


def test_eight_schools_sweep_matches_the_pallas_kernel():
    """The eight-schools model through the JAX package's ``SliceSamplerPallas``
    (interpret mode), which traces the ``jnp`` density of its Stan compiler
    into K2, and through the port's twin of K2's user instance, on the same
    64 lanes and seeds: densities within 1e-5, states within 1e-5 relative
    on every lane whose decisions agree, at most one lane of 64 whose
    decisions differ (K2's reference here is unnormalized, the JAX one's
    includes -d/2 log 2 pi, and the sums are in other orders: near ties
    can fall the other way)."""
    jt = J.stan_target(source=EIGHT_SCHOOLS, data=EIGHT_SCHOOLS_DATA)
    t = _target("eight_schools")
    jpath = jt.create_path(jt.default_reference())
    tpath = t.create_path(t.default_reference())
    rs = np.random.RandomState(4)
    xs = rs.normal(size=(64, t.dim)).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, 64).astype(np.float32)
    betas[[0, 1]] = 0.0, 1.0
    out = _port_sweep(tpath, xs, betas, 11)
    ref = _jax_sweep(jpath, xs, betas, 11)
    x, rx = out.x.numpy(), ref["x"]
    off = (np.abs(x - rx) > 1e-5 * np.maximum(np.abs(rx), 1.0)).any(1)
    print(f"{int(off.sum())} of 64 lanes beyond 1e-5")
    assert off.sum() <= 1
    for k in ("accept_sum", "accept_n", "n_steps"):
        assert np.array_equal(getattr(out, k).numpy()[~off], ref[k][~off]), k
    # K2's returned density has the unnormalized reference: add its constant
    lp = out.lp.numpy() - (1.0 - betas) * t.dim * 0.5 * math.log(2.0 * math.pi)
    np.testing.assert_allclose(lp[~off], ref["lp"][~off], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_device_functions_of_data_are_folded(name):
    """No device function in the text reads the array alone: each such call
    (``log(sigma[j])`` of eight schools' normal, ``exp(w[i])`` and
    ``log1p(exp(w[K[i] % N + 1]) * j)`` of the binomial model's nested
    loops) was computed on the host into the array, for every iteration of
    its loops; the text's calls all read the state."""
    code = _target(name).device_source.code
    calls = re.findall(r"(?:cephes_\w+|xla_\w+|softplus|sigmoid|sqrtf|fabsf)\(", code)
    assert calls or name == "eight_schools"
    for m in re.finditer(r"(?:cephes_\w+|xla_\w+|softplus|sigmoid|sqrtf|fabsf)\(", code):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(code[i], 0)
            i += 1
        assert re.search(r"\bx\[|\bv\d+_", code[m.end():i]), code[m.start():i]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_folds_keep_the_twins_bits(name, monkeypatch):
    """The torch form with the folds and without them (each device function
    of data computed at each evaluation) give the same bits at 256 states."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(256, _target(name).dim)) * 2)
    folded = _target(name).device_source
    monkeypatch.setattr(stan_cuda._Emitter, "fold_calls", lambda self, stmts, loops=(): stmts)
    plain = _target(name).device_source
    assert (plain.code != folded.code) == (name in ("binomial", "eight_schools"))
    assert torch.equal(folded.target(x.float()).view(torch.int32),
                       plain.target(x.float()).view(torch.int32))


def test_text_depends_on_shapes_not_values():
    """New values of the same shapes give the same text (one library); a
    new shape gives another; ints that float32 cannot hold are refused."""
    a = _target("eight_schools").device_source
    other = dict(EIGHT_SCHOOLS_DATA, y=[1, 2, 3, 4, 5, 6, 7, 8], sigma=[1] * 8)
    b = TS.StanTarget(EIGHT_SCHOOLS, other).device_source
    assert a.code == b.code and a.key == b.key
    assert not torch.equal(a.arrays[0], b.arrays[0])
    c = TS.StanTarget(EIGHT_SCHOOLS, {"J": 4, "y": [1, 2, 3, 4], "sigma": [1] * 4}).device_source
    assert c.code != a.code
    big = dict(BERNOULLI_DATA, y=[0] * 9 + [2 ** 24 + 2])
    t = TS.StanTarget(BERNOULLI, big)
    assert t.device_source is None and "2^24" in t.device_refusal


OUTSIDE = {
    "matrix parameter": ("parameters { matrix[2, 2] A; } model { to_vector(A) ~ normal(0, 1); }",
                         None, "matrix", 1),
    "lgamma of a parameter": ("parameters { real<lower=0> a; }\nmodel {\n  target += lgamma(a);\n}",
                              None, "lgamma", 3),
    "multivariate density": ("data { vector[2] m; }\nparameters { vector[2] v; }\n"
                             "model { v ~ multi_normal(m, diag_matrix(rep_vector(1.0, 2))); }",
                             {"m": [0.0, 0.0]}, "multi_normal", 3),
    "while": ("parameters { real x; }\nmodel {\n  int i = 0;\n  while (i < 2) { i += 1; }\n"
              "  x ~ normal(0, 1);\n}", None, "int", 3),
    "functions block": ("functions { real f(real z) { return z; } }\nparameters { real x; }\n"
                        "model { x ~ normal(f(0.0), 1); }", None, "functions", 1),
    "truncation": ("parameters { real x; }\nmodel {\n  x ~ normal(0, 1) T[-1, 1];\n}", None,
                   "truncated", 3),
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_outside_the_subset_the_cuda_sampler_refuses(case):
    """Outside the subset the target has no device source and
    ``SliceSamplerCUDA`` raises a ``ValueError`` naming the construct, its
    line and the two ways on: the torch ``SliceSampler`` with the sampler's
    values, or the default ``AutoMALA()``; the run does not fall back."""
    src, data, word, line = OUTSIDE[case]
    t = TS.StanTarget(src, data)
    assert t.device_source is None
    assert word in t.device_refusal and f"(line {line})" in t.device_refusal
    with pytest.raises(ValueError, match=r"SliceSampler\(w=10.0, p=20, n_passes=1.*AutoMALA"):
        T.PT(T.Inputs(target=t, n_chains=3, explorer=SliceSamplerCUDA(n_passes=1), device="cpu"))
    assert t.log_density(torch.zeros(2, t.dim)).shape == (2,)


def test_emit_source_raises_the_subset_error():
    with pytest.raises(StanSubsetError, match="matrix"):
        emit_source(TS.StanTarget(OUTSIDE["matrix parameter"][0]))


def test_bernoulli_runs_on_the_k2_route():
    """A short run of the Bernoulli model with ``SliceSamplerCUDA`` on CPU
    tensors: the path's device density is the Stan source (kind ``USER``),
    the twin runs (no kernel launch), and the run is the same run twice."""
    kw = dict(target=T.stan_target(source=BERNOULLI, data=BERNOULLI_DATA), n_chains=4,
              n_rounds=3, seed=2, show_report=False, explorer=SliceSamplerCUDA(n_passes=1),
              device="cpu")
    before = dict(SliceSamplerCUDA.launches)
    a, b = T.pigeons(**kw), T.pigeons(**kw)
    assert SliceSamplerCUDA.launches == before
    assert a.path.device_density().kind == paths.USER
    assert torch.equal(a.states, b.states)
    theta = a.inputs.target.constrained_samples(a)["theta"]
    assert ((theta > 0) & (theta < 1)).all()
    assert np.isfinite(a.reports[-1].log_z_estimate)
