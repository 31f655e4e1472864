"""At which shapes of the design matrix XLA's CPU code computes the logistic
regression's ``X @ w`` in column order, and where as a dense product.

    JAX_PLATFORMS=cpu python tests/logistic_form_study.py [--lanes 64]

For each ``(n, d)`` of the grid the JAX model ``logistic_regression(n, d,
seed=0)`` and the port's, on the JAX model's ``X`` and ``y``, evaluate the
same ``lanes`` states (``0.1 N(0, 1)`` from numpy seed 1). The JAX side is
``jit(vmap(log_density))`` and ``jit(vmap(value_and_grad(log_density)))``;
the port's is its prior plus each form of
``LogisticRegressionLikelihood``: the column form (``sweep``, a fused
multiply-add per column, summed by windows) and the dense form (``dense``,
one float32 product). For each form the script prints the share of the
logits that equal JAX's bit for bit, the lanes whose
density equals each JAX density bit for bit, the lanes whose gradient does,
the largest relative gap of the density and the largest gap of a gradient
component relative to the lane's largest. The form that gives more bitwise
lanes is XLA's order at that shape, or closer to it; ``rule`` is the one
the likelihood takes (``uses_dense``). A third candidate is the column form with
its windows' sums added by windows again where there are more than 32 of
them (``windows_of_windows``): the order of XLA's long sums, which the port's
column form and the slice kernel do not follow.

Not a test: a study (about a minute); ``tests/test_torch_logistic_dense.py``
holds the rule at the shapes it names.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pigeons_tpu as J  # noqa: E402
from pigeons_tpu_torch import convert  # noqa: E402
from pigeons_tpu_torch.models import library  # noqa: E402
from pigeons_tpu_torch.models.bayesian import BayesianModel  # noqa: E402

SHAPES = ((200, 10), (512, 10), (1024, 10), (1024, 32), (1024, 128), (1024, 256), (256, 256),
          (1025, 10), (1088, 10), (1536, 10), (2048, 10), (4096, 10), (4096, 128), (1536, 256),
          (4096, 256), (8192, 256))


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _window_sums(terms, window=32):
    """The windows' sums of ``library.sum_by_windows``, before it adds them."""
    n = terms.shape[-1]
    pad = (-n) % window
    rows = torch.nn.functional.pad(terms, (pad // 2, pad - pad // 2)).reshape(
        terms.shape[:-1] + (-1, window))
    acc = torch.zeros_like(rows[..., 0])
    for col in rows.unbind(-1):
        acc = acc + col
    return acc


def windows_of_windows(terms, window=32):
    """``sum_by_windows`` with more than ``window`` windows' sums added up by
    windows again, until ``window`` or fewer are left to add in order."""
    while terms.shape[-1] > window:
        terms = _window_sums(terms, window)
    return library.sum_by_windows(terms, window)


def port_value_and_grad(model, x):
    xg = torch.from_numpy(x).requires_grad_(True)
    lp = model.log_density(xg)
    (g,) = torch.autograd.grad(lp.sum(), xg)
    return lp.detach().numpy(), g.numpy()


def study(n, d, lanes):
    import jax

    jm = J.logistic_regression(n, d, seed=0)
    fn = jm.log_likelihood_fn
    tm = convert.bayesian_model_from_numpy("logistic_regression", X=_closure(fn, "X"),
                                           y=_closure(fn, "y"))
    like = tm.log_likelihood_fn
    x = (np.random.RandomState(1).normal(size=(lanes, jm.dim)) * 0.1).astype(np.float32)
    jv = np.asarray(jax.jit(jax.vmap(jm.log_density))(x))
    jvg_v, jvg_g = (np.asarray(a) for a in
                    jax.jit(jax.vmap(jax.value_and_grad(jm.log_density)))(x))
    X = _closure(fn, "X")
    jz = np.asarray(jax.jit(jax.vmap(lambda w, b: X @ w + b))(x[:, :d], x[:, d]))
    q = tm.constrain(torch.from_numpy(x))[0]
    nested = (tm.log_prior(torch.from_numpy(x))
              + windows_of_windows(like.terms(q))).numpy()
    out = {"nested": int((nested == jv).sum()), "rule": "dense" if like.uses_dense else "column"}
    for form in ("sweep", "dense"):
        z = (like.column_logits if form == "sweep" else like.dense_logits)(q).numpy()
        v, g = port_value_and_grad(BayesianModel(tm.priors, getattr(like, form)), x)
        rel = np.abs(v.astype(np.float64) - jvg_v) / np.abs(jvg_v)
        grel = np.abs(g - jvg_g).max(1) / np.abs(jvg_g).max(1)
        out[form] = (f"logits {(z == jz).mean():.1%}, value {int((v == jv).sum())} / "
                     f"{int((v == jvg_v).sum())}, gradient {int((g == jvg_g).all(1).sum())}, "
                     f"max rel {rel.max():.2g}, grad {grel.max():.2g}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(1)
    print(f"lanes of {args.lanes} bitwise: value (against log_density / value_and_grad), "
          "gradient; largest gaps")
    for n, d in SHAPES:
        res = study(n, d, args.lanes)
        print(f"{n} x {d} (rule: {res['rule']}): column form {res['sweep']}; dense form "
              f"{res['dense']}; column form with windows of windows: value {res['nested']}",
              flush=True)


if __name__ == "__main__":
    main()
