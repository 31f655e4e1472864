"""Carry run state across from the JAX package.

A library model's observations come across as numpy arrays
(:func:`bayesian_model_from_numpy`), so that both packages compute on the
same data; ``pigeons_tpu/checkpoint.py:write_checkpoint`` stores a run's state as the
numpy arrays ``states``, ``chain_of``, ``replica_of`` and ``schedule``; a run
with a variational reference also has ``schedule_var`` (two legs) and the
reference's parameters ``ref_params_mean``, ``ref_params_std`` and
``ref_params_active``.
:func:`state_from_numpy` loads such arrays into a port :class:`~.pt.PT`
built from the same ``Inputs``, so that both packages continue one run from
one state: round ``round_idx + 1`` then draws from the same keys in both.
:func:`explorer_state_from_numpy` does the same for an adapted explorer's
state (a gradient explorer's ``step_size`` and ``std_devs``, a combinator's
tuple of them).
"""

from __future__ import annotations

import numpy as np
import torch

from .schedule import Schedule


def bayesian_model_from_numpy(name: str, **data):
    """The port's library model ``name`` on the JAX model's own data, given
    as numpy arrays: ``hierarchical_normal`` takes ``data [n_groups,
    n_per_group]`` (the observations its likelihood closes over),
    ``eight_schools`` ``y [J]``, ``sigma [J]`` and optionally ``centered``,
    ``logistic_regression`` ``X [n, d]`` and ``y [n]``, ``unid_target``
    ``n_trials`` and ``n_successes``, ``bernoulli_target`` ``data [n]``,
    ``mrna_target`` ``ts [n]`` and ``ys [n]``."""
    from .models import library

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    if name == "hierarchical_normal":
        return library.hierarchical_normal(data=f32(data["data"]))
    if name == "eight_schools":
        return library.eight_schools(bool(data.get("centered", False)), y=f32(data["y"]),
                                     sigma=f32(data["sigma"]))
    if name == "logistic_regression":
        return library.logistic_regression(X=f32(data["X"]), y=f32(data["y"]))
    if name == "unid_target":
        return library.unid_target(int(data["n_trials"]), int(data["n_successes"]))
    if name == "bernoulli_target":
        return library.bernoulli_target(np.asarray(data["data"], dtype=np.float32))
    if name == "mrna_target":
        return library.mrna_target(f32(data["ts"]), f32(data["ys"]))
    raise ValueError(f"no library model {name!r}: the JAX package's library has no such "
                     "BayesianModel")


def state_from_numpy(pt, arrays, round_idx: int):
    """Load ``arrays`` (a mapping with ``states [(R,) N, d]``, ``chain_of``
    and ``replica_of [(R,) N]``, ``schedule``: the fixed leg's grid; for a
    two-leg run ``schedule_var``, the variational leg's; for a run with a
    variational reference ``ref_params_mean [d]``, ``ref_params_std [d]`` and
    ``ref_params_active``) as the state after round ``round_idx``. Returns
    ``pt``."""
    R, n, d = pt.n_replicates, pt.n_chains, pt.dim
    states = np.asarray(arrays["states"], dtype=np.float32)
    chain_of = np.asarray(arrays["chain_of"])
    replica_of = np.asarray(arrays["replica_of"])
    want = (n, d) if R == 1 else (R, n, d)
    if states.shape != want or chain_of.shape != want[:-1] or replica_of.shape != want[:-1]:
        raise ValueError(
            f"expected states {want} and permutations {want[:-1]}, got "
            f"{states.shape}, {chain_of.shape}, {replica_of.shape}"
        )
    dev = pt.device
    pt.set_run_state(states, chain_of, replica_of)
    pt.schedule = Schedule(np.asarray(arrays["schedule"], dtype=np.float64))
    if pt.two_leg:
        pt.schedule_var = Schedule(np.asarray(arrays["schedule_var"], dtype=np.float64))
    if pt.variational is not None:
        pt._ref_params = {
            "mean": torch.tensor(np.asarray(arrays["ref_params_mean"], dtype=np.float32), device=dev),
            "std": torch.tensor(np.asarray(arrays["ref_params_std"], dtype=np.float32), device=dev),
            "active": torch.tensor(float(arrays["ref_params_active"]), dtype=torch.float32, device=dev),
        }
    pt.round_idx = int(round_idx)
    return pt


def explorer_state_from_numpy(pt, exp_state):
    """Load the JAX run's explorer state ``exp_state`` (a mapping of arrays
    ``[n_chains, ...]``, e.g. ``step_size [N]`` and ``std_devs [N, d]`` of
    ``MALA`` / ``AutoMALA``; for a combinator a tuple of its components'
    states) into ``pt``, as float32 tensors on its device. Returns ``pt``."""
    want = pt.explorer.init_state(pt.n_chains, pt.dim, pt.device)
    if not want:
        raise ValueError(f"{type(pt.explorer).__name__} keeps no adapted state")

    def load(like, given, where):
        if isinstance(like, dict):
            return {name: load(v, given[name], f"{where}[{name!r}]") for name, v in like.items()}
        if isinstance(like, tuple):
            return tuple(load(v, g, f"{where}[{i}]") for i, (v, g) in
                         enumerate(zip(like, given, strict=True)))
        arr = np.asarray(given, dtype=np.float32)
        if arr.shape != tuple(like.shape):
            raise ValueError(f"{where}: expected {tuple(like.shape)}, got {arr.shape}")
        return torch.tensor(arr, device=pt.device)

    pt.exp_state = load(want, exp_state, "exp_state")
    return pt
