"""The PT runtime: rounds of (explore, communicate) scans with adaptation.

Counterpart of ``pigeons_tpu/pt.py`` on one device (reference
``src/pt/pigeons.jl``). Round r runs 2^r scans. Each scan:

* explore: the explorer moves the whole batch of ``R * N`` lanes (``R``
  independent ladders of ``N`` chains, flattened), and the reference chain
  of every ladder regenerates iid;
* densities: own-beta and partner-beta log densities of the moved states in
  one pass (the swap's partner evaluation shares ``sum(x * x)``);
* recorders, then the DEO swap as a permutation update of ``[R, N]`` index
  tensors (``swaps.py``).

With ``n_chains_variational > 0`` the ladder has two legs (stabilized
variational PT, reference ``src/tempering/StabilizedPT.jl``): chains
``0..n_var-1`` anneal from a Gaussian reference fitted between rounds to the
target at ``n_var-1``, chains ``n_var..N-1`` are the fixed leg reversed
(target at ``n_var``, fixed reference at ``N-1``). Both references regenerate
iid, the two middle chains are both targets, and each leg adapts its own
schedule. The blend of the two references is :class:`~.paths.VariationalPath`.

With ``Inputs.mesh`` (a :class:`~.parallel.ReplicaMesh`) the replicas are
sharded over the ranks of a ``torch.distributed`` group, one device a rank,
each rank running this same loop on its block (``parallel/sharding.py``):
one ladder's chains (chain sharding: each scan gathers its lanes' values
once, then every rank swaps and records the whole ladder), or whole ladders
(replicate sharding: the recorders and outputs are gathered at the round's
end). Either way every rank holds the one-process run's results bit for
bit.

A target whose density is evaluated on the host (``host_evaluated``: a
native library, stream workers, a numpy function) runs on ``Inputs.device``
like any other: its states and recorders stay there and only its density
crosses, one copy of the lanes each way per batched evaluation. torch runs
eagerly, so nothing has to order the host calls after the explorer's (the
JAX runtime's ``lp_guard``). ``Inputs.dtype=float64`` runs the states, the
densities and the schedule's grids in float64 inside
:func:`~.rng.default_float` (JAX's x64 mode): the default float draws and
constants are float64 there, the recorders keep their float32 Kahan stacks
and the explorers' adapted state stays float32, as in the JAX runtime.

Between rounds, numpy on the host estimates barriers and regrids the
schedule. Where the JAX package traces the round into one ``lax.scan`` and
vmaps the per-ladder work, the port runs a Python loop of scans over
tensors with the ladder axis written out. A single ladder is the case
``R = 1`` of the same code, keyed by the master key itself as in the
reference, so one scan body serves both (the reference's ``scan_body`` and
``scan_body_flat``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import rng
from .adaptation import (
    CommunicationBarriers,
    communication_barriers,
    optimal_schedule,
    rejections_from_acceptance,
)
from .checks import check_against_serial, check_device, preflight_checks, run_dtype
from .inputs import KNOWN_RECORDERS, Inputs
from .parallel.sharding import ReplicaMesh, put_global
from .paths import VariationalPath, lane_log_density
from .recorders import (
    Recorders,
    ReducedRecorders,
    init_recorders,
    kadd,
    reduce_recorders,
    update_logsum,
    update_round_trips,
)
from .schedule import equally_spaced_schedule
from .swaps import deo_partner_map, metropolis_accept_pr, swap_scan
from .tree import tree_map


@dataclass
class RoundReport:
    round_idx: int
    n_scans: int
    n_tempered_restarts: int
    n_round_trips: int
    global_barrier: float
    log_z_estimate: float
    min_swap_accept: float
    mean_swap_accept: float
    wall_time_s: float
    global_barrier_variational: float = float("nan")
    peak_memory_bytes: int = 0
    max_energy_ac1: float = float("nan")
    mean_explorer_accept: float = float("nan")


def _in_run_dtype(method):
    """Run ``method`` with torch's default dtype the run's (``Inputs.dtype``):
    the counterpart of JAX's x64 mode, under which the JAX runtime's default
    float draws and constants are float64 in a float64 run."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        dtype = self.dtype if hasattr(self, "dtype") else run_dtype(args[0])
        with rng.default_float(dtype):
            return method(self, *args, **kwargs)

    return wrapped


def _default_extractor(x, lp):
    """A sample's record: the state with its interpolated log density."""
    return torch.cat([x, lp[..., None]], dim=-1)


class PT:
    """Run state and round loop (reference ``src/pt/PT.jl``). With a single leg,
    chains 0..N-1 run beta from the reference (0) to the target (N-1); with
    two legs the variational leg comes first and the fixed leg follows
    reversed (module docstring)."""

    @_in_run_dtype
    def __init__(self, inputs: Inputs):
        self.inputs = inputs
        target = inputs.target
        if target is None:
            raise ValueError(
                "Inputs.target is required, e.g. pigeons(target=toy_mvn_target(10))"
            )
        # states, densities and the schedule's grids take the run's dtype;
        # recorders and explorer statistics stay float32 (as in the JAX runtime)
        self.dtype = run_dtype(inputs)
        self.device = check_device(inputs.device)
        self.mesh = inputs.mesh
        if self.mesh is not None:
            if not isinstance(self.mesh, ReplicaMesh):
                raise TypeError(f"Inputs.mesh must be a ReplicaMesh (replica_mesh()), got "
                                f"{type(self.mesh).__name__}")
            # one device a rank: this rank's card, or the CPU when asked for
            self.device = self.mesh.device_for(self.device)
            if self.mesh.backend == "nccl" and self.device.type != "cuda":
                raise ValueError("a mesh over an NCCL group runs on the card: pass device='cuda'")
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        # a model's data lives on the run's device, where the densities and
        # the slice kernel read it
        target = target.to(self.device) if hasattr(target, "to") else target
        self.target = target
        self.n_chains_fixed = inputs.n_chains
        self.n_chains_var = inputs.n_chains_variational
        self.variational = inputs.variational
        if self.n_chains_var > 0 and self.variational is None:
            from .variational import GaussianReference

            self.variational = GaussianReference()
        self.two_leg = self.n_chains_fixed > 0 and self.n_chains_var > 0
        if self.n_chains_var > 0 and self.n_chains_fixed == 0:
            # a single variational leg: one ladder whose reference is refitted
            # between rounds (reference tempering.jl:65-70)
            self.n_chains_fixed, self.n_chains_var = self.n_chains_var, 0
            self.single_leg_variational = True
        else:
            self.single_leg_variational = self.variational is not None and not self.two_leg
        self.n_chains = n = self.n_chains_fixed + self.n_chains_var
        self.n_replicates = R = inputs.n_replicates
        self.dim = target.dim
        # this rank's block: R_run whole ladders (replicate sharding) or
        # n_local chains of the one ladder (chain sharding), whose global
        # replica indices are gidx; without a mesh, everything
        mesh = self.mesh
        self._shard_replicates = mesh is not None and R > 1
        self._shard_chains = mesh is not None and R == 1
        if self._shard_replicates:
            mesh.validate(R, "n_replicates")
        elif self._shard_chains:
            mesh.validate(n)
        self._R_run = R // mesh.n_devices if self._shard_replicates else R
        self._n_local = n // mesh.n_devices if self._shard_chains else n
        lo = mesh.block(n)[0] if self._shard_chains else 0
        self._gidx = torch.arange(lo, lo + self._n_local, device=self.device)
        if mesh is not None and inputs.show_report and mesh.rank == 0:
            mode = "ladders" if self._shard_replicates else "chains"
            print(f"replica mesh: {mesh.n_devices} ranks over {mesh.backend} on "
                  f"{self.device.type}, {mode} sharded", flush=True)

        self.reference = inputs.reference or target.default_reference()
        self.path = target.create_path(self.reference)
        # what the runtime and the explorer evaluate: the path itself, or its
        # blend with the variational reference under the current ref_params
        self._density_path = self.path
        self._ref_params = None
        if self.variational is not None:
            self._density_path = VariationalPath(self.path, self.variational)
            self._ref_params = self.variational.init_params(self.dim, self.device)
        self.explorer = inputs.explorer or target.default_explorer()
        self.explorer.check_target(target)
        self.explorer.check_dtype(self.dtype)
        self.explorer.check_path(self._density_path)
        # the explorer's adapted state: a tree (tree.py) of tensors [n_chains, ...]
        # (a dict, a combinator's tuple of its components' states, or ())
        self.exp_state = self.explorer.init_state(n, self.dim, self.device)
        self.accept_fn = metropolis_accept_pr
        record_swap_stats = True
        if hasattr(target, "swap_accept_fn"):
            self.accept_fn = target.swap_accept_fn()
            record_swap_stats = False  # reference pair_swapper.jl:133-135
        if self.two_leg:
            self.schedule = equally_spaced_schedule(self.n_chains_fixed)
            self.schedule_var = equally_spaced_schedule(self.n_chains_var)
        else:
            self.schedule = equally_spaced_schedule(n)
            self.schedule_var = None
        self.barriers: Optional[CommunicationBarriers] = None
        self.barriers_var: Optional[CommunicationBarriers] = None

        # R independent ladders: ladder r's streams derive from
        # fold_in(master, r); a single ladder uses the master key itself.
        # Every key is derived by global ladder and replica index, so a
        # rank's block draws what the one-process run draws there.
        master = rng.master_key(inputs.seed, self.device)
        if R > 1:
            self._key = rng.keys_for(master, torch.arange(R, device=self.device))
            if self._shard_replicates:
                self._key = self._key[slice(*mesh.block(R))]
            init_keys = rng.replica_keys(rng.fold_in(self._key, rng.INIT), n)
        else:
            self._key = master[None]
            init_keys = rng.keys_for(rng.fold_in(master, rng.INIT), self._gidx)[None]
        self._states = target.initialization(init_keys).reshape(
            self._R_run * self._n_local, self.dim).to(self.dtype)
        idx = torch.arange(n, dtype=torch.int64, device=self.device)
        self._chain_of = idx.repeat(self._R_run, 1)
        self._replica_of = idx.repeat(self._R_run, 1)

        rec_set = set(inputs.record)
        unknown = rec_set - KNOWN_RECORDERS
        if unknown:
            raise ValueError(
                f"unknown recorder name(s) {sorted(unknown)}; known recorders: "
                f"{sorted(KNOWN_RECORDERS)}"
            )
        # the variational fit and an adapting explorer read the online moments,
        # whatever Inputs.record says
        self._record_online = ("online" in rec_set or self.variational is not None
                               or self.explorer.needs_online_moments())
        self._record_traces = "traces" in rec_set or "disk" in rec_set
        self._record_extended = bool(inputs.extended_traces)
        self._record_index_process = "index_process" in rec_set
        self._record_energy = "energy_ac1" in rec_set
        self._record_round_trip = "round_trip" in rec_set
        self._record_swap_stats = record_swap_stats and "log_sum_ratio" in rec_set
        self._use_iid_reference = getattr(self.path, "has_iid_reference", False) and n > 1

        # the ladder: which chains are variational, references and targets
        is_var = np.zeros(n, np.float32)
        if self.two_leg:
            is_var[: self.n_chains_var] = 1.0
            self.ref_positions = (0, n - 1)
            # the targets sit at the junction of the legs (StabilizedPT.jl)
            self.target_positions = (self.n_chains_var - 1, self.n_chains_var)
        else:
            if self.single_leg_variational:
                is_var[:] = 1.0
            self.ref_positions = (0,)
            self.target_positions = (n - 1,)
        self._is_var_host = is_var
        self._is_var = torch.tensor(is_var, device=self.device)

        self._extract = inputs.extractor or _default_extractor
        # on the run's device, so that an extractor may close over tensors there
        probe = self._extract(torch.zeros(1, self.dim, dtype=self.dtype, device=self.device),
                              torch.zeros(1, dtype=self.dtype, device=self.device))
        self._extract_dim = int(probe.shape[-1])
        self._swap_graph = inputs.swap_graph

        self.round_idx = 0
        self.reduced: Optional[ReducedRecorders] = None
        self.reports: list[RoundReport] = []
        self.traces = None  # last round's target-chain samples [iterations, extract_dim]
        self.extended_traces = None  # last round's [n_scans, (R,)? N, extract_dim]
        self.index_process = None  # last round's chain of each replica, [n_scans, (R,)? N]
        self.exec_folder: Optional[str] = None
        self.serial_check = None  # the checked round's child run (a submission.Result)
        if inputs.checkpoint:
            from .checkpoint import dumps, next_exec_folder

            # an Inputs that cannot be written fails now; the mesh is not written
            dumps(dataclasses.replace(inputs, mesh=None), "the run's Inputs")
            self.exec_folder = inputs.checkpoint_folder
            if self.exec_folder is None:
                # one folder for all ranks: rank 0's
                self.exec_folder = next_exec_folder() if self.rank == 0 else None
                if mesh is not None:
                    self.exec_folder = mesh.broadcast_object(self.exec_folder)

    # ------------------------------------------------------------------
    # run state in the JAX package's shapes: [(R,) N, d] and [(R,) N]

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 without one)."""
        return self.mesh.rank if self.mesh is not None else 0

    def _ladder_shape(self, t):
        return t[0] if self.n_replicates == 1 else t

    @property
    def states(self) -> torch.Tensor:
        """Every replica's state; under a mesh gathered from every rank's
        block, a collective that every rank must call."""
        states = self._states if self.mesh is None else self.mesh.gather(self._states)
        return self._ladder_shape(states.reshape(self.n_replicates, self.n_chains, self.dim))

    def _ladders(self, t):
        """``[R, ...]`` from this rank's ``[R_run, ...]``: gathered under
        replicate sharding (a collective), else ``t`` itself."""
        return self.mesh.gather(t) if self._shard_replicates else t

    @property
    def chain_of(self) -> torch.Tensor:
        return self._ladder_shape(self._ladders(self._chain_of))

    @property
    def replica_of(self) -> torch.Tensor:
        return self._ladder_shape(self._ladders(self._replica_of))

    def set_run_state(self, states, chain_of, replica_of) -> None:
        """Set the run state from the whole run's host arrays (``[(R,) N,
        d]``, ``[(R,) N]``, as :attr:`states` gives them); under a mesh each
        rank keeps its block."""
        R, n = self.n_replicates, self.n_chains
        states = np.asarray(states).reshape(R * n, self.dim)
        chain_of = np.asarray(chain_of).reshape(R, n)
        replica_of = np.asarray(replica_of).reshape(R, n)
        self._states = put_global(states, self.mesh, self.device)
        ladders = self.mesh if self._shard_replicates else None
        self._chain_of = put_global(chain_of, ladders, self.device).to(torch.int64)
        self._replica_of = put_global(replica_of, ladders, self.device).to(torch.int64)

    @property
    def betas(self) -> torch.Tensor:
        """Per-chain annealing parameters of the combined ladder."""
        grids = self.schedule.grids
        if self.two_leg:
            grids = np.concatenate([self.schedule_var.grids, grids[::-1]])
        return torch.as_tensor(grids, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------

    def _log_density(self, x, beta, isvar):
        """The reference's ``ld``: the run's log density with NaN read as -inf."""
        return lane_log_density(self._density_path, x, beta, isvar, self._ref_params)

    def _blend_iid_x(self, x_after, replica_of, k_iid, ref_active):
        """Regenerate each ladder's reference-chain states iid. The key of the
        replica at a reference chain is ``fold_in(k_iid, replica)``, the key
        the reference draws for every lane before keeping the reference
        lanes' draws; only those lanes are drawn here. The reference draws
        the fixed and the variational sample from that same key and keeps one
        by the lane's ``is_var`` and the ``active`` flag; both are known on
        the host (``ref_active`` is the flag for this round), so only the one
        that is kept is drawn. Under chain sharding the replica may lie on
        another rank: each rank draws it and keeps it only where it is its
        own lane (no read of the device decides)."""
        R, n = replica_of.shape
        x = x_after.clone()
        for pos in self.ref_positions:
            ridx = replica_of[:, pos]  # [R]
            keys = rng.fold_in(k_iid, ridx)
            if ref_active and self._is_var_host[pos] > 0:
                draws = self.variational.sample(keys, self._ref_params)
            else:
                draws = self.path.sample_reference(keys)
            draws = draws.to(x.dtype)
            if self._shard_chains:  # R = 1
                local = ridx - self._gidx[0]
                mine = (local >= 0) & (local < self._n_local)
                lane = local.clamp(0, self._n_local - 1)
                x[lane] = torch.where(mine[:, None], draws, x[lane])
            else:
                x[torch.arange(R, device=x.device) * n + ridx] = draws
        return x

    def _fused_post_densities(self, x_after, chain_flat, partner_map, betas):
        """Own-beta and partner-beta densities of the moved states in one
        pass; the partner's density is evaluated with the partner chain's
        ``is_var``."""
        partner_flat = partner_map[chain_flat]
        b = torch.stack([betas[chain_flat], betas[partner_flat]])
        iv = torch.stack([self._is_var[chain_flat], self._is_var[partner_flat]])
        lp = self._log_density(x_after, b, iv)
        return lp[0], lp[1]

    def _partner_map(self, scan_idx: int) -> torch.Tensor:
        if self._swap_graph is None:
            return deo_partner_map(self.n_chains, scan_idx, self.device)
        return torch.as_tensor(self._swap_graph(self.n_chains, scan_idx), dtype=torch.int64,
                               device=self.device)

    def _scan_body(self, scan_idx, states, chain_of, replica_of, lp_cur, rec, betas, masks,
                   ref_active):
        """One scan of all ``R`` ladders: explore the flat batch of lanes (each
        lane keyed by ``fold_in(scan key of its ladder, replica)``, the
        reference's ``_explore``), regenerate the reference chains, evaluate
        own- and partner-beta densities, then :meth:`_post_one` (under chain
        sharding :meth:`_post_gathered`). The explorer moves this rank's
        lanes only; a lane's key is that of its global replica index."""
        R, n = self._R_run, self._n_local
        chain_loc = self._local_chains(chain_of)
        k_explore = rng.scan_key(self._key, self.round_idx, scan_idx, rng.EXPLORE)
        lane_keys = rng.keys_for(k_explore, self._gidx).reshape(R * n, 2)
        chain_params = (
            tree_map(lambda v: v[chain_loc], self.exp_state) if self.exp_state else None
        )
        out = self.explorer.step_batched(lane_keys, states, betas[chain_loc], self._density_path,
                                         isvar=self._is_var[chain_loc],
                                         ref_params=self._ref_params, lp=lp_cur,
                                         chain_params=chain_params, scan_idx=scan_idx)
        x_after = out.x.to(states.dtype)
        if self._use_iid_reference:
            k_iid = rng.scan_key(self._key, self.round_idx, scan_idx, rng.IID)
            x_after = self._blend_iid_x(x_after, replica_of, k_iid, ref_active)
        partner_map = self._partner_map(scan_idx)
        lp_after, lp_partner = self._fused_post_densities(x_after, chain_loc, partner_map, betas)
        post = self._post_gathered if self._shard_chains else self._post_one
        return post(scan_idx, x_after, lp_after, lp_partner, lp_cur, out, chain_of, replica_of,
                    rec, partner_map, masks)

    def _local_chains(self, chain_of):
        """The chain of each of this rank's lanes, flat."""
        chain_flat = chain_of.reshape(-1)
        return chain_flat[self._gidx] if self._shard_chains else chain_flat

    def _post_gathered(self, scan_idx, x_after, lp_after, lp_partner, lp_cur, out, chain_of,
                       replica_of, rec, partner_map, masks):
        """Chain sharding's one collective a scan: each lane's state, its
        densities and its explorer statistics packed into one row of the
        run's dtype (which holds the float32 statistics exactly) and gathered in global replica order, then :meth:`_post_one` on the
        whole ladder on every rank, as the one process runs it on the same
        values (so for any extractor: the state is gathered, not its
        extract). Every rank keeps its own lanes' carried density."""
        cols = [x_after, lp_after, lp_partner, lp_cur, out.accept_sum, out.accept_n, out.n_steps]
        if out.extras_sum is not None:
            cols += [out.extras_sum, out.extras_n]
        cols = [c.reshape(c.shape[0], -1) for c in cols]
        gathered = self.mesh.gather(torch.cat([c.to(self.dtype) for c in cols], 1))
        parts = [p.to(c.dtype) for p, c in
                 zip(torch.split(gathered, [c.shape[1] for c in cols], 1), cols)]
        x, la, lpp, lc, a_sum, a_n, steps = (parts[0], *(p[:, 0] for p in parts[1:7]))
        whole = out._replace(x=x, lp=None, accept_sum=a_sum, accept_n=a_n, n_steps=steps)
        if out.extras_sum is not None:
            whole = whole._replace(extras_sum=parts[7], extras_n=parts[8])
        _, chain_of, replica_of, lp_next, rec, outputs = self._post_one(
            scan_idx, x, la, lpp, lc, whole, chain_of, replica_of, rec, partner_map, masks)
        return x_after, chain_of, replica_of, lp_next[self._gidx], rec, outputs

    def _post_one(self, scan_idx, x_after, lp_after, lp_partner, lp_cur, out, chain_of,
                  replica_of, rec, partner_map, masks):
        """Recorder updates and the DEO swap of all ladders. Returns the next
        run state, the density carried into the next scan, the recorders and
        the scan's outputs: the target-chain extract ``trace [R, T,
        extract_dim]``, and where recorded all chains' extracts in chain order
        ``extended_trace [R, N, extract_dim]`` and the pre-swap
        ``index_process [R, N]`` (the chain of each replica)."""
        R, n, d = chain_of.shape[0], self.n_chains, self.dim
        ref_mask, target_mask = masks

        # per-chain recorder rows: reorder each ladder's replica rows into
        # chain order (a permutation gather by chain -> replica)
        def by_chain(v):
            v = v.reshape((R, n) + v.shape[1:])
            idx = replica_of.reshape((R, n) + (1,) * (v.dim() - 2)).expand(v.shape)
            return torch.gather(v, 1, idx)

        if self._record_energy:
            lp_b, lp_a = lp_cur.reshape(R, n), lp_after.reshape(R, n)
            rows = torch.stack([torch.ones_like(lp_b), lp_b, lp_a, lp_b**2, lp_a**2, lp_b * lp_a], -1)
            rows = torch.gather(rows, 1, replica_of[..., None].expand(R, n, 6))
            rec = rec._replace(energy=kadd(rec.energy, rows))
        rec = rec._replace(
            exp_accept_sum=kadd(rec.exp_accept_sum, by_chain(out.accept_sum)),
            exp_accept_n=kadd(rec.exp_accept_n, by_chain(out.accept_n)),
            exp_steps=kadd(rec.exp_steps, by_chain(out.n_steps)),
        )
        if out.extras_sum is not None:
            rec = rec._replace(extra_sum=kadd(rec.extra_sum, by_chain(out.extras_sum)),
                               extra_n=kadd(rec.extra_n, by_chain(out.extras_n)))

        trace = None
        if self._record_online or self._record_traces:
            ridx = replica_of[:, list(self.target_positions)]  # [R, T]
            x_t = torch.gather(x_after.reshape(R, n, d), 1, ridx[..., None].expand(-1, -1, d))
            lp_t = torch.gather(lp_after.reshape(R, n), 1, ridx)
            trace = self._extract(x_t, lp_t)  # [R, T, extract_dim]
        if self._record_online:
            rec = rec._replace(
                online_n=kadd(rec.online_n, float(len(self.target_positions))),
                online_sum=kadd(rec.online_sum, trace.sum(1)),
                online_sumsq=kadd(rec.online_sumsq, (trace**2).sum(1)),
            )
        outputs = {"trace": trace} if self._record_traces else {}
        if self._record_extended:
            # reference extended_traces (Inputs.jl:95-101): every chain's
            # extract, the replica at each chain before the swap
            extract = self._extract(x_after.reshape(R, n, d), lp_after.reshape(R, n))
            outputs["extended_trace"] = by_chain(extract.reshape(R * n, -1))
        if self._record_index_process:
            outputs["index_process"] = chain_of

        # round trips use the PRE-swap chain (reference swap.jl:106-126)
        if self._record_round_trip:
            rec = update_round_trips(rec, ref_mask[chain_of] & (n > 1), target_mask[chain_of])

        log_ratio = (lp_partner - lp_after).reshape(R, n)
        k_swap = rng.scan_key(self._key, self.round_idx, scan_idx, rng.SWAP_UNIFORM)
        res = swap_scan(k_swap, scan_idx, chain_of, replica_of, log_ratio,
                        self.accept_fn, partner_map=partner_map)
        active = res.pair_active
        rec = rec._replace(
            accept_sum=kadd(rec.accept_sum, torch.where(active, res.accept_pr, 0.0)),
            accept_n=kadd(rec.accept_n, active.to(torch.float32)),
        )
        if self._record_swap_stats:
            lsr_fwd, lsr_fwd_n = update_logsum(rec.lsr_fwd, rec.lsr_fwd_n, res.ratio_fwd, active)
            lsr_bwd, lsr_bwd_n = update_logsum(rec.lsr_bwd, rec.lsr_bwd_n, res.ratio_bwd, active)
            rec = rec._replace(lsr_fwd=lsr_fwd, lsr_fwd_n=lsr_fwd_n,
                               lsr_bwd=lsr_bwd, lsr_bwd_n=lsr_bwd_n)

        # a swapped replica's new own-beta density is the partner-beta density
        # it just computed: the next scan's lp_before costs nothing
        swapped = (res.chain_of != chain_of).reshape(-1)
        lp_next = torch.where(swapped, lp_partner, lp_after)
        return x_after, res.chain_of, res.replica_of, lp_next, rec, outputs

    def _run_scans(self, n_scans: int):
        """One round of ``n_scans`` scans on the device. Returns the new run
        state, the recorders and each recorded output's per-scan values."""
        n = self.n_chains
        betas = self.betas
        ref_mask = torch.zeros(n, dtype=torch.bool, device=self.device)
        target_mask = torch.zeros(n, dtype=torch.bool, device=self.device)
        ref_mask[list(self.ref_positions)] = True
        target_mask[list(self.target_positions)] = True
        rec = init_recorders(n, self._extract_dim, len(self.explorer.extra_names), self._R_run,
                             self.device)
        states, chain_of, replica_of = self._states, self._chain_of, self._replica_of
        chain_loc = self._local_chains(chain_of)
        lp = self._log_density(states, betas[chain_loc], self._is_var[chain_loc])
        # the reference's flag, read once a round (fit() sets it on the host)
        ref_active = self._ref_params is not None and float(self._ref_params["active"]) > 0
        recorded = {}
        for scan_idx in range(1, n_scans + 1):
            states, chain_of, replica_of, lp, rec, outputs = self._scan_body(
                scan_idx, states, chain_of, replica_of, lp, rec, betas, (ref_mask, target_mask),
                ref_active
            )
            for k, v in outputs.items():
                recorded.setdefault(k, []).append(v)
        return states, chain_of, replica_of, rec, recorded

    def _profile(self):
        """``torch.profiler`` over the round from ``Inputs.profile_round`` on
        (the JAX package's per-round device trace), its Chrome trace written
        to ``<exec_folder>/profile/round=r/trace.json``; else no context."""
        if not (self.inputs.profile_round and self.round_idx >= self.inputs.profile_round
                and self.exec_folder is not None):
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        folder = os.path.join(self.exec_folder, "profile", f"round={self.round_idx}")
        os.makedirs(folder, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        name = "trace.json" if self.rank == 0 else f"trace_rank{self.rank}.json"
        trace = os.path.join(folder, name)
        return profile(activities=activities,
                       on_trace_ready=lambda prof: prof.export_chrome_trace(trace))

    @_in_run_dtype
    def run_round(self, n_scans: Optional[int] = None) -> ReducedRecorders:
        self.round_idx += 1
        if n_scans is None:
            n_scans = 2**self.round_idx
        with self._profile():
            t0 = time.perf_counter()
            states, chain_of, replica_of, rec, recorded = self._run_scans(n_scans)
            recorded = {k: torch.stack(v) for k, v in recorded.items()}  # [n_scans, R_run, ...]
            if self._shard_replicates:
                # the round's one collective, inside its wall time: every
                # ladder's recorders and outputs in ladder order, which is
                # rank order
                rec = Recorders(*(self.mesh.gather(t) for t in rec))
                recorded = {k: self.mesh.gather(v, 1) for k, v in recorded.items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
        self._states, self._chain_of, self._replica_of = states, chain_of, replica_of

        def per_scan(name):
            """On the host, in the JAX runtime's shape ``[n_scans, (R,)? ...]``."""
            if name not in recorded:
                return None
            v = recorded[name].cpu().numpy()
            return v[:, 0] if self.n_replicates == 1 else v

        # [n_scans, R, T, extract_dim] -> pooled [iterations, extract_dim]
        self.traces = (recorded["trace"].reshape(-1, self._extract_dim).cpu().numpy()
                       if "trace" in recorded else None)
        self.extended_traces = per_scan("extended_trace")
        self.index_process = per_scan("index_process")
        if "disk" in self.inputs.record and self.rank == 0:
            from .checkpoint import write_samples

            write_samples(self)
        reduced = reduce_recorders(rec, self.n_replicates)
        self.reduced = reduced
        self._adapt(reduced)
        self._report(reduced, n_scans, wall)
        if self.inputs.checkpoint:
            from .checkpoint import write_checkpoint

            write_checkpoint(self)
        return reduced

    def _adapt(self, reduced: ReducedRecorders) -> None:
        rej_all = rejections_from_acceptance(
            np.nan_to_num(reduced.accept_mean, nan=0.5), reduced.accept_n
        )
        trivial = communication_barriers([0.0], [0.0, 1.0])
        if self.two_leg:
            # each leg adapts over its own pairs; the target-target pair at
            # the junction belongs to neither (reference StabilizedPT.jl:52-62)
            n_var, n = self.n_chains_var, self.n_chains
            rej_var = rej_all[: n_var - 1]
            # the fixed leg's pairs in increasing-beta order: the slice reversed
            rej_fixed = rej_all[n_var : n - 1][::-1]
            if n_var > 1:
                self.barriers_var = communication_barriers(rej_var, self.schedule_var.grids)
                self.schedule_var = optimal_schedule(rej_var, self.schedule_var.grids)
            else:  # a 1-chain leg has no pairs to adapt
                self.barriers_var = trivial
            if self.n_chains_fixed > 1:
                self.barriers = communication_barriers(rej_fixed, self.schedule.grids)
                self.schedule = optimal_schedule(rej_fixed, self.schedule.grids)
            else:
                self.barriers = trivial
        elif self.n_chains > 1:
            self.barriers = communication_barriers(rej_all, self.schedule.grids)
            self.schedule = optimal_schedule(rej_all, self.schedule.grids)
        else:
            # single chain: no pairs, no barrier, schedule stays [1.0]
            self.barriers = trivial
        if self.variational is not None:
            self._ref_params = self.variational.fit(self._ref_params, reduced, self.round_idx)
        self.exp_state = self.explorer.adapt(self.exp_state, reduced, self.round_idx)

    def _stepping_stone_pair_mask(self) -> Optional[np.ndarray]:
        """Two-leg runs estimate log Z on the variational leg only (reference
        ``evidence/stepping_stone.jl:53-67``)."""
        if not self.two_leg:
            return None
        mask = np.zeros(self.n_chains - 1, bool)
        mask[: self.n_chains_var - 1] = True
        return mask

    def _report(self, reduced: ReducedRecorders, n_scans: int, wall: float) -> None:
        from .evidence import stepping_stone_from_reduced

        with np.errstate(invalid="ignore"):
            obs = reduced.accept_n > 0
            min_acc = float(np.min(reduced.accept_mean[obs])) if obs.any() else np.nan
            mean_acc = float(np.mean(reduced.accept_mean[obs])) if obs.any() else np.nan
            ac1 = reduced.energy_ac1[np.isfinite(reduced.energy_ac1)]
            max_ac1 = float(np.max(np.abs(ac1))) if ac1.size else np.nan
            eacc = reduced.exp_accept[np.isfinite(reduced.exp_accept)]
            mean_eacc = float(np.mean(eacc)) if eacc.size else np.nan
        peak = 0
        if self.device.type == "cuda":
            peak = int(torch.cuda.max_memory_allocated(self.device))
        report = RoundReport(
            round_idx=self.round_idx,
            n_scans=n_scans,
            n_tempered_restarts=reduced.n_tempered_restarts,
            n_round_trips=reduced.n_round_trips,
            global_barrier=self.barriers.global_barrier,
            log_z_estimate=stepping_stone_from_reduced(reduced, self._stepping_stone_pair_mask()),
            min_swap_accept=min_acc,
            mean_swap_accept=mean_acc,
            wall_time_s=wall,
            global_barrier_variational=(
                self.barriers_var.global_barrier if self.barriers_var else float("nan")
            ),
            peak_memory_bytes=peak,
            max_energy_ac1=max_ac1,
            mean_explorer_accept=mean_eacc,
        )
        self.reports.append(report)
        if self.inputs.show_report and self.rank == 0:
            var_col = f" {'Λ_var':>7}" if self.two_leg else ""
            if self.round_idx == 1:
                print(
                    f"{'round':>5} {'scans':>6} {'restarts':>8} {'trips':>6} "
                    f"{'Λ':>7}{var_col} {'logZ':>9} {'min(α)':>7} {'mean(α)':>7} "
                    f"{'max|ρ|':>7} {'mean(αe)':>8} {'time(s)':>8}"
                )
            var_val = f" {report.global_barrier_variational:>7.3f}" if self.two_leg else ""
            print(
                f"{report.round_idx:>5} {report.n_scans:>6} {report.n_tempered_restarts:>8} "
                f"{report.n_round_trips:>6} {report.global_barrier:>7.3f}{var_val} "
                f"{report.log_z_estimate:>9.3f} {report.min_swap_accept:>7.3f} "
                f"{report.mean_swap_accept:>7.3f} {report.max_energy_ac1:>7.3f} "
                f"{report.mean_explorer_accept:>8.3f} {report.wall_time_s:>8.3f}"
            )

    def run(self) -> "PT":
        preflight_checks(self.inputs)
        while self.round_idx < self.inputs.n_rounds:
            self.run_round()
            if self.round_idx == self.inputs.checked_round:
                self.serial_check = check_against_serial(self)
        return self

    # ------------------------------------------------------------------
    # results API (reference src/pt/process_sample.jl, OnlineStateRecorder.jl)

    def sample_array(self) -> np.ndarray:
        """Last-round target-chain samples, [iterations, dim + 1]; the final
        column is the interpolated log density (with ``Inputs.extractor``,
        whatever it extracts)."""
        if self.traces is None:
            if self.round_idx > 0 and not self._record_traces:
                raise RuntimeError(
                    "the traces recorder is disabled by Inputs.record; add 'traces'"
                )
            raise RuntimeError("run() first")
        return self.traces

    def extended_sample_array(self) -> np.ndarray:
        """Every chain's extracts of the last round, ``[iterations, n_chains,
        extract_dim]``, chains in ladder order (requires
        ``extended_traces=True``; reference ``Inputs.jl:95``)."""
        if self.extended_traces is None:
            raise RuntimeError("run with extended_traces=True first")
        arr = self.extended_traces
        return arr.reshape(-1, arr.shape[-2], arr.shape[-1])

    def _require_online(self):
        if not self._record_online:
            raise RuntimeError(
                "the online-moments recorder is disabled by Inputs.record; "
                "add 'online' to compute mean()/var()"
            )

    def sample_names(self) -> list:
        """Column names of :meth:`sample_array`: the target's own when it
        declares them (``sample_names()``) and they match the array's width,
        else ``x[i]`` with the interpolated log density last."""
        target = self.inputs.target
        if self.inputs.extractor is None and hasattr(target, "sample_names"):
            names = list(target.sample_names())
            if len(names) == self._extract_dim:
                return names
        d = self._extract_dim - 1
        return [f"x[{i}]" for i in range(d)] + ["log_density"]

    def mean(self) -> np.ndarray:
        self._require_online()
        return self.reduced.online_mean[:-1]

    def var(self) -> np.ndarray:
        self._require_online()
        return self.reduced.online_var[:-1]

    @property
    def n_round_trips(self) -> int:
        return self.reduced.n_round_trips

    @property
    def n_tempered_restarts(self) -> int:
        return self.reduced.n_tempered_restarts

    @property
    def global_barrier(self) -> float:
        """Barrier to the fixed reference."""
        return self.barriers.global_barrier

    @property
    def global_barrier_variational(self) -> float:
        if self.barriers_var is None:
            raise ValueError("no variational leg in this run")
        return self.barriers_var.global_barrier


def pigeons(target=None, on=None, **kwargs):
    """Main entry point (reference ``src/submission/api.jl``): a target plus
    ``Inputs`` keywords, an ``Inputs``, or a checkpoint folder to resume
    (``pigeons("results/latest")``, optionally with ``device=`` and ``mesh=``).
    With ``on=ChildProcess(...)`` the run goes to a fresh process and a
    :class:`~.submission.Result` comes back; with ``on=MultiHostLauncher()``
    it is sharded over the ranks of a process group (every rank calls this),
    with ``on=ClusterSubmission(...)`` a scheduler's script is written and
    submitted, with ``on=ThisProcess()`` it runs here."""
    if isinstance(target, str):
        from .checkpoint import load_pt

        return load_pt(target, device=kwargs.pop("device", None),
                       mesh=kwargs.pop("mesh", None)).run()
    inputs = target if isinstance(target, Inputs) else Inputs(target=target, **kwargs)
    if on is None:
        return PT(inputs).run()
    return on.submit(inputs)
