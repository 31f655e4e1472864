"""Checkpoint / resume: every round's full run state on disk.

Counterpart of ``pigeons_tpu/checkpoint.py`` (reference
``src/pt/checkpoint.jl``). With ``Inputs.checkpoint`` each round writes
``<exec_folder>/round=r/checkpoint/``: ``checkpoint.npz`` with the run state
as host arrays (states, permutations, schedules, the explorer's adapted
state, the variational reference's parameters, the recorded traces) and
``meta.pkl`` with the ``Inputs`` and the host-side state (round index,
reports, reduced recorders, barriers); a ``.finished`` marker is written
last. :func:`load_pt` rebuilds the run, on the device it is given (by
default the ``Inputs.device`` that was written): the device is a load-time
parameter, not part of the checkpoint. Keys derive from (seed, round, scan)
and each round recomputes its densities from the states, so a resumed run is
the uninterrupted run bit for bit.

Serialization uses cloudpickle where it is installed (closures then pickle
by value) and plain ``pickle`` otherwise. Every ``torch.Tensor`` is written
as a host numpy array, never with torch's own reducer, which records the
device: a checkpoint written on the card loads on a host without one, as
CPU tensors. Arrays and tensors above 16 KiB go once per run into
``<exec_folder>/immutables/<hash>.npy`` and the pickles refer to them by
content hash (reference ``src/utils/Immutable.jl``), so a model's data is
not copied into every round.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os
import pickle
import time
import uuid
from typing import Optional

import numpy as np
import torch

THRESHOLD_BYTES = 1 << 14


def _base_pickler():
    try:
        from cloudpickle import CloudPickler

        return CloudPickler
    except ImportError:
        return pickle.Pickler


def _digest(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def dumps(obj, what: str = "the object") -> tuple[bytes, dict]:
    """Pickle ``obj`` in memory. Returns the bytes and the large arrays they
    refer to, ``{digest: array}``, which :func:`write_pickle` writes to the
    immutables store. Raises ``pickle.PicklingError`` naming ``what`` and
    the object that cannot be pickled."""
    immutables: dict = {}

    class Pickler(_base_pickler()):
        def persistent_id(self, o):
            is_tensor = isinstance(o, torch.Tensor)
            if is_tensor:
                o = o.detach().cpu().numpy()
            elif not isinstance(o, np.ndarray) or o.dtype == object:
                return None
            if o.nbytes > THRESHOLD_BYTES:
                digest = _digest(o)
                immutables.setdefault(digest, o)
                return ("pigeons_immutable", digest, is_tensor)
            if is_tensor:
                return ("pigeons_tensor", o, True)
            return None

    buf = io.BytesIO()
    try:
        Pickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise pickle.PicklingError(
            f"cannot checkpoint {what}: {e}. Without cloudpickle a lambda or "
            "a function defined inside another does not pickle: give Inputs (its target, "
            "extractor, swap_graph, explorer) module-level functions or classes, or "
            "install cloudpickle"
        ) from e
    return buf.getvalue(), immutables


def write_pickle(data: bytes, immutables: dict, path: str, immutables_dir: str) -> None:
    """Write what :func:`dumps` returned: the large arrays to
    ``immutables_dir`` (each once), then the pickle to ``path``, each file
    whole or not at all."""
    for digest, arr in immutables.items():
        target = os.path.join(immutables_dir, digest + ".npy")
        if not os.path.exists(target):
            os.makedirs(immutables_dir, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.tmp.npy"
            np.save(tmp, arr)
            os.replace(tmp, target)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def dump_object(obj, path: str, immutables_dir: str, what: str = "the object") -> None:
    """Pickle ``obj`` to ``path``; nothing is written unless all of it pickles."""
    write_pickle(*dumps(obj, what), path, immutables_dir)


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, immutables_dir: str):
        super().__init__(file)
        self.immutables_dir = immutables_dir
        self._cache: dict = {}

    def persistent_load(self, pid):
        tag = pid[0]
        if tag == "pigeons_tensor":
            return torch.from_numpy(pid[1])
        if tag != "pigeons_immutable":
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        _, digest, is_tensor = pid
        if digest not in self._cache:
            self._cache[digest] = np.load(os.path.join(self.immutables_dir, digest + ".npy"))
        arr = self._cache[digest]
        return torch.from_numpy(arr) if is_tensor else arr


def load_object(path: str, immutables_dir: str):
    with open(path, "rb") as f:
        return _Unpickler(f, immutables_dir).load()


def immutables_dir(exec_folder: str) -> str:
    return os.path.join(exec_folder, "immutables")


def next_exec_folder(base: str = "results") -> str:
    """A new timestamped run folder under ``base/all`` and the symlink
    ``base/latest`` to it (reference ``utils/exec_folder.jl:8-23``)."""
    stamp = time.strftime("%Y-%m-%d-%H-%M-%S") + "-" + uuid.uuid4().hex[:8]
    folder = os.path.join(base, "all", stamp)
    os.makedirs(folder, exist_ok=True)
    latest = os.path.join(base, "latest")
    try:
        if os.path.islink(latest) or os.path.exists(latest):
            os.remove(latest)
        os.symlink(os.path.relpath(folder, base), latest)
    except OSError:
        pass  # a file system without symlinks keeps the folder all the same
    return folder


def round_folder(exec_folder: str, round_idx: int) -> str:
    return os.path.join(exec_folder, f"round={round_idx}", "checkpoint")


def latest_checkpoint_round(exec_folder: str) -> Optional[int]:
    """The last round with a complete checkpoint (its ``.finished`` marker;
    the reference scans its ``.signal`` markers, ``checkpoint.jl:57-91``)."""
    if not os.path.isdir(exec_folder):
        return None
    rounds = [int(name.split("=")[1]) for name in os.listdir(exec_folder)
              if name.startswith("round=")]
    done = [r for r in rounds
            if os.path.exists(os.path.join(round_folder(exec_folder, r), ".finished"))]
    return max(done) if done else None


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def write_checkpoint(pt) -> str:
    """Write the run state of ``pt``'s current round. Returns the folder."""
    folder = round_folder(pt.exec_folder, pt.round_idx)
    arrays = {
        "states": _host(pt.states),
        "chain_of": _host(pt.chain_of),
        "replica_of": _host(pt.replica_of),
        "schedule": np.asarray(pt.schedule.grids),
    }
    if pt.schedule_var is not None:
        arrays["schedule_var"] = np.asarray(pt.schedule_var.grids)
    for name in ("traces", "extended_traces", "index_process"):
        if getattr(pt, name) is not None:
            arrays[name] = getattr(pt, name)
    for k, v in (pt.exp_state or {}).items():
        arrays[f"exp_state_{k}"] = _host(v)
    for k, v in (pt._ref_params or {}).items():
        arrays[f"ref_params_{k}"] = _host(v)
    meta = {
        "inputs": pt.inputs,
        "round_idx": pt.round_idx,
        "reports": pt.reports,
        "reduced": pt.reduced,
        "barriers": pt.barriers,
        "barriers_var": pt.barriers_var,
    }
    # pickle first: an Inputs that does not pickle leaves no folder behind
    data, immutables = dumps(meta, "the run's Inputs")
    os.makedirs(folder, exist_ok=True)
    marker = os.path.join(folder, ".finished")
    if os.path.exists(marker):  # a resumed run rewrites a later round
        os.remove(marker)
    np.savez(os.path.join(folder, "checkpoint.npz"), **arrays)
    write_pickle(data, immutables, os.path.join(folder, "meta.pkl"),
                 immutables_dir(pt.exec_folder))
    with open(marker, "w") as f:
        f.write("ok")
    return folder


def load_pt(exec_folder: str, device: Optional[str] = None, round_idx: Optional[int] = None):
    """Rebuild a run from its checkpoint at ``round_idx`` (default: the last
    complete one) on ``device`` (default: the ``Inputs.device`` it was
    written with). Its further checkpoints go to the same folder."""
    from .pt import PT
    from .schedule import Schedule

    if round_idx is None:
        round_idx = latest_checkpoint_round(exec_folder)
    if round_idx is None:
        raise FileNotFoundError(f"no complete checkpoint under {exec_folder}")
    folder = round_folder(exec_folder, round_idx)
    meta = load_object(os.path.join(folder, "meta.pkl"), immutables_dir(exec_folder))
    arrays = np.load(os.path.join(folder, "checkpoint.npz"))

    inputs = dataclasses.replace(meta["inputs"], checkpoint_folder=exec_folder)
    if device is not None:
        inputs.device = device
    pt = PT(inputs)
    dev = pt.device
    pt.round_idx = meta["round_idx"]
    pt.reports = meta["reports"]
    pt.reduced = meta["reduced"]
    pt.barriers = meta["barriers"]
    pt.barriers_var = meta["barriers_var"]
    R, n = pt.n_replicates, pt.n_chains
    pt._states = torch.from_numpy(arrays["states"]).reshape(R * n, pt.dim).to(dev)
    pt._chain_of = torch.from_numpy(arrays["chain_of"]).reshape(R, n).to(dev)
    pt._replica_of = torch.from_numpy(arrays["replica_of"]).reshape(R, n).to(dev)
    pt.schedule = Schedule(arrays["schedule"])
    if "schedule_var" in arrays:
        pt.schedule_var = Schedule(arrays["schedule_var"])
    for name in ("traces", "extended_traces", "index_process"):
        if name in arrays:
            setattr(pt, name, arrays[name])
    if pt.exp_state:
        pt.exp_state = {k: torch.from_numpy(arrays[f"exp_state_{k}"]).to(dev)
                        for k in pt.exp_state}
    if pt._ref_params is not None:
        pt._ref_params = {k: torch.from_numpy(arrays[f"ref_params_{k}"]).to(dev)
                          for k in pt._ref_params}
    return pt


def write_samples(pt) -> str:
    """The disk recorder: the round's target-chain samples (and, when
    recorded, the extended traces and the index process) under
    ``round=r/samples/samples.npz`` (reference ``recorders/DiskRecorder.jl``)."""
    folder = os.path.join(pt.exec_folder, f"round={pt.round_idx}", "samples")
    os.makedirs(folder, exist_ok=True)
    arrays = {"trace": pt.traces}
    for name in ("extended_traces", "index_process"):
        if getattr(pt, name) is not None:
            arrays[name] = getattr(pt, name)
    np.savez_compressed(os.path.join(folder, "samples.npz"), **arrays)
    return folder


def process_sample(exec_folder: str, round_idx: Optional[int] = None):
    """Stream the disk recorder's samples: yields ``(round_idx, i, extract)``
    for the target-chain samples of ``round_idx`` (default: every round), in
    the order of ``sample_array()`` (reference ``pt/process_sample.jl``)."""
    if round_idx is not None:
        rounds = [round_idx]
    else:
        rounds = sorted(int(name.split("=")[1]) for name in os.listdir(exec_folder)
                        if name.startswith("round="))
    for r in rounds:
        path = os.path.join(exec_folder, f"round={r}", "samples", "samples.npz")
        if not os.path.exists(path):
            continue
        trace = np.load(path)["trace"]
        for i, row in enumerate(trace.reshape(-1, trace.shape[-1])):
            yield r, i, row


def increment_n_rounds(exec_folder: str, extra_rounds: int) -> str:
    """Extend a run by ``extra_rounds`` past its last checkpoint (reference
    ``checkpoint.jl:166-189``): the checkpoint's ``Inputs.n_rounds`` is
    rewritten on disk, so that ``pigeons(exec_folder)`` runs them too.
    Returns ``exec_folder``; ``pigeons`` or :func:`load_pt` loads the run."""
    round_idx = latest_checkpoint_round(exec_folder)
    if round_idx is None:
        raise FileNotFoundError(f"no complete checkpoint under {exec_folder}")
    path = os.path.join(round_folder(exec_folder, round_idx), "meta.pkl")
    imm = immutables_dir(exec_folder)
    meta = load_object(path, imm)
    meta["inputs"].n_rounds = meta["round_idx"] + extra_rounds
    dump_object(meta, path, imm, "the run's Inputs")
    return exec_folder
