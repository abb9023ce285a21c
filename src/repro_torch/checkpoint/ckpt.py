"""Checkpoints: theta's modules as ``.npz`` under stable ``state_dict``
names, with a ``.json`` manifest.

Durability: :func:`save_checkpoint` is crash-atomic.  Both files are written
to temporary files in the target directory and moved into place with
``os.replace``, the arrays first and the manifest last, and the two halves
share a random token — so a reader either sees one complete save or detects
the tear (:class:`CorruptCheckpointError`) instead of half-loading it.

The module also snapshots and restores the run's three random streams
(:func:`protocol_state_metadata` / :func:`restore_protocol_state`) so that
``run_pigeon(resume=True)`` stays on-stream: the numpy bit generator
(clustering, batch sampling), the CPU generator of the per-turn noise seeds,
and the device generator of the host selector's handoff noise.  The last
one's state depends on its device type (a CUDA generator's state is not a
CPU one's), so the manifest records the device type and a resume on the
other type raises.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Modules = Union[nn.Module, Sequence[nn.Module]]


class CorruptCheckpointError(RuntimeError):
    """The manifest and array halves do not form one save (a torn write,
    truncation or bit rot)."""


def _modules(tree: Modules) -> Sequence[nn.Module]:
    return (tree,) if isinstance(tree, nn.Module) else tuple(tree)


def _named_tensors(tree: Modules):
    """``("<i>/<state_dict name>", tensor)`` for every entry of each
    module's ``state_dict``, ``i`` the module's position (theta = (gamma,
    phi): 0 and 1)."""
    for i, module in enumerate(_modules(tree)):
        for name, value in module.state_dict().items():
            yield f"{i}/{name}", value


def _atomic_write(path: str, write_fn) -> None:
    """Write through a temporary file in the same directory and
    ``os.replace``, so the final name only ever holds complete content."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_checkpoint(path: str, tree: Modules, metadata: Optional[Dict] = None) -> None:
    """``path.npz`` (the tensors, fetched to the host here) and
    ``path.json`` (names, token, ``metadata``)."""
    named = list(_named_tensors(tree))
    arrays = {f"a{i}": v.detach().cpu().numpy() for i, (_, v) in enumerate(named)}
    names = [n for n, _ in named]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    token = os.urandom(8).hex()      # ties the two files to one save
    arrays["__token__"] = np.array(token)
    _atomic_write(path + ".npz", lambda f: np.savez(f, **arrays))
    meta = {"names": names, "token": token, "metadata": metadata or {}}
    _atomic_write(path + ".json", lambda f: f.write(json.dumps(meta).encode()))


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """({name: array}, metadata).  Raises ``FileNotFoundError`` if a half is
    missing and :class:`CorruptCheckpointError` if the halves are unreadable
    or come from different saves."""
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
    except json.JSONDecodeError as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint manifest {path}.json: {e}") from e
    try:
        with np.load(path + ".npz", allow_pickle=False) as z:
            token = str(z["__token__"]) if "__token__" in z.files else None
            arrays = {meta["names"][int(k[1:])]: z[k]
                      for k in z.files if k != "__token__"}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, ValueError, KeyError, IndexError) as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint arrays {path}.npz: {e}") from e
    if token != meta.get("token"):
        raise CorruptCheckpointError(
            f"torn checkpoint at {path}: manifest token {meta.get('token')!r} != "
            f"arrays token {token!r} (the two halves come from different saves)")
    return arrays, meta.get("metadata", {})


@torch.no_grad()
def restore_pytree(path: str, like: Modules) -> Modules:
    """Load a checkpoint into the modules of ``like`` in place (each
    tensor on its module's device, in its dtype) and return ``like``.
    Raises ``KeyError`` for a missing entry and ``ValueError`` for a shape
    that differs."""
    arrays, _ = load_checkpoint(path)
    for name, value in _named_tensors(like):
        if name not in arrays:
            raise KeyError(f"checkpoint missing entry {name}")
        a = arrays[name]
        if tuple(a.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {name}: {a.shape} vs "
                             f"{tuple(value.shape)}")
        value.copy_(torch.from_numpy(a).to(value.dtype))
    return like


# ---------------------------------------------------------------------------
# random-stream snapshots (the on-stream resume contract)
# ---------------------------------------------------------------------------

def protocol_state_metadata(rng: np.random.Generator, seed_gen: torch.Generator,
                            param_gen: torch.Generator) -> Dict[str, Any]:
    """A JSON-serialisable snapshot of the run's three random streams: the
    numpy bit generator, the per-turn seed generator (CPU) and the handoff
    noise generator (on the run's device; ``param_gen_device`` records its
    type)."""
    return {"rng_state": rng.bit_generator.state,
            "seed_gen": seed_gen.get_state().tolist(),
            "param_gen": param_gen.get_state().tolist(),
            "param_gen_device": param_gen.device.type}


def restore_protocol_state(rng: np.random.Generator, seed_gen: torch.Generator,
                           param_gen: torch.Generator,
                           metadata: Dict[str, Any]) -> None:
    """The inverse of :func:`protocol_state_metadata`, in place.  Raises
    ``ValueError`` when the checkpoint's device generator is of another
    device type than ``param_gen``."""
    saved = metadata.get("param_gen_device")
    if saved != param_gen.device.type:
        raise ValueError(
            f"checkpoint's device generator state is for {saved!r}, this run's is on "
            f"{param_gen.device.type!r}: a CUDA generator's state is not a CPU one's, so "
            f"resume on the device type the checkpoint was written on")
    rng.bit_generator.state = metadata["rng_state"]
    seed_gen.set_state(torch.tensor(metadata["seed_gen"], dtype=torch.uint8))
    param_gen.set_state(torch.tensor(metadata["param_gen"], dtype=torch.uint8))


def job_checkpoint_metadata(t: int, stream_snap: Dict[str, Any],
                            job: Optional[str] = None) -> Dict[str, Any]:
    """Checkpoint metadata for one protocol run's round ``t``: the round
    index and the :func:`protocol_state_metadata` snapshot a solo run
    stores, plus (for a job of the pool) the job's name — the layout is a
    solo run's, so a job checkpointed in the pool resumes under
    ``run_pigeon`` and the other way round."""
    meta = {"round": t, **stream_snap}
    if job is not None:
        meta["job"] = job
    return meta


__all__ = ["CorruptCheckpointError", "job_checkpoint_metadata", "load_checkpoint",
           "protocol_state_metadata", "restore_protocol_state", "restore_pytree",
           "save_checkpoint"]
