"""Sharded checkpointing: per-rank npz shards + a JSON manifest.

The port of ``repro.checkpoint.checkpointing``, with the same files, key
lists and shapes on disk, so that a checkpoint written by either package
loads in the other.  Tensor leaves are written through
``.detach().cpu()``; the training state's shards are fp32, so no leaf
needs a bf16 numpy type.  :func:`load` returns numpy arrays, as the
reference does: ``repro_torch.convert.params_from_numpy`` puts a loaded
tree on a device.

Layout on disk::

    <dir>/manifest.json              step, n_ranks, per-file flat key
                                     lists + array shapes, meta (plan)
    <dir>/rank_<i>.<token>.npz       that rank's state shard (ZeRO-3 slice)
    <dir>/replicated.<token>.npz     replicated small state (norms, step)

Saves are **atomic at the checkpoint level**: every npz of a save carries
a fresh ``<token>`` in its name and is written to a temp path first
(``os.replace`` into place), and ``manifest.json`` — the only fixed-name
file — is replaced *last*.  A crash anywhere mid-save therefore leaves
the previous manifest pointing at the previous, complete file set; the
half-written new files are garbage-collected by the next successful
save.  ``load`` validates each shard's flat key list and array shapes
against the manifest and raises :class:`ValueError` on any mismatch, so
a corrupt or truncated checkpoint can never be silently opened.

Works for the MPMD loopback runtime's per-rank state shards, and for
the process fleet's state through its exported trees (the launcher
saves those); the SPMD path is not ported yet.  Ratio changes between
save and restore go through :func:`reshard` (gather → re-slice) — the
*offline* analogue of the paper's elastic re-planning when cluster
composition changes.  The engine surface ``export_state``/``import_state``
carries state across plans: to restart under a new plan, save the
exported ``{"step","p","m","v"}`` trees with :func:`save` and feed them to
any engine's ``import_state``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

MANIFEST = "manifest.json"


def _flatten_dict(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_dict(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_dict(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten_dict(flat: Dict[str, np.ndarray], template: Any,
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_dict(flat, template[k], f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_dict(flat, v, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return type(template)(seq)
    return flat[prefix.rstrip("/")]


def _write_npz(directory: str, final_name: str, flat: Dict[str, np.ndarray]
               ) -> Dict[str, Any]:
    """Write one npz via temp-file + ``os.replace``; return its manifest
    entry (file name, flat key list, per-key shapes, total bytes)."""
    tmp = os.path.join(directory, f".tmp.{final_name}")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, final_name))
    return {
        "file": final_name,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "nbytes": int(sum(v.nbytes for v in flat.values())),
    }


def _read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save(directory: str, step: int, rank_shards: Sequence[Any],
         replicated: Any, meta: Optional[dict] = None) -> None:
    """Atomically write a checkpoint.

    A crash at any point leaves the previous checkpoint loadable: new
    npz files use fresh tokenized names, and the fixed-name manifest is
    ``os.replace``d only after every data file is durably in place.
    """
    os.makedirs(directory, exist_ok=True)
    token = f"{step}.{os.getpid()}.{time.time_ns():x}"

    shard_entries: List[Dict[str, Any]] = []
    for i, shard in enumerate(rank_shards):
        flat = _flatten_dict(shard)
        entry = _write_npz(directory, f"rank_{i}.{token}.npz", flat)
        entry["rank"] = i
        entry["size"] = int(sum(
            int(np.prod(s)) for s in entry["shapes"].values()))
        shard_entries.append(entry)
    replicated_entry = _write_npz(
        directory, f"replicated.{token}.npz", _flatten_dict(replicated))

    manifest = {
        "step": step,
        "n_ranks": len(rank_shards),
        "shards": shard_entries,
        "replicated": replicated_entry,
        "meta": meta or {},
    }
    tmp = os.path.join(directory, f".tmp.{MANIFEST}")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, MANIFEST))

    # the new manifest is durable — the previous file set (and any
    # stragglers from crashed saves) is garbage now
    _gc(directory, keep=manifest)


def _gc(directory: str, keep: dict) -> None:
    """Remove superseded files — but only ones matching THIS module's
    naming scheme; foreign files in the directory are never touched."""
    live = {e["file"] for e in keep["shards"]} | {keep["replicated"]["file"]}
    for name in os.listdir(directory):
        ours = name.startswith(("rank_", "replicated.")) and \
            name.endswith(".npz")
        stale_tmp = name.startswith(".tmp.")
        if stale_tmp or (ours and name not in live):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def _load_npz(directory: str, entry: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Load one npz and validate it against its manifest entry."""
    path = os.path.join(directory, entry["file"])
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    want = list(entry.get("keys", []))
    if want and sorted(flat) != sorted(want):
        raise ValueError(
            f"checkpoint shard {entry['file']} is corrupt: flat keys "
            f"{sorted(flat)} != manifest keys {sorted(want)}")
    for k, shape in entry.get("shapes", {}).items():
        if list(flat[k].shape) != list(shape):
            raise ValueError(
                f"checkpoint shard {entry['file']} key {k!r} has shape "
                f"{list(flat[k].shape)}, manifest says {list(shape)}")
    return flat


def load(directory: str, rank_template: Any, replicated_template: Any):
    """Load a checkpoint, validating shard key lists and shapes against
    the manifest (:class:`ValueError` on mismatch)."""
    manifest = _read_manifest(directory)
    if manifest is None:
        raise ValueError(f"no {MANIFEST} in {directory!r}")
    if "shards" in manifest:
        entries = manifest["shards"]
    else:   # legacy (pre-atomic) layout: fixed rank_<i>.npz names
        entries = [{"file": f"rank_{i}.npz"}
                   for i in range(manifest["n_ranks"])]
    if len(entries) != manifest["n_ranks"]:
        raise ValueError(
            f"manifest lists {len(entries)} shard files for "
            f"{manifest['n_ranks']} ranks")
    shards: List[Any] = []
    for entry in entries:
        shards.append(_unflatten_dict(_load_npz(directory, entry),
                                      rank_template))
    rep_entry = manifest.get("replicated", {"file": "replicated.npz"})
    replicated = _unflatten_dict(_load_npz(directory, rep_entry),
                                 replicated_template)
    return manifest["step"], shards, replicated, manifest["meta"]


def reshard(flat_shards: Sequence[np.ndarray],
            old_sizes: Sequence[int],
            new_sizes: Sequence[int]) -> List[np.ndarray]:
    """Re-slice a flat ZeRO-3 buffer under new shard sizes (elastic
    re-planning: cluster composition changed → planner emitted new
    ratios)."""
    full = np.concatenate([s[:n] for s, n in zip(flat_shards, old_sizes)])
    if full.size != sum(new_sizes):
        raise ValueError(
            f"reshard size mismatch: old shards hold {full.size} elements "
            f"({list(old_sizes)}), new sizes sum to {sum(new_sizes)} "
            f"({list(new_sizes)})")
    out, off = [], 0
    pmax = max(new_sizes)
    for n in new_sizes:
        buf = np.zeros(pmax, full.dtype)
        buf[:n] = full[off: off + n]
        out.append(buf)
        off += n
    return out
