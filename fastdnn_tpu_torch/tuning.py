"""Measured launch-knob registry: autotune results become engine defaults.

The counterpart of fastdnn_tpu/tuning.py, with the same functions, files
and lookup policy.  The knobs differ: the JAX package records its Pallas
grid block sizes (`BLOCK_KEYS`), which the port's EngineConfig does not
have; here the registry records `TUNED_KEYS`, the EngineConfig fields that
choose a launch schedule and leave the posteriors bitwise the same.  Today
that is `stack_hidden_max_frames`: K3 (the whole trunk in one launch) and
one K2 launch per layer give bitwise the same activations.

    python -m fastdnn_tpu_torch.cli.autotune --commit   # sweep on the card
    Scorer(...)                                         # consults the registry

Registry files: `fastdnn_tpu_torch/tuned.json` (package data) merged with
the per-user state file `$XDG_STATE_HOME/fastdnn_tpu_torch/tuned.json`
(default `~/.local/state/...`; user entries win; `--commit` writes there
when the package directory is read-only).  FASTDNN_TUNED=<path> overrides
both, FASTDNN_TUNED=0 (or empty) disables the registry.  One entry per
(net topology, device kind, batch):

    {"net": "432-7x2048-8000", "device_kind": "NVIDIA H100 80GB HBM3",
     "batch": 8192, "best_ms": 1.2, "knobs": {"stack_hidden_max_frames": 0}}

Lookup policy (Scorer.__init__, CUDA backend, one rank): a knob the caller
set explicitly (different from the EngineConfig class default) always
wins; the registry fills in only knobs left at their defaults.  Without a
matching (net, device kind) entry the defaults stand.  With several
batches recorded the largest batch wins, unless EngineConfig(tuned_batch=N)
asks for the nearest one.  EngineConfig(autotuned=False) ignores the
registry.  A corrupt file never blocks scoring: it reads as empty.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

#: EngineConfig fields the registry may override (the JAX package's
#: BLOCK_KEYS): launch schedules only, the posteriors bitwise the same
TUNED_KEYS = ("stack_hidden_max_frames",)


def _package_registry_path() -> str:
    return os.path.join(os.path.dirname(__file__), "tuned.json")


def _user_registry_path() -> str:
    """Per-user state file: where `autotune --commit` lands when the package
    directory is read-only (site-packages installs)."""
    base = os.environ.get("XDG_STATE_HOME") or os.path.join(
        os.path.expanduser("~"), ".local", "state"
    )
    return os.path.join(base, "fastdnn_tpu_torch", "tuned.json")


def registry_paths() -> list:
    """Registry files to READ, in precedence order (later entries win on key
    conflicts): package file first, user state file second.  FASTDNN_TUNED
    overrides both with a single explicit path; =0/'' disables."""
    env = os.environ.get("FASTDNN_TUNED")
    if env == "0" or env == "":
        return []
    if env:
        return [env]
    return [_package_registry_path(), _user_registry_path()]


def registry_path() -> Optional[str]:
    """The registry file to WRITE (merge_entry/save_registry target), or
    None when disabled: the package file when its directory is writable (a
    checkout, whose file is committed), the per-user state file otherwise."""
    env = os.environ.get("FASTDNN_TUNED")
    if env == "0" or env == "":
        return None
    if env:
        return env
    pkg = _package_registry_path()
    if _dir_writable(os.path.dirname(pkg)):
        return pkg
    return _user_registry_path()


def _dir_writable(d: str) -> bool:
    return os.access(d, os.W_OK)


def _key(entry: dict) -> tuple:
    return entry.get("net"), entry.get("device_kind"), entry.get("batch")


def _read_entries(path: str) -> list:
    if not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            data = json.load(f)
        return list(data.get("entries", []))
    except Exception:  # a corrupt registry must never block scoring
        return []


def load_registry(path: Optional[str] = None) -> list:
    """Entries visible to lookup; [] when absent, disabled or unreadable.

    With an explicit `path`, just that file.  Default: the package file
    merged with the user state file, user entries replacing package entries
    with the same (net, device_kind, batch) key.
    """
    if path is not None:
        return _read_entries(path)
    merged: dict = {}
    for p in registry_paths():
        for e in _read_entries(p):
            merged[_key(e)] = e
    return list(merged.values())


def save_registry(entries: list, path: Optional[str] = None) -> None:
    path = path or registry_path()
    if not path:
        raise ValueError("registry disabled (FASTDNN_TUNED=0)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"entries": entries}, f, indent=1, sort_keys=True)
        f.write("\n")


def merge_entry(entry: dict, path: Optional[str] = None) -> list:
    """Insert or replace the entry with the same (net, device_kind, batch)
    key.  Reads and rewrites only the write target (registry_path()), so a
    read-only package registry is never copied into the user state file;
    lookups merge the two at read time."""
    path = path or registry_path()
    if not path:
        raise ValueError("registry disabled (FASTDNN_TUNED=0)")
    entries = [e for e in _read_entries(path) if _key(e) != _key(entry)]
    entries.append(entry)
    entries.sort(key=lambda e: (e["net"], e["device_kind"], e["batch"]))
    save_registry(entries, path)
    return entries


def net_key(qnet) -> str:
    """Canonical topology string of a QuantizedNet, e.g. 432-7x2048-8000,
    the JAX package's for the same net: dims as loaded, before the padding
    the CUDA backend adds (Scorer consults the registry before pad_qnet).
    Unequal hidden widths give the full dash-joined dim list."""
    dims = [qnet.input_dim] + qnet.layer_dims()
    hidden, out = dims[1:-1], dims[-1]
    if hidden and all(h == hidden[0] for h in hidden):
        return f"{dims[0]}-{len(hidden)}x{hidden[0]}-{out}"
    return "-".join(str(d) for d in dims)


def device_kind(device) -> str:
    """The registry's device kind of a CUDA device, as
    torch.cuda.get_device_name gives it (e.g. "NVIDIA H100 80GB HBM3")."""
    return torch.cuda.get_device_name(torch.device(device))


def lookup(
    net: str,
    device_kind: str,
    batch: Optional[int] = None,
    registry: Optional[list] = None,
) -> Optional[dict]:
    """Tuned knobs for (net, device_kind), or None.  batch=None returns the
    largest-batch entry (the throughput regime), otherwise the entry with
    the nearest recorded batch."""
    entries = [
        e
        for e in (registry if registry is not None else load_registry())
        if e.get("net") == net and e.get("device_kind") == device_kind
    ]
    if not entries:
        return None
    if batch is None:
        best = max(entries, key=lambda e: e.get("batch", 0))
    else:
        best = min(entries, key=lambda e: abs(e.get("batch", 0) - batch))
    return dict(best.get("knobs", {}))


def apply_tuned(config, qnet, device_kind: str):
    """EngineConfig with registry knobs filled into fields left at their
    class defaults.  Explicitly set knobs always win; the config comes back
    unchanged when autotuning is off, no entry matches, or every knob was
    explicit."""
    if not getattr(config, "autotuned", True):
        return config
    knobs = lookup(net_key(qnet), device_kind, batch=getattr(config, "tuned_batch", None))
    if not knobs:
        return config
    defaults = {
        f.name: f.default for f in dataclasses.fields(type(config)) if f.name in TUNED_KEYS
    }
    updates = {
        k: v
        for k, v in knobs.items()
        if k in TUNED_KEYS and getattr(config, k) == defaults[k] and v != defaults[k]
    }
    if not updates:
        return config
    return dataclasses.replace(config, **updates)
