"""The port's launch-knob registry (fastdnn_tpu_torch/tuning.py) against the
JAX package's (fastdnn_tpu/tuning.py): tests/test_tuning.py's cases with
`stack_hidden_max_frames` as the knob, then parity with JAX (the same
net key, the same entry looked up from one file) and the Scorer's use of
the registry: consulted on the CUDA backend in a single-rank process only,
and a tuned config scores the same posteriors on either trunk route,
within 1e-4 of JAX's `Scorer` with argmax agreement 1.0.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu import tuning as jtuning
from fastdnn_tpu_torch import tuning
from fastdnn_tpu_torch.config import EngineConfig
from fastdnn_tpu_torch.engine import scorer as tscorer
from fastdnn_tpu_torch.engine.backend import KERNELS, PLAIN

KNOB = "stack_hidden_max_frames"
DEFAULT = EngineConfig().stack_hidden_max_frames
POSTERIOR_ATOL = 1e-4


def _net(hidden=(64, 64), seed=0):
    return fdt.random_net(np.random.default_rng(seed), 32, list(hidden), 48)


@pytest.fixture
def qnet():
    return fdt.quantize_net(_net())


def _entry(net="32-2x64-48", kind="GPU test", batch=8192, **knobs):
    return {
        "net": net, "device_kind": kind, "batch": batch,
        "best_ms": 1.0, "knobs": knobs or {KNOB: 512},
    }


def test_net_key_equal_and_unequal_hidden(qnet):
    assert tuning.net_key(qnet) == "32-2x64-48"
    uneq = fdt.quantize_net(_net((64, 128)))
    assert tuning.net_key(uneq) == "32-64-128-48"


def test_lookup_prefers_largest_batch_then_nearest():
    reg = [_entry(batch=512, **{KNOB: 256}), _entry(batch=8192, **{KNOB: 1024})]
    assert tuning.lookup("32-2x64-48", "GPU test", registry=reg) == {KNOB: 1024}
    assert tuning.lookup("32-2x64-48", "GPU test", batch=600, registry=reg) == {KNOB: 256}
    assert tuning.lookup("32-2x64-48", "other card", registry=reg) is None
    assert tuning.lookup("different-net", "GPU test", registry=reg) is None


def test_apply_tuned_fills_defaults_but_respects_explicit(qnet, tmp_path, monkeypatch):
    reg = tmp_path / "tuned.json"
    reg.write_text(json.dumps({"entries": [_entry(**{KNOB: 0, "frame_bucket": 256})]}))
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))

    # a default knob -> the registry's value; a key outside TUNED_KEYS is ignored
    cfg = tuning.apply_tuned(EngineConfig(), qnet, "GPU test")
    assert cfg.stack_hidden_max_frames == 0
    assert cfg.frame_bucket == EngineConfig().frame_bucket
    # an explicit knob -> the caller wins
    cfg = tuning.apply_tuned(EngineConfig(stack_hidden_max_frames=1024), qnet, "GPU test")
    assert cfg.stack_hidden_max_frames == 1024
    # autotuned=False -> the registry is ignored entirely
    cfg = tuning.apply_tuned(EngineConfig(autotuned=False), qnet, "GPU test")
    assert cfg == EngineConfig(autotuned=False)
    # no entry for this device kind -> unchanged
    assert tuning.apply_tuned(EngineConfig(), qnet, "unknown card") == EngineConfig()


def test_apply_tuned_honors_tuned_batch_hint(qnet, tmp_path, monkeypatch):
    reg = tmp_path / "tuned.json"
    reg.write_text(json.dumps({"entries": [
        _entry(batch=256, **{KNOB: 256}),
        _entry(batch=8192, **{KNOB: 0}),
    ]}))
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))
    assert tuning.apply_tuned(EngineConfig(), qnet, "GPU test").stack_hidden_max_frames == 0
    cfg = tuning.apply_tuned(EngineConfig(tuned_batch=300), qnet, "GPU test")
    assert cfg.stack_hidden_max_frames == 256


def test_registry_user_state_fallback_and_merge(qnet, tmp_path, monkeypatch):
    """A read-only package directory sends --commit's write to the per-user
    state file; lookups merge package and user entries, user entries
    winning on key conflicts."""
    monkeypatch.delenv("FASTDNN_TUNED", raising=False)
    pkg_dir = tmp_path / "pkg"
    pkg_dir.mkdir()
    pkg = pkg_dir / "tuned.json"
    pkg.write_text(json.dumps({"entries": [
        _entry(batch=8192, **{KNOB: 1024}),  # shadowed by the user's
        _entry(batch=256, **{KNOB: 512}),  # package only
    ]}))
    monkeypatch.setattr(tuning, "_package_registry_path", lambda: str(pkg))
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "state"))

    assert tuning.registry_path() == str(pkg)  # writable package dir
    # a read-only install (chmod cannot show it: root passes os.access)
    monkeypatch.setattr(tuning, "_dir_writable", lambda d: d != str(pkg_dir))
    user = tuning._user_registry_path()
    assert user == str(tmp_path / "state" / "fastdnn_tpu_torch" / "tuned.json")
    assert tuning.registry_path() == user

    tuning.merge_entry(_entry(batch=8192, **{KNOB: 0}))
    assert len(tuning.load_registry(user)) == 1  # no wholesale copy
    merged = tuning.load_registry()
    assert len(merged) == 2
    assert tuning.lookup("32-2x64-48", "GPU test", registry=merged) == {KNOB: 0}
    assert tuning.lookup("32-2x64-48", "GPU test", batch=256, registry=merged) == {KNOB: 512}


def test_registry_disabled_and_corrupt(tmp_path, monkeypatch):
    for off in ("0", ""):
        monkeypatch.setenv("FASTDNN_TUNED", off)
        assert tuning.registry_path() is None
        assert tuning.registry_paths() == []
        assert tuning.load_registry() == []
        with pytest.raises(ValueError, match="disabled"):
            tuning.merge_entry(_entry())
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tuning.load_registry(str(bad)) == []  # never blocks scoring
    monkeypatch.setenv("FASTDNN_TUNED", str(bad))
    assert tuning.apply_tuned(EngineConfig(), fdt.quantize_net(_net()), "GPU test") == \
        EngineConfig()


def test_merge_entry_replaces_same_key(tmp_path):
    path = str(tmp_path / "reg.json")
    tuning.merge_entry(_entry(batch=512, **{KNOB: 256}), path)
    tuning.merge_entry(_entry(batch=8192, **{KNOB: 1024}), path)
    tuning.merge_entry(_entry(batch=8192, **{KNOB: 0}), path)  # same key: replaced
    entries = tuning.load_registry(path)
    assert len(entries) == 2
    assert tuning.lookup("32-2x64-48", "GPU test", registry=entries) == {KNOB: 0}


def test_scorer_consults_registry_on_the_cuda_backend(qnet, tmp_path, monkeypatch):
    """The Scorer's hook (engine.scorer.tuned_config) reads the registry for
    the CUDA backend in a single-rank process, with the card's name as the
    device kind; the plain backend and autotuned=False leave it alone."""
    reg = tmp_path / "tuned.json"
    reg.write_text(json.dumps({"entries": [_entry(kind="GPU test", **{KNOB: 0})]}))
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))
    kinds = []
    monkeypatch.setattr(tuning, "device_kind", lambda d: kinds.append(d) or "GPU test")
    cpu = torch.device("cpu")
    cfg = tscorer.tuned_config(EngineConfig(), qnet, KERNELS, cpu)
    assert cfg.stack_hidden_max_frames == 0 and kinds == [cpu]
    assert tscorer.tuned_config(EngineConfig(), qnet, PLAIN, cpu) == EngineConfig()
    off = EngineConfig(autotuned=False)
    assert tscorer.tuned_config(off, qnet, KERNELS, cpu) == off
    assert len(kinds) == 1


# -- parity with the JAX package's registry -----------------------------------


@pytest.mark.parametrize("hidden", [(64, 64), (64, 128), (96, 96, 96)])
def test_net_key_equals_jax(hidden):
    t_net = _net(hidden)
    j_q = fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))
    assert tuning.net_key(fdt.quantize_net(t_net)) == jtuning.net_key(j_q)


def test_flagship_net_key_equals_jax():
    """The flagship's key from its raw dims alone (no weights drawn)."""
    shape = dataclasses.make_dataclass("Dims", ["input_dim", "dims"])
    dims = shape(432, [2048] * 7 + [8000])
    dims.layer_dims = lambda: dims.dims
    assert tuning.net_key(dims) == jtuning.net_key(dims) == "432-7x2048-8000"


@pytest.mark.parametrize("batch", [None, 100, 300, 5000, 9000])
def test_lookup_reads_one_file_as_jax_does(tmp_path, monkeypatch, batch):
    reg = tmp_path / "tuned.json"
    entries = [
        _entry(batch=256, **{KNOB: 256}),
        _entry(batch=2048, **{KNOB: 1024}),
        _entry(batch=8192, **{KNOB: 0}),
        _entry(kind="other card", batch=8192, **{KNOB: 4096}),
    ]
    tuning.save_registry(entries, str(reg))
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))
    for kind in ("GPU test", "other card", "absent"):
        got = tuning.lookup("32-2x64-48", kind, batch=batch)
        assert got == jtuning.lookup("32-2x64-48", kind, batch=batch)
    assert tuning.load_registry() == jtuning.load_registry()


def test_tuned_scorer_matches_both_routes_and_jax(tmp_path, monkeypatch):
    """A config the registry tuned to the per-layer trunk scores, on the
    CPU, bitwise what the untuned stack trunk scores, and within 1e-4 of
    JAX's Scorer with argmax agreement 1.0."""
    t_net = fdt.random_net(np.random.default_rng(5), 432, [128] * 3, 300)
    t_q = fdt.quantize_net(t_net)
    j_q = fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))
    key = tuning.net_key(t_q)
    reg = tmp_path / "tuned.json"
    reg.write_text(json.dumps({"entries": [_entry(net=key, kind="GPU test", **{KNOB: 0})]}))
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))
    monkeypatch.setattr(tuning, "device_kind", lambda d: "GPU test")

    cfg = tscorer.tuned_config(EngineConfig(), t_q, KERNELS, torch.device("cpu"))
    assert cfg.stack_hidden_max_frames == 0
    frames = np.random.default_rng(6).standard_normal((200, 432), dtype=np.float32)
    tuned = fdt.Scorer(t_q, cfg, device="cpu")
    assert tuned._hstack is None
    stacked = fdt.Scorer(t_q, EngineConfig(autotuned=False), device="cpu")
    assert stacked._hstack is not None
    got = tuned.score(frames)
    np.testing.assert_array_equal(got, stacked.score(frames))
    want = fd.Scorer(j_q, fd.EngineConfig(backend="xla")).score(frames)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() == 1.0


def test_plain_backend_never_consults_the_registry(qnet, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("registry consulted")

    monkeypatch.setattr(tuning, "apply_tuned", refuse)
    monkeypatch.setattr(tuning, "lookup", refuse)
    monkeypatch.setattr(tuning, "device_kind", refuse)
    for cfg in (EngineConfig(backend="torch"), EngineConfig()):
        sc = fdt.Scorer(qnet, cfg, device="cpu")
        assert sc.backend == "torch" and sc.config == cfg


def test_shipped_registry_is_empty():
    with open(tuning._package_registry_path()) as f:
        assert json.load(f) == {"entries": []}
