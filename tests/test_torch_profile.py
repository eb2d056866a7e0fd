"""The port's profiler (fastdnn_tpu_torch/cli/profile.py) in smoke mode on
the CPU, after tests/test_profile_smoke.py.

Every campaign runs as a user runs it, `python -m
fastdnn_tpu_torch.cli.profile <campaign>` under FASTDNN_PROFILE_SMOKE=1 (a
432 -> 3x256 -> 1024 net at B = 64, the plain versions), each in its own
process, all at once; each must exit 0 and end in its JSON verdict
line.  Its times are 0 by construction: only the control flow, the
per-variant isolation and the verdicts are under test here (the card runs
the campaigns in chip_smoke phase 27).  Then the pieces that need no run:
the kernel names read from the profiler's symbols, the stack threshold's
rule, and the refusals.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from fastdnn_tpu_torch.cli import profile
from fastdnn_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: campaign -> the key of its last JSON line
CAMPAIGNS = {
    "trace": "trace",
    "trace-mesh": "trace_mesh",
    "variants": "variants",
    "stages": "stages",
    "dots": "dots",
    "gathered": "gathered",
    "blocksparse": "blocksparse",
    "int4": "int4",
    "serving": "serving_config",
    "stack": "hidden_stack",
}


def _run(campaign: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, FASTDNN_PROFILE_SMOKE="1", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "fastdnn_tpu_torch.cli.profile", campaign],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240,
    )


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(max_workers=len(CAMPAIGNS)) as pool:
        return dict(zip(CAMPAIGNS, pool.map(_run, CAMPAIGNS)))


def _verdict(proc, campaign):
    assert proc.returncode == 0, (
        f"profile {campaign} exited {proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{") and ln.endswith("}")]
    assert lines, f"profile {campaign} printed no JSON verdict:\n{proc.stdout[-2000:]}"
    return json.loads(lines[-1])


@pytest.mark.parametrize("campaign", list(CAMPAIGNS))
def test_campaign_runs_and_ends_in_its_verdict(runs, campaign):
    record = _verdict(runs[campaign], campaign)
    key = CAMPAIGNS[campaign]
    assert key in record, f"verdict key {key!r} missing from {record}"
    body = record[key]
    if campaign == "int4":
        for variant in ("int8", "int4", "int4_packed"):
            row = body[variant]
            assert "error" not in row, row
            assert row["oracle_gate"] < profile.ORACLE_GATE
    if campaign == "serving":
        for variant in ("parity", "fast_out", "fast_in", "serving"):
            assert body[variant]["argmax_agree"] == 1.0
            assert body[variant]["oracle_gate"] < profile.ORACLE_GATE
        assert body["parity"]["max_dp_vs_parity"] == 0.0
    if campaign == "variants":  # tools/profile.py's six rows
        assert set(body) - {"batch"} == {
            f"fused{int(f)}_{p}_fast{int(x)}" for f, p, x in profile.VARIANTS}
        assert len(profile.VARIANTS) == 6
    if campaign == "stages":
        assert {"input_highest", "input_high", "input_default"} <= set(body)
    if campaign == "trace":
        # the plain versions launch no kernel and record no device time
        assert body["launched"] == {} and body["kernels"] == {} and body["total_ms"] == 0
    if campaign == "trace-mesh":
        assert body["extra"] == [] and body["missing"] == []
    if campaign == "stack":
        assert set(body["rows"]) == {"64", "128"}  # the smoke ladder
        assert body["threshold"] == 0  # no device time: the stack never wins
    if campaign == "blocksparse":
        for row in body["rows"]:
            assert 0.0 <= row["skip"] <= row["skip_cl"] <= 1.0


def test_each_run_prints_its_header_and_seconds(runs):
    """Each campaign prints the header and seconds by which a run of
    several (`all`, chip_smoke phase 27) is read; `all` keeps this order."""
    for campaign, proc in runs.items():
        assert f"== campaign {campaign} (batch 64, cpu)" in proc.stdout
        assert f"== campaign {campaign}: " in proc.stdout
    assert list(CAMPAIGNS) == list(profile.CAMPAIGNS)


# symbols as torch.profiler names them (demangled by CUPTI; the first three
# and the streamed layer's as an H100 run printed them)
SYMBOLS = [
    ("(anonymous namespace)::input_layer_kernel(CUtensorMap_st, CUtensorMap_st, float const*, "
     "signed char*, int, int)", "input_layer"),
    ("void (anonymous namespace)::hidden_stack_wgmma_kernel<2>(CUtensorMap_st, signed char "
     "const*, int const*, float const*, float const*, signed char*, int, int, int)",
     "hidden_stack"),
    ("void (anonymous namespace)::resident_softmax_wgmma_kernel<false, false, float>("
     "CUtensorMap_st, signed char const*, int const*, float const*, float*, int, int)",
     "resident_softmax"),
    ("void fdn::hopper::streamed_layer_kernel<(anonymous namespace)::SigmoidEpilogue, 2>("
     "CUtensorMap_st, CUtensorMap_st, int const*, float const*, float, signed char*, int)",
     "hidden_layer"),
    ("void fdn::hopper::streamed_layer_kernel<(anonymous namespace)::LogitsEpilogue, 1>("
     "CUtensorMap_st, CUtensorMap_st, int const*, float const*, float, float*, int)",
     "output_logits"),
    ("void (anonymous namespace)::bias_sigmoid_kernel(float const*, float const*, signed char*, "
     "int, int)", "bias_sigmoid_i8"),
    ("void (anonymous namespace)::hidden_layer_packed_kernel<4, 2>(CUtensorMap_st, "
     "CUtensorMap_st, int const*)", "hidden_layer_packed"),
    ("void (anonymous namespace)::resident_softmax_wgmma_kernel<true, false, __nv_bfloat16>("
     "CUtensorMap_st)", "resident_softmax"),
    ("void (anonymous namespace)::resident_softmax_wgmma_kernel<true, true, float>("
     "CUtensorMap_st, signed char const*)", "resident_softmax_block_sparse"),
    ("void (anonymous namespace)::flash_stats_kernel<false, false, false>(CUtensorMap_st)",
     "flash_stats"),
    ("void (anonymous namespace)::flash_stats_kernel<true, false, true>(CUtensorMap_st)",
     "flash_stats_block_sparse"),
    ("void (anonymous namespace)::normalize_stats_kernel<false, 4>(float const*, float const*)",
     "normalize_stats"),
    ("(anonymous namespace)::input_layer_bf16_kernel(CUtensorMap_st, CUtensorMap_st, float "
     "const*, signed char*, int, int, int, int, int)", "input_layer_bf16"),
    ("(anonymous namespace)::lazy_output_kernel(signed char const*, signed char const*, int "
     "const*, float const*, float, unsigned char const*, int, int, float*, int, int)",
     "lazy_output"),
    ("void (anonymous namespace)::lowrank_layer_kernel<2>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, int const*, float, float, float const*, signed char*, int, int, int)",
     "lowrank_layer"),
    ("void (anonymous namespace)::lowrank_bottleneck_kernel<1>(CUtensorMap_st, CUtensorMap_st, "
     "int const*, float, float, signed char*, float*, int, int)", "lowrank_bottleneck"),
    ("void (anonymous namespace)::tdnnf_input_kernel<false>(float const*, float const*, "
     "float const*, float const*, float const*, signed char*, float*, int, int, int)",
     "tdnnf_input"),
    ("void (anonymous namespace)::tdnnf_project_kernel<2>((anonymous namespace)::Term, (anonymous namespace)::Term, "
     "(anonymous namespace)::RowMap, int, signed char*, float*, int, int)", "tdnnf_project"),
    ("void (anonymous namespace)::tdnnf_expand_kernel<2>((anonymous namespace)::Term, (anonymous namespace)::Term, "
     "(anonymous namespace)::RowMap, int, float const*, float const*, float const*, "
     "(anonymous namespace)::Bypass, signed char*, float*, int, int, int)", "tdnnf_expand"),
    ("void (anonymous namespace)::chain_project_kernel<true>((anonymous namespace)::Term, (anonymous namespace)::RowMap, "
     "int, float const*, signed char*, float*, int, int)", "chain_project"),
    ("void (anonymous namespace)::chain_expand_kernel((anonymous namespace)::Term, (anonymous namespace)::RowMap, int, "
     "float const*, float const*, float const*, signed char*, float*, int, int, int)",
     "chain_expand"),
    ("void (anonymous namespace)::chain_logits_kernel((anonymous namespace)::Term, float const*, float*, int, int, int)",
     "chain_logits"),
    ("ampere_sgemm_128x64_nn", None),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     None),
]


@pytest.mark.parametrize("symbol,name", SYMBOLS, ids=[n or "other" for _, n in SYMBOLS])
def test_kernel_of_names_the_ports_kernels(symbol, name):
    assert profile.kernel_of(symbol) == name
    assert name is None or name in kernels.KERNELS


def test_by_kernel_sums_per_name():
    ours, other = profile.by_kernel([(SYMBOLS[1][0], 0.5), (SYMBOLS[1][0], 0.25),
                                     (SYMBOLS[-2][0], 0.1)])
    assert ours == {"hidden_stack": 0.75} and other == {SYMBOLS[-2][0]: 0.1}


def test_every_kernel_has_a_symbol():
    assert {n for _, n in SYMBOLS if n} == set(kernels.KERNELS)


def test_stack_threshold_rule():
    rows = {128: {"stack_ms": 1.0, "per_layer_ms": 2.0},
            512: {"stack_ms": 3.0, "per_layer_ms": 2.0},
            1024: {"stack_ms": 1.0, "per_layer_ms": 2.0},
            2048: {"stack_ms": 3.0, "per_layer_ms": 2.0}}
    assert profile.stack_threshold(rows) == 1024  # the largest B where it still wins
    assert profile.stack_threshold({128: {"stack_ms": 2.0, "per_layer_ms": 2.0}}) == 0


def test_profile_device_on_the_cpu_records_no_device_time():
    calls = []
    window_ms, device = profile.profile_device(lambda: calls.append(1), 3)
    assert window_ms >= 0 and device == [] and len(calls) == 4  # a warm-up call, then 3


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.main(["trace", "--device", "cuda"])
    assert profile._cli(["trace", "--device", "cuda"]) == 2


def test_unknown_campaign_is_refused():
    with pytest.raises(ValueError, match="unknown campaign"):
        profile.main(["nope", "--device", "cpu"])
