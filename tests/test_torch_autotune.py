"""The port's autotuner end to end (``autotune/runner.py``, ``sweeps.py``,
``python -m mpi4jax_tpu_torch.autotune``) and the names it brings.

On the CPU: the command over two gloo ranks and over this process alone
writes a file that validates under both packages' validators, exits 1
(the alltoall crossover stays untuned on one host without a topology to
sweep, and two ranks are below the ring's group), tunes the codec
against the error budget, and records what one host cannot measure;
usage errors and a failed run exit 2.  In-process, ``autotune`` installs
its layer (``load_tuning``) and the config serves its values.  The
top-level names are the JAX package's.  On the card (``gpu``, run with
``--noconftest``: the file imports JAX only inside the tests that compare
with it): one CUDA rank's run gives a file whose provenance names the
card.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import mpi4jax_tpu_torch as tpx  # noqa: E402
from mpi4jax_tpu_torch.autotune import runner, schema, sweeps  # noqa: E402
from mpi4jax_tpu_torch.parallel.comm import Comm  # noqa: E402
from mpi4jax_tpu_torch.parallel.mesh import ProcessGrid  # noqa: E402
from mpi4jax_tpu_torch.utils import config  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def run_cli(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MPI4JAX_TPU_TUNING", "MPI4JAX_TPU_COST_MODEL"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", "mpi4jax_tpu_torch.autotune",
                           *map(str, args)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _one_rank():
    return Comm(("i",), mesh=ProcessGrid((1,), ("i",), torch.device("cpu"),
                                         rank=0))


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("tune") / "t2.json"
    # the budget caps the ladders; they end in a few seconds when unloaded
    res = run_cli("--budget-s", "60", "--ranks", "2", "--device", "cpu",
                  "--save", path, "--json")
    return res, path


def test_two_gloo_ranks_write_a_partial_file_both_packages_load(two_rank_run):
    from mpi4jax_tpu.autotune import schema as jschema

    res, path = two_rank_run
    assert res.returncode == 1, res.stderr
    payload = json.loads(path.read_text())
    assert json.loads(res.stdout.strip().splitlines()[-1]) == payload
    schema.validate_tuning_dict(payload)
    jschema.validate_tuning_dict(payload)
    assert schema.stamp_of(payload) == jschema.stamp_of(payload)
    untuned = res.stderr.split("untuned knob(s): ")[1].split("\n")[0]
    # two ranks are below the ring's group (4): its crossover stays
    # untuned; one host without --topologies: so does the alltoall's
    assert untuned == "ring_crossover_bytes, alltoall_crossover_bytes"
    ici = payload["links"]["ici"]
    assert ici["alpha_us"] > 0 and ici["gb_per_s"] > 0
    assert payload["links"]["dcn"]["alpha_us"] == pytest.approx(
        ici["alpha_us"] * 25.0, rel=1e-3)
    for key in ("gamma_gb_per_s", "compute_gb_per_s", "dispatch_us"):
        assert payload[key] > 0
    tuned = payload["tuned"]
    assert tuned["fusion_bucket_bytes"] in runner.FUSION_BUCKET_CANDIDATES
    assert "overlap_chunks" in tuned and "commit" in tuned
    prov = payload["provenance"]
    assert prov["platform"] == "cpu" and prov["n_devices"] == 2
    assert set(prov["skipped"]) == set(runner.SKIPPED_SWEEPS) == {
        "dcn_links", "hierarchy_gain", "codec_time"}
    # bf16's round-trip error fits the 1e-2 budget, fp8's does not
    assert tuned["compress"] == [
        {"max_bytes": tuned["dcn_crossover_bytes"], "codec": "off"},
        {"max_bytes": None, "codec": "bf16"}]
    assert 0 < payload["measured"]["compress_rel_err_bf16"] <= 1e-2
    assert "compress_rel_err_fp8" not in payload["measured"]
    assert payload["source"].startswith("mpi4jax_tpu_torch.autotune (cpu, 2")


def test_one_rank_leaves_the_ring_crossover_untuned(tmp_path):
    path = tmp_path / "t1.json"
    res = run_cli("--budget-s", "60", "--device", "cpu", "--save", path)
    assert res.returncode == 1, res.stderr
    assert "ring_crossover_bytes" in res.stderr.split("untuned knob(s):")[1]
    payload = json.loads(path.read_text())
    assert "ring_crossover_bytes" not in payload["tuned"]
    assert payload["provenance"]["n_devices"] == 1


@pytest.mark.parametrize("args", [("--budget-s", "0"), ("--ranks", "0"),
                                  ("--budget-s", "1", "--device", "bogus")])
def test_a_usage_error_or_a_failed_run_exits_2(args, tmp_path):
    res = run_cli(*args, "--save", tmp_path / "x.json")
    assert res.returncode == 2
    assert not (tmp_path / "x.json").exists()


def test_autotune_in_process_installs_its_layer():
    res = tpx.autotune(comm=_one_rank(), budget_s=1.0)
    tuned = res.payload["tuned"]
    try:
        assert config.active_tuning() is res.tuning
        # a budget spent before the second rung leaves the bucket untuned
        assert config.fusion_bucket_bytes() == tuned.get(
            "fusion_bucket_bytes", config.DEFAULT_FUSION_BUCKET_BYTES)
        assert ("fusion_bucket_bytes" in tuned) != \
            ("fusion_bucket_bytes" in res.unfitted)
        assert config.overlap_chunks() == res.tuning.knob("overlap_chunks")
        assert res.stamp == res.tuning.stamp
        assert "ring_crossover_bytes" in res.unfitted
        assert "links" in res.fitted
        assert repr(res).startswith(f"AutotuneResult(tuned@{res.stamp}")
    finally:
        tpx.load_tuning(None)
    assert config.active_tuning() is None
    from mpi4jax_tpu_torch.autotune import AutotuneResult

    assert isinstance(res, AutotuneResult)
    with pytest.raises(ValueError, match="budget_s"):
        tpx.autotune(comm=_one_rank(), budget_s=0)


def test_the_sweeps_report_the_jax_rows():
    comm = _one_rank()
    (row,) = sweeps.bench_sendrecv_ring(comm, [4.0], iters=2)
    assert set(row) == {"size_kb", "hop_us", "link_gb_s"}
    assert row["link_gb_s"] is None and row["hop_us"] > 0
    (frow,) = sweeps.bench_fusion(comm, counts=(4,), size_kb=1, iters=1)
    assert {"unfused_us_per_op", "fused_us_per_op", "fused_speedup"} <= set(frow)
    (orow,) = sweeps.bench_overlap(comm, sizes_mb=(0.01,), iters=1)
    assert orow["chunks"] == config.overlap_chunks(int(orow["size_mb"] * 1e6))
    assert sweeps.fold_gb_per_s(comm, 1 << 16, 2) > 0
    assert sweeps.copy_gb_per_s(comm, 1 << 16, 2) > 0
    assert sweeps.dispatch_us(comm, 5) > 0
    assert sweeps.fit_alpha_beta([(0, 10.0), (1000, 20.0)]) == \
        pytest.approx((10.0, 0.1))
    assert sweeps.fit_alpha_beta([(64, 5.0)]) == (5.0, 1e4)


def test_the_top_level_names_are_the_jax_packages():
    import mpi4jax_tpu as mpx

    for name in ("autotune", "TuningFile", "load_tuning", "active_tuning"):
        assert hasattr(tpx, name) and hasattr(mpx, name)
    assert callable(tpx.autotune) and tpx.TuningFile is schema.TuningFile
    from mpi4jax_tpu import analysis as janalysis
    from mpi4jax_tpu_torch import analysis as panalysis

    for name in ("check_cond_divergence", "hazard_jaxpr_findings",
                 "graph_arms_approx"):
        assert hasattr(panalysis, name) and hasattr(janalysis, name)


@pytest.mark.gpu
def test_one_cuda_rank_tunes_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    path = tmp_path / "card.json"
    res = run_cli("--budget-s", "10", "--save", path)
    assert res.returncode == 1, res.stderr
    payload = json.loads(path.read_text())
    schema.validate_tuning_dict(payload)
    assert payload["provenance"]["device"] == torch.cuda.get_device_name(0)
    assert payload["compute_gb_per_s"] > 100
