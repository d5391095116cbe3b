"""The shallow-water command line against the JAX example's, on the CPU.

``examples/shallow_water.py:main`` runs under a patched ``sys.argv`` on 1
and on 4 of the 8 virtual JAX devices, its ``solve``/``solve_fused``
wrapped to keep what they return; the port's ``run`` takes the same flags
plus ``--device cpu``, in this process for one rank and on four gloo ranks
for ``--n-devices 4``.  The size (``--scale 0.2``: 72x36, (2,2) local
interiors of 36x18) is one where ``fast="auto"`` picks the same mode in
both packages (``pallas2`` on one rank, ``wide2`` on four), and
``--t1-days 0.005`` runs 31 steps.  Every reassembled snapshot is held in
the band of ``tests/test_torch_multirank_sw.py:
test_solve_gathered_h_matches_jax``, ``5e-6 + 1e-6 * max|a|``.
"""

import contextlib
import io
import os
import sys
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the 8-device CPU mesh of tests/conftest.py)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_water as J  # noqa: E402

import torch_ranks as R0  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402
from torch_port_isolation import isolated_reference_state  # noqa: E402,F401

pytest_plugins = ["leaked_env_guard"]

SCALE, T1_DAYS = "0.2", "0.005"
DEMO = ["--scale", SCALE, "--t1-days", T1_DAYS]
N_STEPS = 31
AUTO = {1: "pallas2", 4: "wide2"}
# --benchmark at a reduced scale on one device: 36x18, 0.01 day, 51 steps
BENCH = ["--benchmark", "--scale", "0.1", "--t1-days", "0.01", "--n-devices", "1"]
BENCH_STEPS = 51


def _band(want):
    return 5e-6 + 1e-6 * np.abs(want).max()


def jax_main(argv):
    """``examples/shallow_water.py:main`` on ``argv``: its stdout, config,
    step count and snapshots (the demo) or final state (``--benchmark``)."""
    rec = {}
    real_solve, real_fused = J.solve, J.solve_fused

    def solve(cfg, t1, **kw):
        snaps, wall, n = real_solve(cfg, t1, **kw)
        rec.update(cfg=cfg, n_steps=n, snapshots=[np.asarray(s) for s in snaps])
        return snaps, wall, n

    def solve_fused(cfg, t1, **kw):
        wall, n, state = real_fused(cfg, t1, return_state=True, **kw)
        rec.update(cfg=cfg, n_steps=n, final=[np.asarray(f) for f in state])
        return wall, n

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "solve", solve)
        mp.setattr(J, "solve_fused", solve_fused)
        mp.setattr(sys, "argv", ["shallow_water.py", *argv])
        with contextlib.redirect_stdout(out):
            J.main()
    rec["stdout"] = out.getvalue()
    return rec


def port_run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = P.run([*argv, "--device", "cpu"], timeout=R0.RANK_TIMEOUT_S)
    res["stdout"] = out.getvalue()
    res["cfg"] = asdict(res["cfg"])
    return res


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return R0.RunResults(tmp_path_factory, "sw-cli")


def both(results, n):
    argv = [*DEMO, "--n-devices", str(n)]
    return (results.get(f"jax-demo-{n}", lambda: jax_main(argv)),
            results.get(f"port-demo-{n}", lambda: port_run(argv)))


@pytest.mark.parametrize("n", [1, 4])
def test_auto_picks_the_same_mode_in_both(results, n):
    want, got = both(results, n)
    jcfg, pcfg = want["cfg"], P.Config(**got["cfg"])
    mode = AUTO[n]
    assert (jcfg.nproc_y, jcfg.nproc_x) == got["grid"] == P.pick_process_grid(n)
    assert asdict(jcfg) == got["cfg"]
    assert got["mode"] == P.resolve_fast("auto", pcfg) == mode
    assert J.select_steps("auto", jcfg) == J.select_steps(mode, jcfg)
    assert P.select_steps("auto", pcfg) == P.select_steps(mode, pcfg)


@pytest.mark.parametrize("n", [1, 4])
def test_command_matches_jax(results, n):
    """Step counts, snapshot counts and every reassembled snapshot."""
    want, got = both(results, n)
    cfg = want["cfg"]
    assert want["n_steps"] == got["n_steps"] == N_STEPS
    assert len(want["snapshots"]) == len(got["snapshots"]) == 2 + (N_STEPS - 1) // 10 + 1
    for i, (a, b) in enumerate(zip(want["snapshots"], got["snapshots"])):
        assert a.shape == b.shape == (n, cfg.ny_local, cfg.nx_local), i
        a, b = J.reassemble(a, cfg), P.reassemble(b, P.Config(**got["cfg"]))
        err = np.abs(a - b).max()
        assert err <= _band(a), f"snapshot {i}: {err:.3e} > {_band(a):.3e}"
    # the last two are the same final state: stacked, then root-gathered
    np.testing.assert_array_equal(got["snapshots"][-1], got["snapshots"][-2])


@pytest.mark.parametrize("n", [1, 4])
def test_command_prints_the_jax_lines(results, n):
    want, got = both(results, n)
    head = want["stdout"].splitlines()[0]
    assert head.startswith("shallow water: 36x72 interior on a ")
    # the JAX line's interior, grid, count and dt; "device(s)" are ranks here
    j_grid, j_dt = head.split(" mesh of ")[0], head.split(", dt=")[1]
    p_head = got["stdout"].splitlines()[0]
    assert p_head.split(" mesh of ")[0] == j_grid
    assert p_head.split(" mesh of ")[1].startswith(f"{n} CPU rank(s)")
    assert p_head.split(", dt=")[1] == j_dt
    for out in (want["stdout"], got["stdout"]):
        assert f"({N_STEPS} steps, " in out.splitlines()[-1]
        assert out.splitlines()[-1].startswith("Solution took ")
    assert got["wall"] == max(got["walls"]) > 0
    assert len(got["walls"]) == n


@pytest.mark.parametrize("n", [1, 4])
def test_demo_launches_nothing_on_the_cpu(results, n):
    """The wrappers run their plain versions on CPU tensors and count no
    launch; each rank reports its own counts."""
    _, got = both(results, n)
    assert got["launches"] == [{}] * n
    assert got["final_h"] is None


def test_benchmark_matches_jax_solve_fused(results):
    """``--benchmark`` at a reduced ``--scale``: ``solve_fused``'s step
    count, no snapshots, and its final ``h`` in the run band of
    ``tests/test_examples.py:337``."""
    want = results.get("jax-bench", lambda: jax_main(BENCH))
    got = results.get("port-bench", lambda: port_run(BENCH))
    assert want["n_steps"] == got["n_steps"] == BENCH_STEPS
    assert got["snapshots"] == [] and "snapshots" not in want
    assert got["mode"] == "pallas2"
    cfg = want["cfg"]
    h = want["final"][0]
    assert got["final_h"].shape == h.shape == (1, cfg.ny_local, cfg.nx_local)
    err = np.abs(got["final_h"] - h).max()
    assert err <= 1e-5 + 2e-6 * np.abs(h).max()


def test_n_devices_3_raises_the_jax_message(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["shallow_water.py", "--n-devices", "3"])
    with pytest.raises(ValueError) as want:
        J.main()
    with pytest.raises(ValueError) as got:
        P.main(["--n-devices", "3", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "Got invalid number of devices: 3" in str(got.value)


@pytest.mark.parametrize("n", [1, 4])
def test_animation_frames_match_jax(results, n):
    """The frames are the JAX function's ``reassemble(s) - depth``."""
    _, got = both(results, n)
    pcfg = P.Config(**got["cfg"])
    jcfg = J.Config(**got["cfg"])
    frames = P.animation_frames(got["snapshots"], pcfg)
    assert len(frames) == len(got["snapshots"])
    for f, s in zip(frames, got["snapshots"]):
        np.testing.assert_array_equal(f, np.asarray(J.reassemble(s, jcfg)) - jcfg.depth)
        assert f.shape == (jcfg.ny, jcfg.nx)


def test_save_animation_writes_a_frame_a_snapshot(results, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    _, got = both(results, 4)
    path = tmp_path / "sw.gif"
    P.save_animation(got["snapshots"], P.Config(**got["cfg"]), path=str(path))
    assert capsys.readouterr().out == f"wrote {path}\n"
    with Image.open(path) as gif:
        assert gif.n_frames == len(got["snapshots"])


def test_save_animation_flag_writes_the_gif(tmp_path, monkeypatch, capsys):
    """``main --save-animation`` writes ``shallow-water.gif`` in the working
    directory, one frame a snapshot; ``--benchmark`` keeps no snapshot and
    writes nothing."""
    pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    monkeypatch.chdir(tmp_path)
    assert P.main([*BENCH, "--save-animation", "--device", "cpu"]) == 0
    assert not (tmp_path / "shallow-water.gif").exists()
    argv = ["--scale", "0.1", "--t1-days", "0.002", "--save-animation",
            "--device", "cpu"]
    assert P.main(argv) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "wrote shallow-water.gif"
    with Image.open(tmp_path / "shallow-water.gif") as gif:
        # the initial state, the first step, one multistep, the gathered view
        assert gif.n_frames == 4


def test_save_animation_without_matplotlib_prints_the_jax_line(results, tmp_path,
                                                              monkeypatch, capsys):
    _, got = both(results, 1)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    jcfg = J.Config(**got["cfg"])
    J.save_animation(got["snapshots"], jcfg)
    want = capsys.readouterr().out
    P.save_animation(got["snapshots"], P.Config(**got["cfg"]))
    assert capsys.readouterr().out == want == (
        "matplotlib not available; skipping animation\n")
    assert os.listdir(tmp_path) == []
