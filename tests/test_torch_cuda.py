"""The port's CUDA kernel and CUDA-graph run, on a card.

Every test here needs a CUDA device and ``nvcc``; each decides inside the
test and skips without them.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` sets up JAX.)
``python3 chip_smoke.py`` holds the kernel against its plain version at
the main path's full width.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mpi4jax_tpu_torch.entry import entry  # noqa: E402
from mpi4jax_tpu_torch.kernels import sw_steps as K  # noqa: E402
from mpi4jax_tpu_torch.models import shallow_water as P  # noqa: E402

STEP_CASES = [(True, 1), (False, 1), (False, 2), (False, 3)]


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


def perturbed_state(ny, nx, seed=0):
    cfg = P.Config(nx=nx, ny=ny)
    base = [f.numpy() for f in P.initial_state(cfg, device="cpu")]
    rng = np.random.default_rng(seed)
    scales = (1e-2, 1e-2, 1e-2, 1e-4, 1e-5, 1e-5)
    return tuple(
        torch.from_numpy((b + s * rng.standard_normal(b.shape)).astype(np.float32)).cuda()
        for b, s in zip(base, scales)
    )


@pytest.mark.gpu
@pytest.mark.parametrize("first,nsteps", STEP_CASES)
@pytest.mark.parametrize("ny,nx", [(24, 40), (270, 40), (8, 8), (33, 65)])
def test_kernel_matches_plain(ny, nx, first, nsteps):
    """Bit for bit: the kernel keeps the plain version's operand order and
    is built without FMA contraction; band 5e-6 + 1e-6*max|a| as a floor."""
    need_cuda()
    cfg = P.Config(nx=nx, ny=ny)
    fields = perturbed_state(ny, nx)
    before = K.counter.launches
    got = K.sw_steps(fields, cfg, first, nsteps)
    want = K.sw_steps_plain(fields, cfg, first, nsteps)
    torch.cuda.synchronize()
    assert K.counter.launches == before + 1
    for a, b in zip(want, got):
        assert (a - b).abs().max().item() <= 5e-6 + 1e-6 * a.abs().max().item()


@pytest.mark.gpu
def test_kernel_wrapper_checks():
    need_cuda()
    cfg = P.Config(nx=8, ny=8)
    good = tuple(P.initial_state(cfg, device="cuda"))
    with pytest.raises(ValueError, match="f32"):
        K.sw_steps(tuple(f.double() for f in good), cfg, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.sw_steps(tuple(f.t() for f in good), cfg, False, 1)
    with pytest.raises(ValueError, match="contiguous"):
        K.sw_steps(tuple(f[:, :5] for f in good), cfg, False, 1)


@pytest.mark.gpu
def test_pinned_run_counts_replayed_launches():
    need_cuda()
    cfg = P.Config(nx=48, ny=24)
    info = {}
    before = K.counter.launches
    _, n, pinned = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                 pinned=True, return_state=True, info=info)
    assert n == 7 and info["pinned"] and info["runs"] == 4
    assert K.counter.launches - before == (1 + 3) * 4  # Euler + 3 pairs per run
    assert K.counter.captured == 0
    _, _, eager = P.solve_fused(cfg, 7 * cfg.dt, num_multisteps=2, fast="auto",
                                return_state=True, device="cuda")
    for a, b in zip(eager, pinned):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_entry_runs_on_the_card():
    need_cuda()
    fn, (state,) = entry()
    assert state.h.is_cuda
    before = K.counter.launches
    out = fn(state)
    assert K.counter.launches == before + 1
    assert all(bool(torch.isfinite(f).all()) for f in out)
