"""The chaos drills of ``resilience/drill.py`` against the JAX package's.

Both drills are pure (numpy only): one rank-pinned ``ShardStore`` per
simulated rank, the pure agreement models as the fabric.  The port's
metrics must equal the JAX package's exactly, pattern by pattern and for
the whole ``drill_matrix((8, 16, 64))``, and the restores must be bit
for bit (each drill asserts that itself).
"""

import numpy as np
import pytest

import mpi4jax_tpu.resilience.drill as jdrill
from mpi4jax_tpu_torch.resilience import drill, elastic
from torch_port_isolation import isolated_reference_state  # noqa: F401


def test_drill_matrix_equals_jax():
    assert drill.drill_matrix((8, 16, 64)) == jdrill.drill_matrix((8, 16, 64))


@pytest.mark.parametrize("pattern", drill.PATTERNS)
@pytest.mark.parametrize("k", [4, 9, 12])
@pytest.mark.parametrize("redundancy", [1, 2])
@pytest.mark.parametrize("placement", ["stripe", "neighbor"])
def test_run_drill_equals_jax(pattern, k, redundancy, placement):
    def run(mod):
        try:
            return mod.run_drill(pattern, k, redundancy=redundancy,
                                 placement=placement)
        except (AssertionError, ValueError, RuntimeError) as e:
            return (type(e).__name__, str(e))

    assert run(drill) == run(jdrill)


@pytest.mark.parametrize("k", [1, 5, 8, 16, 64])
def test_drill_helpers_equal_jax(k):
    assert drill.default_counts(k) == jdrill.default_counts(k)
    counts = drill.default_counts(k)
    for pattern in drill.PATTERNS:
        try:
            got = drill.kill_set(pattern, k, counts)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                jdrill.kill_set(pattern, k, counts)
            continue
        assert got == jdrill.kill_set(pattern, k, counts)
        assert drill.links_for(k, got) == jdrill.links_for(k, got)
        for mode in ("coordinator", "gossip"):
            assert drill.agreement_connections(k, got, mode) == \
                jdrill.agreement_connections(k, got, mode)


def test_reassemble_from_stores_survives_any_single_loss():
    """Rank-pinned stores of 6 simulated ranks (redundancy 1): losing any
    one store reassembles the committed state bit for bit; losing a shard's
    every holder raises."""
    class World:
        def world_size(self):
            return 6

    state = {"x": np.arange(101, dtype=np.float32),
             "y": [np.int64(-3), np.ones((2, 3), np.float16)]}
    stores = {r: elastic.ShardStore(World(), redundancy=1, rank=r)
              for r in range(6)}
    for s in stores.values():
        s.commit(4, state)
    for dead in range(6):
        step, back = elastic.reassemble_from_stores(stores, {dead})
        assert step == 4
        assert back["x"].tobytes() == state["x"].tobytes()
        assert back["y"][1].tobytes() == state["y"][1].tobytes()
        assert back["y"][0] == state["y"][0]
    with pytest.raises(elastic.RankFailure):
        elastic.reassemble_from_stores(stores, {2, 3})
