"""Resilience of the port: fail loudly instead of hanging silently.

PyTorch counterpart of ``mpi4jax_tpu/resilience/``.  One dead or
stalled rank leaves every other rank blocked in its next exchange; this
package is the layer that turns that into a loud, diagnosable death or a
recovery, and rehearses both:

- :mod:`.watchdog`: a registry armed and disarmed around each op (in C++
  where the hooks library builds, ``native.py``); an op in flight longer
  than ``MPI4JAX_TPU_WATCHDOG_TIMEOUT`` seconds dumps the in-flight ops
  and kills the process;
- :mod:`.faultinject`: deterministic delay/die/hang/corrupt injection
  from a parsed ``MPI4JAX_TPU_FAULT_SPEC``, at the dispatch point every
  op goes through (``ops/_base.py:run_body``);
- :mod:`.numerics`: opt-in ``MPI4JAX_TPU_CHECK_NUMERICS`` NaN/Inf guards
  on each op's inputs and outputs, through ``native.abort_if``;
- :mod:`.retry`: full-jitter backoff with a total deadline, around
  ``init_distributed``'s rendezvous;
- :mod:`.runtime`: the configuration and the per-op :class:`~.runtime.Plan`
  the dispatch point consults.  Every feature is off by default, and then
  the dispatch point runs each op's body directly.

- :mod:`.elastic`: elastic recovery (communication epochs, failure
  agreement, the in-memory ``ShardStore`` and the loop, ``elastic.run``,
  that survives a rank's loss on the survivors, drains an announced
  leaver at a step boundary, and admits replacement ranks);
- :mod:`.drill`: the pure in-process chaos drills of that control plane.
"""

from . import drill, elastic  # noqa: F401
from .elastic import (  # noqa: F401
    RankFailure,
    ShardStore,
    coordinator_agreement,
    gossip_agreement,
    install_preemption_handler,
    neighbor_placement,
    request_drain,
    stripe_placement,
)
from .faultinject import (  # noqa: F401
    FaultClause,
    canonical_spec,
    parse_fault_spec,
    reset_fault_state,
)
from .retry import backoff_delay, retry_with_backoff  # noqa: F401
from .runtime import (  # noqa: F401
    cache_token,
    plan_for,
    reset_overrides,
    set_check_numerics,
    set_fault_spec,
    set_watchdog_timeout,
)
from .watchdog import (  # noqa: F401
    drain_registry,
    inflight_snapshot,
    registry_empty,
    set_on_timeout,
)

__all__ = [
    "elastic",
    "drill",
    "RankFailure",
    "ShardStore",
    "request_drain",
    "install_preemption_handler",
    "coordinator_agreement",
    "gossip_agreement",
    "stripe_placement",
    "neighbor_placement",
    "FaultClause",
    "parse_fault_spec",
    "canonical_spec",
    "reset_fault_state",
    "backoff_delay",
    "retry_with_backoff",
    "plan_for",
    "cache_token",
    "set_watchdog_timeout",
    "set_fault_spec",
    "set_check_numerics",
    "set_on_timeout",
    "reset_overrides",
    "inflight_snapshot",
    "registry_empty",
    "drain_registry",
]
