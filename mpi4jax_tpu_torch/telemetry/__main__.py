"""CLI: ``python -m mpi4jax_tpu_torch.telemetry merge <dir> --perfetto out.json``.

Merges every rank's events-tier JSONL journal into one Chrome-trace-event
timeline (rank = pid, op rows = tids; open it in Perfetto or
``chrome://tracing``) and prints the straggler attribution table.  Exits
2 on a malformed journal line.

``python -m mpi4jax_tpu_torch.telemetry postmortem <dir>`` reads the
health plane's per-rank bundles (``postmortem-p*.json``) instead, aligns
their flight rings by call id and prints each rank's last known frontier
and the suspected straggler; exits 2 without bundles.  See
``telemetry/merge.py``.
"""

import sys

from .merge import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
