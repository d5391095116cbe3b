"""Process grids, communicators and routing specs (the names the JAX
package's ``parallel`` exports; ``launch.run`` starts ranks, and
``parallel.run`` is the region's, as there), and the two parallel
workloads: the expert-parallel MoE layer (``moe``) and the pipeline
schedule compiler (``pipeline``, ``PipelineProgram``), exported as the JAX
package's ``parallel`` exports them (``parallel.pipeline`` is the
function; import the module's other names from
``mpi4jax_tpu_torch.parallel.pipeline``)."""

from .comm import Comm  # noqa: F401
from .control import cond, switch  # noqa: F401
from . import moe  # noqa: F401
from .mesh import (  # noqa: F401
    DEFAULT_AXIS,
    get_default_mesh,
    init_distributed,
    make_world_mesh,
    set_default_mesh,
    shrink_world_mesh,
)
from .pipeline import PipelineProgram, pipeline  # noqa: F401
from .rankspec import (  # noqa: F401
    invert_pairs,
    normalize_dest,
    normalize_source,
    shift,
)
from .region import (  # noqa: F401
    current_context,
    get_default_comm,
    in_parallel_region,
    resolve_comm,
    run,
    spmd,
)
