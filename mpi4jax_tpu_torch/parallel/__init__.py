"""Process grids, communicators and routing specs, and the two parallel
workloads: the expert-parallel MoE layer (``moe``) and the pipeline
schedule compiler (``pipeline``, ``PipelineProgram``), exported as the JAX
package's ``parallel`` exports them (``parallel.pipeline`` is the
function; import the module's other names from
``mpi4jax_tpu_torch.parallel.pipeline``)."""

from . import moe  # noqa: F401
from .pipeline import PipelineProgram, pipeline  # noqa: F401
