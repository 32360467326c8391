"""simplex_tpu — a linear-programming framework for an accelerator (GPU).

A from-scratch re-design of the capabilities of the-utn-team/simplex-solver
(see SURVEY.md): standard-form LPs with <=/>=/= constraints solved by a
two-phase tableau simplex expressed as jitted JAX/XLA/Pallas kernels, plus
batched (vmap), revised-simplex, first-order (PDHG) and multi-device
(shard_map) paths, with the reference's services (storage, reports, web UI)
rebuilt on top.
"""
__version__ = "0.1.0"

from .config import SolverConfig
from .core.parsing import (
    Constraint,
    ConstraintsParser,
    ConstraintsValidator,
    ObjectiveFunctionParser,
)
from .core.problem import (
    BoundsTransform,
    LinearProgram,
    compile_standard_form,
    lower_bounds_to_rows,
    merge_free_solution,
    normalize_bounds,
    split_free_variables,
)
from .utils.mps import load_mps, parse_mps
from .models.batched import (BatchedSimplexSolver, BatchResult,
                             solve_arrays_stream, solve_lp_batch,
                             solve_lp_sweep)
from .models.dense import (DenseSimplexSolver, SimplexResult,
                           reoptimize, solve_lp)
from .models.pdhg import PdhgSolver
from .models.revised import RevisedSimplexSolver

__all__ = [
    "BatchResult",
    "BatchedSimplexSolver",
    "BoundsTransform",
    "lower_bounds_to_rows",
    "normalize_bounds",
    "Constraint",
    "ConstraintsParser",
    "ConstraintsValidator",
    "DenseSimplexSolver",
    "LinearProgram",
    "ObjectiveFunctionParser",
    "PdhgSolver",
    "RevisedSimplexSolver",
    "SimplexResult",
    "SolverConfig",
    "compile_standard_form",
    "load_mps",
    "merge_free_solution",
    "parse_mps",
    "reoptimize",
    "solve_arrays_stream",
    "solve_lp",
    "solve_lp_batch",
    "solve_lp_sweep",
    "split_free_variables",
]
