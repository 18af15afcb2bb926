"""Iterative solvers over the port's SpMV and SpMM kernels.

Counterpart of the JAX package's ``solvers/``, with the same modules and
function names. Each JAX ``lax.while_loop`` / ``fori_loop`` / ``scan`` is a
Python loop of the same recurrences: the state stays on the device of the
caller's tensors (``b``, ``B``, ``Q0``, ``v0``), each iteration reads back
one boolean, its stop test, where the JAX loop tests its condition (so
iteration counts are JAX's), and iteration counts come back as Python
``int``. Every solver takes any matvec or matmat callable; ``cg_sell``
takes the port's device containers. Functions that make device data from
host data take a required ``device=``.
"""

from .bicgstab import bicgstab
from .cg import cg, cg_multi, cg_sell, jacobi_preconditioner
from .chebyshev import (chebyshev_preconditioner, chebyshev_smooth,
                        gershgorin_bounds)
from .gmres import gmres
from .lanczos import lanczos, lanczos_bounds, lanczos_extremal
from .power import (GraphedPageRank, pagerank, pagerank_operator,
                    power_iteration)
from .refine import iterative_refinement
from .subspace import subspace_iteration

__all__ = ["cg", "cg_multi", "cg_sell", "jacobi_preconditioner", "bicgstab",
           "gmres", "power_iteration", "pagerank", "GraphedPageRank",
           "pagerank_operator",
           "iterative_refinement", "subspace_iteration",
           "chebyshev_preconditioner", "chebyshev_smooth",
           "gershgorin_bounds",
           "lanczos", "lanczos_extremal", "lanczos_bounds"]
