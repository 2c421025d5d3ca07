"""Dense numerics core (L1/L2 of SURVEY.md): the JAX replacement for
the reference's Breeze/LAPACK layer (cvx/MatrixUtils.scala,
cvx/KKTSystem.scala, cvx/SymmetricLinearSystem.scala)."""

from .cholesky import (back_solve, chol_solve_factored, cholesky_solve,
                       forward_solve, regularized_cholesky, relative_residual,
                       tri_solve)
from .eigsolve import svd_solve, sym_solve_eig
from .equilibrate import (check_symmetric, condition_number,
                          hs_norm, ruiz_equilibrate)
from .kkt import kkt_solve, lin_solve, sym_solve
from .nullspace import SolutionSpace, solution_space
from .reduction import (UnsolvableSystemError, free_coordinates,
                        pad_solution, reduce_kkt)
from .scalar import bisect, newton_1d
from .testmat import (decaying_spectrum, nasty_rhs, random_orthogonal,
                      random_spd, sign_combination_matrix,
                      sign_combination_matrix_padded)

__all__ = [
    "back_solve", "chol_solve_factored", "cholesky_solve", "forward_solve",
    "regularized_cholesky", "relative_residual", "tri_solve", "sym_solve_eig",
    "ruiz_equilibrate", "check_symmetric", "condition_number",
    "hs_norm", "kkt_solve", "lin_solve", "svd_solve", "sym_solve",
    "SolutionSpace",
    "solution_space",
    "UnsolvableSystemError", "free_coordinates", "pad_solution",
    "reduce_kkt", "bisect", "newton_1d", "decaying_spectrum", "nasty_rhs", "random_orthogonal",
    "random_spd", "sign_combination_matrix", "sign_combination_matrix_padded",
]
