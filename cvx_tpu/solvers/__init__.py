"""Solver layer (L4 of SURVEY.md): Newton engines, barrier and primal-dual
interior-point methods, phase-I feasibility — the JAX replacement for
cvx/UnconstrainedSolver.scala, cvx/EqualityConstrainedSolver.scala,
cvx/BarrierSolver.scala, cvx/PrimalDualSolver.scala and the phase-I half of
cvx/ConstraintSet.scala."""

from .barrier import barrier_solve
from .primal_dual import primal_dual_solve
from .structured import barrier_solve_structured
from .newton import newton_minimize, newton_minimize_eq
from .phase1 import (FeasibilityReport, InfeasibleProblemError,
                     feasibility_analysis, find_feasible_point,
                     phase1_by_reduction, phase1_simple, phase1_soi,
                     phase1_with_eqs_as_ineqs)
from .types import (NewtonResult, OptState, Solution, SolverParams,
                    phase1_criterion, standard_criterion)

__all__ = [
    "barrier_solve", "primal_dual_solve", "barrier_solve_structured", "newton_minimize", "newton_minimize_eq",
    "FeasibilityReport", "InfeasibleProblemError", "feasibility_analysis",
    "find_feasible_point", "phase1_by_reduction", "phase1_simple",
    "phase1_soi", "phase1_with_eqs_as_ineqs", "NewtonResult", "OptState",
    "Solution", "SolverParams", "phase1_criterion", "standard_criterion",
]
