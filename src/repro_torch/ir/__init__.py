"""Stencil IR: symbolic tracing of a math-close update into footprints and
the expression graphs the CUDA code generator lowers."""
from .reductions import Reduction, normalize_reductions
from .sym import SymArray, SymScalar, TraceError
from .trace import StencilIR, trace_stencil

__all__ = ["Reduction", "normalize_reductions", "SymArray", "SymScalar",
           "TraceError", "StencilIR", "trace_stencil"]
