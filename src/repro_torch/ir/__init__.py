"""Stencil IR: symbolic tracing of a math-close update into footprints and
the expression graphs the CUDA code generator lowers."""
from .bc import BoundaryCondition, normalize_bcs
from .cost import FlopCount, StencilCostModel, count_flops
from .reductions import Reduction, normalize_reductions
from .sym import SymArray, SymScalar, TraceError
from .trace import StencilIR, field_geometry, trace_stencil

__all__ = ["BoundaryCondition", "normalize_bcs", "FlopCount", "StencilCostModel", "count_flops",
           "Reduction", "normalize_reductions",
           "SymArray", "SymScalar", "TraceError", "StencilIR", "field_geometry",
           "trace_stencil"]
