"""The reference's JAX functions compiled for the port's CPU tests.

``compiled`` compiles at XLA's lowest optimisation level and without the CPU
fusion emitters. Both settings only make the compile cheaper (about 2.5x on
a smoke model's ``value_and_grad``); the operations are the same f32 ones,
so the tests' tolerances hold as they are.
"""
import jax

OPTIONS = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with OPTIONS: call it with
    arguments of their shapes and dtypes."""
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTIONS)
