"""The hand diffusion3d step above ``diffusion3d.MAX_STEPS`` steps: the
wrapper runs ``nsteps`` as launches of at most MAX_STEPS steps each
(``diffusion3d.chunks``), an intermediate one with T's ring kept and the
last with T2's, which is the reference's k-step rule. On CPU tensors each
launch is the plain k-step version (``ref.diffusion3d_steps``), so the
chaining itself runs here.

Inputs come from a numpy seed. The chained result is bitwise the k single
steps (T2 a copy of T, so the rings agree), and the plain version's k-step
rule with T2 apart from T on the ring; against the JAX package's
``diffusion3d_step(nsteps=k)`` (Pallas, interpret mode) within rtol 1e-5 /
atol 1e-5, as tests/test_torch_kernels.py holds the single step (XLA may
contract a multiply and an add the port rounds on its own).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import diffusion3d as r_diffusion3d
from repro_torch.kernels import diffusion3d, ref

ARGS = (1.0, 1e-4, 8.0, 9.0, 12.0)


def _fields(rng, shape):
    return (torch.tensor(rng.rand(*shape).astype(np.float32)),
            torch.tensor((rng.rand(*shape) + 0.5).astype(np.float32)))


def test_chunks():
    assert diffusion3d.chunks(4) == [4]
    assert diffusion3d.chunks(5) == [4, 1]
    assert diffusion3d.chunks(8) == [4, 4]
    assert diffusion3d.chunks(9) == [4, 4, 1]
    assert sum(diffusion3d.chunks(11)) == 11
    assert max(diffusion3d.chunks(11)) <= diffusion3d.MAX_STEPS


@pytest.mark.parametrize("k", [5, 8, 9])
@pytest.mark.parametrize("alias", [False, True])
def test_chained_steps_equal_single_steps(k, alias, rng, monkeypatch):
    T, Ci = _fields(rng, (9, 10, 11))
    a, b = T.clone(), T.clone()
    for _ in range(k):
        a = diffusion3d.diffusion3d_step(a, b, Ci, *ARGS)
        a, b = b, a
    calls = []
    plain_steps = ref.diffusion3d_steps

    def counted(*args, **kw):
        calls.append(kw.get("nsteps", args[8] if len(args) > 8 else 1))
        return plain_steps(*args, **kw)

    monkeypatch.setattr(ref, "diffusion3d_steps", counted)
    T2 = T.clone()
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *ARGS, nsteps=k, alias=alias)
    assert calls == diffusion3d.chunks(k)
    assert torch.equal(got, b)
    assert (got.data_ptr() == T2.data_ptr()) == alias
    # the k-step ring rule: T2 apart from T on the ring
    T2 = torch.tensor(rng.rand(*T.shape).astype(np.float32))
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *ARGS, nsteps=k, alias=False)
    assert torch.equal(got, plain_steps(T2, T, Ci, *ARGS, nsteps=k))


@pytest.mark.parametrize("k", [5, 9])
def test_chained_steps_match_the_reference(k, rng):
    T, Ci = _fields(rng, (9, 10, 11))
    T2 = torch.tensor(rng.rand(*T.shape).astype(np.float32))
    got = diffusion3d.diffusion3d_step(T2, T, Ci, *ARGS, nsteps=k)
    want = r_diffusion3d.diffusion3d_step(jnp.asarray(T2.numpy()), jnp.asarray(T.numpy()),
                                          jnp.asarray(Ci.numpy()), *ARGS, nsteps=k,
                                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
