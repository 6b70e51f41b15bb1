"""The dense and VLM archs of the registry at their smoke size (the others
in ``tests/test_torch_train_families_other.py``): the port's training loss
and every gradient against the reference's ``jax.value_and_grad`` of its
``model.loss_fn`` with the chunked kernels, from the same weights and batch.

The port's weights (drawn by its own init, in the reference's tree) and a
training batch go to both. The reference runs at f32
(``RunConfig(param_dtype="float32", remat=False)``, ``impl="chunked"``), its
value_and_grad compiled as ``torch_jax_compile.compiled`` compiles it,
which only makes the compile cheaper; the port runs each kernel's plain version.

Tolerances (f32): the loss rtol 1e-5 / atol 1e-5; each gradient leaf rtol
1e-4 / atol 1e-5 x the leaf's largest |gradient| (two layers of matmuls,
the SSD and the softmax summed in other orders; measured within 2e-6 of
the largest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import RunConfig as RRunConfig, build as r_build
from repro_torch import configs, interop
from repro_torch.models import RunConfig, build, synth_batch
from repro_torch.optim import adamw

from torch_jax_compile import compiled

R_RC = RRunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                  loss_chunk=32, attn_q_chunk=32, attn_k_chunk=32)
T_RC = RunConfig(param_dtype="float32", remat=False, loss_chunk=32)


def _jnp(tree):
    """A tree of tensors as the reference's arrays (copies)."""
    return jax.tree.map(lambda t: jnp.array(t.detach().numpy().astype(
        np.int32 if t.dtype == torch.int64 else np.float32)), tree)


# --------------------------------------------------------------------------
# every arch: the loss and every gradient (the dense and VLM transformers
# here, the MoE, SSM, hybrid and enc-dec archs in
# tests/test_torch_train_families_other.py, each file under 40 s on a core)
# --------------------------------------------------------------------------
DENSE_ARCHS = [a for a in r_configs.ARCH_IDS if r_configs.get_smoke(a).family in ("dense", "vlm")]
OTHER_ARCHS = [a for a in r_configs.ARCH_IDS if a not in DENSE_ARCHS]


def check_loss_and_grads(arch):
    """The port's weights (drawn by its own init, the reference's tree) and
    a training batch go to both."""
    model = build(configs.get_smoke(arch), T_RC, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = synth_batch(model, torch.Generator().manual_seed(1), 32, 2, mode="train")
    r_model = r_build(r_configs.get_smoke(arch), R_RC)
    r_params, r_batch = _jnp(params), _jnp(batch)
    want_loss, want_grads = compiled(jax.value_and_grad(r_model.loss_fn), r_params,
                                     r_batch)(r_params, r_batch)
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    loss = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, adamw.leaves(params))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5, atol=1e-5)
    want = adamw.leaves(interop.params_from_numpy(jax.tree.map(np.asarray, want_grads),
                                                  device="cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale)


def test_the_two_files_cover_every_arch():
    assert DENSE_ARCHS and OTHER_ARCHS
    assert sorted(DENSE_ARCHS + OTHER_ARCHS) == sorted(configs.ARCH_IDS)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)
