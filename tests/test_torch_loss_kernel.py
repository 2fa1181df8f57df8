"""The port's uncertainty-weighted BCE Function against the JAX package's
Pallas ``uncertainty_weighted_bce`` (interpret mode off-TPU).

On the CPU the Function's forward and backward take their plain versions
(the CUDA kernels run only on the card: tests/test_torch_cuda.py), so this
holds the Function's plumbing (broadcast, saved tensors, the gradient to
the logits only) and its arithmetic against JAX.  Tolerances are the JAX
tests' own (tests/test_pallas_kernels.py): loss rtol 1e-5, gradient rtol
1e-4 / atol 1e-7, since both sides compute in float32 and sum in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.ops.pallas.uncertainty_fused import uncertainty_weighted_bce as jax_loss
from ugpg_tpu_torch.ops.cuda.uncertainty_bce import (
    uncertainty_weighted_bce,
    uncertainty_weighted_bce_backward,
    uncertainty_weighted_bce_backward_reference,
    uncertainty_weighted_bce_forward,
    uncertainty_weighted_bce_reference,
)

PW = 5.0


def _data(shape, seed=0):
    rs = np.random.default_rng(seed)
    x = (rs.standard_normal(shape) * 3).astype(np.float32)
    z = (rs.random(shape) > 0.6).astype(np.float32)
    p = rs.random(shape).astype(np.float32)
    return x, z, p


@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("shape", [(4, 32, 32, 1), (2, 17, 19, 1), (3, 33, 65, 2)])
def test_function_matches_pallas_loss_and_gradient(shape, alpha):
    x, z, p = _data(shape, seed=sum(shape))
    want_final, want_base = jax_loss(jnp.asarray(x), jnp.asarray(z), jnp.asarray(p), PW, alpha)
    want_dx = jax.grad(lambda xx: jax_loss(xx, jnp.asarray(z), jnp.asarray(p), PW, alpha)[0])(
        jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    final, base = uncertainty_weighted_bce(xt, torch.from_numpy(z), torch.from_numpy(p), PW, alpha)
    final.backward()
    np.testing.assert_allclose(final.item(), float(want_final), rtol=1e-5)
    np.testing.assert_allclose(base.item(), float(want_base), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-7)


def test_closed_form_backward_equals_autograd_of_the_plain_forward():
    x, z, p = (torch.from_numpy(a) for a in _data((3, 33, 65, 2), seed=1))
    x.requires_grad_()
    g = torch.tensor(1.7)
    final, _ = uncertainty_weighted_bce_reference(x, z, p, PW, 2.0)
    (final * g).backward()
    got = uncertainty_weighted_bce_backward_reference(x.detach(), z, p, PW, 2.0, g)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-4, atol=1e-9)


def test_gradient_flows_to_the_logits_only_and_p_broadcasts():
    x, z, p = (torch.from_numpy(a) for a in _data((2, 8, 8, 1), seed=2))
    x.requires_grad_()
    z.requires_grad_()
    p_row = p[:1].clone().requires_grad_()  # (1, 8, 8, 1) broadcasts over the batch
    final, base = uncertainty_weighted_bce(x, z, p_row, PW, 1.0)
    assert final.requires_grad and not base.requires_grad
    final.backward()
    assert x.grad is not None and z.grad is None and p_row.grad is None
    want, _ = uncertainty_weighted_bce_reference(x.detach(), z, p_row.detach().expand_as(x), PW, 1.0)
    np.testing.assert_allclose(final.item(), want.item(), rtol=1e-6)
    # base alone is monitoring: nothing to differentiate
    with pytest.raises(RuntimeError):
        base.backward()


def test_function_refuses_other_dtypes_and_shapes():
    x, z, p = (torch.from_numpy(a) for a in _data((2, 4, 4, 1)))
    with pytest.raises(TypeError, match="float32"):
        uncertainty_weighted_bce(x.double(), z.double(), p.double(), PW, 1.0)
    with pytest.raises(ValueError, match="shapes differ"):
        uncertainty_weighted_bce(x, z[:1], p, PW, 1.0)


def _against_jax(x, z, p_port, p_jax, alpha):
    """The Function with ``p_port`` against the JAX loss with ``p_jax``, at
    the file's tolerances."""
    want_final, want_base = jax_loss(jnp.asarray(x), jnp.asarray(z), jnp.asarray(p_jax), PW, alpha)
    want_dx = jax.grad(lambda xx: jax_loss(xx, jnp.asarray(z), jnp.asarray(p_jax), PW, alpha)[0])(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    final, base = uncertainty_weighted_bce(xt, torch.from_numpy(z), p_port, PW, alpha)
    final.backward()
    np.testing.assert_allclose(final.item(), float(want_final), rtol=1e-5)
    np.testing.assert_allclose(base.item(), float(want_base), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("shape", [(4, 32, 32, 1), (2, 17, 19, 1), (3, 33, 65, 2)])
def test_zero_dim_p_at_alpha_zero_matches_pallas_with_a_full_half_map(shape):
    # stage 1 of the train step: alpha = 0 and a 0-d p, which the port
    # neither expands nor reads; JAX gets the full map of 0.5
    x, z, _ = _data(shape, seed=3 + sum(shape))
    _against_jax(x, z, torch.tensor(0.5), np.full_like(x, 0.5), 0.0)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
@pytest.mark.parametrize("p_shape", [(1, 32, 32, 1), (4, 1, 1, 1), (32, 32, 1), (1, 1, 32, 1)])
def test_broadcast_p_matches_pallas_fed_the_same_p(p_shape, alpha):
    x, z, _ = _data((4, 32, 32, 1), seed=5)
    p = np.random.default_rng(len(p_shape) + p_shape[0]).random(p_shape).astype(np.float32)
    _against_jax(x, z, torch.from_numpy(p), p, alpha)  # jax_loss broadcasts p itself


@pytest.mark.parametrize("alpha", [0.0, 1.0])
@pytest.mark.parametrize("p_shape", [(2, 4, 4), (3, 4, 4, 1), (1, 2, 4, 4, 1), (5,)])
def test_function_refuses_a_p_that_does_not_broadcast(p_shape, alpha):
    x, z, _ = (torch.from_numpy(a) for a in _data((2, 4, 4, 1)))
    with pytest.raises(ValueError, match="does not broadcast"):
        uncertainty_weighted_bce(x, z, torch.rand(p_shape), PW, alpha)
    with pytest.raises(ValueError, match="does not broadcast"):
        uncertainty_weighted_bce_forward(x, z, torch.rand(p_shape), PW, alpha)
    with pytest.raises(ValueError, match="does not broadcast"):
        uncertainty_weighted_bce_backward(x, z, torch.rand(p_shape), PW, alpha, torch.tensor(1.0))


def test_alpha_zero_keeps_p_as_given_and_weight_one():
    # the kernels read no p at alpha = 0: the Function saves the 0-d p as it
    # came, and its loss and gradient equal those of a full map of 0.5
    x, z, _ = (torch.from_numpy(a) for a in _data((2, 8, 8, 1), seed=4))
    p0 = torch.tensor(0.5)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    fa, ba = uncertainty_weighted_bce(xa, z, p0, PW, 0.0)
    fb, bb = uncertainty_weighted_bce(xb, z, torch.full_like(x, 0.5), PW, 0.0)
    assert fa.grad_fn.saved_tensors[2].shape == ()
    fa.backward()
    fb.backward()
    assert torch.equal(fa, fb) and torch.equal(ba, bb) and torch.equal(fa, ba)
    assert torch.equal(xa.grad, xb.grad)
