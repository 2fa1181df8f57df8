"""The port's classification train and eval steps against
``make_cls_train_step`` and ``make_cls_eval_step``, and the Herlev
augmentation against ``augment_herlev_batch``, on the CPU.

Stage 1 at 32 px and stage 2 at 64 px (the frozen stage 1 as the
uncertainty source), batch 4, ``normalize=True``, ``augment=False``, class
weights, dropout rates 0 (the masks cannot match JAX's bits), K = 7 and
K = 2, ``accum_steps`` 1 and 2 (at stage 1).

Tolerances, as ``tests/test_torch_train.py``: metrics rtol 1e-5 and BN
running stats 1e-5.  Gradients at stage 1 elementwise to rtol 1e-4 plus
1e-5 x the largest gradient (float32 sums in other orders).  At stage 2
each tensor's relative L2 gap to 5e-3: there JAX's BN takes the batch
variance as E[x^2] - E[x]^2 (flax's fast variance), which cancels in
float32 at these full widths (its encoder gradients sit up to 1.5e-4 x
max|g|, 0.3% in a tensor's norm, from a float64 evaluation of the same
step, the port's within 2e-7 x max|g|); the largest gap here is 2.9e-3
(K = 2) and a wrong loss or weighting is off by 10% or more.  The parameters after Adam's first step to 1e-6 (the step
is lr times the sign of the gradient it sees) wherever both sides'
gradients share a sign.  The augmentation replays JAX's key splits to
feed the port JAX's parameters; images 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables, port_classifier
from ugpg_tpu.data import augment as jax_augment
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.train.optim import torch_adam as jax_adam
from ugpg_tpu.train.steps import TrainState
from ugpg_tpu.train.steps import make_cls_eval_step as jax_eval_step
from ugpg_tpu.train.steps import make_cls_train_step as jax_train_step
from ugpg_tpu_torch.data import augment
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.train.optim import torch_adam
from ugpg_tpu_torch.train.steps import CLS_METRIC_KEYS, make_cls_eval_step, make_cls_train_step

RES = {1: 32, 2: 64}
LR = {1: 3e-4, 2: 1e-4}
WD = 1e-4
NO_DROPOUT = (0.0, 0.0, 0.0)


def _capture_grads():
    """An optax stage that keeps the raw gradients as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _batch(k, n=4, size=48, seed=0):
    rs = np.random.default_rng(seed)
    images = rs.random((n, size, size, 3)).astype(np.float32)
    labels = rs.integers(0, k, n)
    cw = (rs.random(k) + 0.5).astype(np.float32)
    return images, labels, cw


def _jax_module(stage, k):
    return JaxClassifier(stage=stage, num_classes=k, dropout_rates=NO_DROPOUT)


def _run_both(stage, k, accum_steps=1):
    v_prev = jax_cls_variables(1, k, seed=1, dropout_rates=NO_DROPOUT)
    v = v_prev if stage == 1 else jax_cls_variables(2, k, seed=2, dropout_rates=NO_DROPOUT)
    images, labels, cw = _batch(k, seed=stage + k)
    tx = optax.chain(_capture_grads(), jax_adam(LR[stage], weight_decay=WD))
    step = jax_train_step(_jax_module(stage, k), tx, stage, RES[stage], k,
                          prev_module=_jax_module(1, k) if stage > 1 else None,
                          prev_resolution=RES[1], donate=False, normalize=True,
                          accum_steps=accum_steps)
    new, jm = step(TrainState.create(v, tx), v_prev if stage > 1 else {},
                   (jnp.asarray(images), jnp.asarray(labels)), jnp.asarray(cw),
                   jax.random.key(0))

    model = port_classifier(stage, v, k, dropout_rates=NO_DROPOUT)
    prev = port_classifier(1, v_prev, k) if stage > 1 else None
    opt = torch_adam(model.parameters(), LR[stage], weight_decay=WD)
    port_step = make_cls_train_step(model, opt, stage, RES[stage], k, prev_model=prev,
                                    prev_resolution=RES[1], normalize=True,
                                    accum_steps=accum_steps)
    tm = port_step((images, labels), torch.from_numpy(cw))
    return v, jax.device_get((new, jm)), model, tm


def _assert_metrics(tm, jm):
    assert set(tm) == set(CLS_METRIC_KEYS) <= set(jm)
    for key in CLS_METRIC_KEYS:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)


@pytest.mark.parametrize("stage,k,accum_steps", [(1, 7, 1), (1, 2, 1), (2, 7, 1), (2, 2, 1),
                                                 (1, 7, 2)])
def test_cls_train_step_matches_jax(stage, k, accum_steps):
    v, (new, jm), model, tm = _run_both(stage, k, accum_steps)
    _assert_metrics(tm, jm)
    assert int(tm["count"]) == 4
    if stage > 1:
        assert float(tm["uncertainty_weight_mean"]) > 1.0
        assert float(jm["uncertainty_weight_std"]) > 0

    before = state_dict_from_jax(v)
    after = state_dict_from_jax(new.variables)
    grads = state_dict_from_jax({"params": new.opt_state[0]})
    gmax = max(g.abs().max().item() for g in grads.values())
    kept = total = 0
    for name, p in model.named_parameters():
        g, a = grads[name].numpy(), p.grad.numpy()
        if name.endswith(("conv_op.0.bias", "conv_op.3.bias")):  # before BN: truly 0
            np.testing.assert_allclose(a, g, rtol=0, atol=1e-5 * gmax, err_msg=name)
        elif stage == 1:
            np.testing.assert_allclose(a, g, rtol=1e-4, atol=1e-5 * gmax, err_msg=name)
        else:
            rel = np.linalg.norm(a - g) / np.linalg.norm(g)
            assert rel <= 5e-3, (name, rel)
        # Adam's first step is lr x x / (|x| + 1e-8), x = g + wd p: equal to
        # 1e-6 wherever both sides' x share a sign and |x| > 1e-6 (below it
        # the step follows |x|; 1-2% of the weights here)
        x_jax, x_port = (t + WD * before[name].numpy() for t in (g, a))
        keep = (np.sign(x_jax) == np.sign(x_port)) & (np.minimum(abs(x_jax), abs(x_port)) > 1e-6)
        kept, total = kept + keep.sum(), total + keep.size
        np.testing.assert_allclose(p.detach().numpy()[keep], after[name].numpy()[keep],
                                   rtol=0, atol=1e-6, err_msg=name)
    assert kept > 0.97 * total, kept / total
    state = model.state_dict()
    for key in after:
        if "running" in key:
            np.testing.assert_allclose(state[key].numpy(), after[key].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("k", [7, 2])
def test_cls_eval_step_matches_jax(k):
    v_prev = jax_cls_variables(1, k, seed=3)
    v = jax_cls_variables(2, k, seed=4)
    images, labels, cw = _batch(k, seed=5)
    jm = jax.device_get(jax_eval_step(JaxClassifier(stage=2, num_classes=k), 2, RES[2], k,
                                      prev_module=JaxClassifier(stage=1, num_classes=k),
                                      prev_resolution=RES[1], normalize=True)(
        v, v_prev, (jnp.asarray(images), jnp.asarray(labels)), jnp.asarray(cw)))
    model, prev = port_classifier(2, v, k), port_classifier(1, v_prev, k)
    tm = make_cls_eval_step(model, 2, RES[2], k, prev_model=prev, prev_resolution=RES[1],
                            normalize=True)((images, labels), torch.from_numpy(cw))
    _assert_metrics(tm, jm)
    assert not model.training
    for key, value in state_dict_from_jax(v).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_cls_step_refusals():
    model = port_classifier(1, jax_cls_variables(1, 3, seed=6), 3)
    opt = torch_adam(model.parameters(), 1e-4)
    images, labels, _ = _batch(3)
    # external_uncertainty (ported since) takes the weights as unc=, of one per sample
    step2 = make_cls_train_step(port_classifier(2, jax_cls_variables(2, 3, seed=7), 3), opt, 2,
                                32, 3, external_uncertainty=True)
    with pytest.raises(ValueError, match="pass unc"):
        step2((images, labels))
    with pytest.raises(ValueError, match="4 rows"):
        step2((images, labels), unc=torch.ones(3))
    with pytest.raises(ValueError, match="divisible"):
        make_cls_train_step(model, opt, 1, 32, 3, accum_steps=3)((images, labels))
    with pytest.raises(ValueError, match="generator"):
        make_cls_train_step(model, opt, 1, 32, 3, augment=True)((images, labels))


# ---------------------------------------------------------------- the augmentation
def _jax_herlev_params(key, b, h, w):
    """The parameters ``augment_herlev_batch(key, ...)`` draws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kh, kv = jax.random.split(k1)
    p = {"do_h": jax.random.bernoulli(kh, 0.5, (b,)), "do_v": jax.random.bernoulli(kv, 0.5, (b,)),
         "angle": jax.random.uniform(k2, (b,), minval=-15.0, maxval=15.0)}
    kb, kc, ks, khue, _ = jax.random.split(k3, 5)
    for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
        p[name] = 1.0 + jax.random.uniform(k, (b, 1, 1, 1), minval=-0.2, maxval=0.2)
    p["hue"] = jax.random.uniform(khue, (b, 1, 1), minval=-0.1, maxval=0.1)
    _, kt, kscale = jax.random.split(k4, 3)
    out = {k: torch.from_numpy(np.array(v).reshape(b)) for k, v in p.items()}
    out["apply"] = torch.ones(b, dtype=torch.bool)
    t = jax.random.uniform(kt, (b, 2), minval=-0.1, maxval=0.1) * jnp.array([w, h])
    out["translate"] = torch.from_numpy(np.array(t))
    out["scale"] = torch.from_numpy(np.array(
        jax.random.uniform(kscale, (b,), minval=0.9, maxval=1.1)))
    return out


@pytest.mark.parametrize("seed,h,w", [(0, 24, 24), (1, 20, 28), (2, 32, 32)])
def test_herlev_augmentation_matches_jax(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w] / max(h, w)
    images = np.stack([np.stack([0.5 + 0.4 * np.sin(5 * xx + i + c) * np.cos(4 * yy - c)
                                 for c in range(3)], -1) for i in range(4)])
    images = np.clip(images + rng.normal(0, 0.05, images.shape), 0, 1).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jax_augment.augment_herlev_batch(key, jnp.asarray(images)))
    params = _jax_herlev_params(key, 4, h, w)
    got = augment.apply_herlev_params(torch.from_numpy(images).permute(0, 3, 1, 2), params)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)
    # the port's own draw has the same ranges
    drawn = augment.sample_herlev_params(torch.Generator().manual_seed(seed), 64, h, w)
    assert set(drawn) == set(params) and bool(drawn["apply"].all())
    assert drawn["angle"].abs().max() <= 15 and drawn["hue"].abs().max() <= 0.1
    assert drawn["scale"].min() >= 0.9 and drawn["scale"].max() <= 1.1
    assert (drawn["translate"].abs() <= 0.1 * torch.tensor([w, h]) + 1e-6).all()
    normalized = augment.imagenet_normalize(got)
    want_norm = np.asarray(jax_augment.imagenet_normalize(jnp.asarray(want)))
    np.testing.assert_allclose(normalized.permute(0, 2, 3, 1).numpy(), want_norm, atol=1e-5)
