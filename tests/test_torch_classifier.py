"""The port's Herlev classifier against the JAX package: the CE losses, the
classification uncertainty, the metrics, the model at stages 1-4 (live BN
and BN-folded), its reference ``.pth`` in both directions, dropout, the
optimizer parts (Adam, freezing, the plateau scheduler) and
``ProgressiveUNet(task_type="classification")``.

Weights are numpy-seeded JAX trees carried across by ``state_dict_from_jax``.
Tolerances: pointwise functions and metrics 1e-6 (float32 on both sides);
logits 1e-4, as in ``tests/test_torch_models.py`` (float32 sums in other
orders leave about 1e-6; a wrong tap or channel order shows at 1e-2).
Stage 4 runs on 32 px inputs: the encoder is fully convolutional, and
224 px would only cost time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ugpg_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.io.torch_export import export_torch_checkpoint
from ugpg_tpu.io.torch_import import import_torch_checkpoint
from ugpg_tpu.metrics import classification as jax_metrics
from ugpg_tpu.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.models.progressive import ProgressiveUNet as JaxProgressiveUNet
from ugpg_tpu.ops.losses import softmax_cross_entropy as jax_ce
from ugpg_tpu.ops.losses import weighted_cross_entropy_mean as jax_wce
from ugpg_tpu.progressive.transfer import flatten_tree, unflatten_tree
from ugpg_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from ugpg_tpu.train.optim import freeze_subtrees as jax_freeze
from ugpg_tpu.train.optim import get_learning_rate as jax_get_lr
from ugpg_tpu.train.optim import torch_adam as jax_adam
from ugpg_tpu.uncertainty import classification_uncertainty_weights as jax_cls_weights
from ugpg_tpu.uncertainty import entropy_uncertainty as jax_entropy
from ugpg_tpu.uncertainty import mc_dropout_uncertainty as jax_mc_dropout
from ugpg_tpu_torch.io.checkpoint import (
    classifier_state_dict,
    full_classifier_state_dict,
    load_checkpoint,
    save_checkpoint,
)
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.metrics import classification as metrics
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel, dropout
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.progressive import ProgressiveUNet
from ugpg_tpu_torch.ops.losses import softmax_cross_entropy, weighted_cross_entropy_mean
from ugpg_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    freeze_subtrees,
    get_learning_rate,
    torch_adam,
)
from ugpg_tpu_torch.uncertainty import (
    classification_uncertainty_weights,
    entropy_uncertainty,
    mc_dropout_uncertainty,
)

LOGIT_TOL = 1e-4
TEST_PX = {1: 32, 2: 32, 3: 32, 4: 32}  # inputs per stage: 32 px reaches down3 at 4 px


def jax_cls_variables(stage: int, num_classes: int = 7, seed: int = 0,
                      dropout_rates=(0.5, 0.3, 0.2)) -> dict:
    """Seeded variables of a JAX Herlev classifier: He-scaled conv and
    dense kernels (the logits spread around 0), non-trivial BN stats.
    Shapes from ``jax.eval_shape``: nothing is compiled."""
    module = JaxClassifier(stage=stage, num_classes=num_classes, dropout_rates=dropout_rates)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), False))
    g = np.random.default_rng(seed)
    flat = {}
    for path, s in flatten_tree(shapes).items():
        coll, leaf = path[0], path[-1]
        if coll == "batch_stats":
            v = 0.1 * g.standard_normal(s.shape) if leaf == "mean" else 1 + 0.2 * g.random(s.shape)
        elif leaf == "kernel":
            v = g.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.1 * g.standard_normal(s.shape)
        else:
            v = 0.1 * g.standard_normal(s.shape)
        flat[path] = np.asarray(v, np.float32)
    return unflatten_tree(flat)


def port_classifier(stage, variables, num_classes=7, use_bn=True, **kwargs):
    model = HerlevClassificationModel(stage, num_classes, use_bn=use_bn, **kwargs)
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd if use_bn else fold_batchnorm(sd), strict=True)
    return model.eval()


def nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _images(n, px, seed):
    return np.random.default_rng(seed).random((n, px, px, 3)).astype(np.float32)


# ---------------------------------------------------------------- losses, uncertainty
def _logits_labels(k, seed=0, n=6):
    rs = np.random.default_rng(seed)
    logits = (rs.standard_normal((n, k)) * 3).astype(np.float32)
    labels = rs.integers(0, k, n)
    return logits, labels


@pytest.mark.parametrize("k", [7, 2])
def test_cross_entropy_losses_match_jax(k):
    logits, labels = _logits_labels(k)
    labels[:] = np.where(labels == 1, 0, labels)  # a batch that lacks class 1
    cw = np.random.default_rng(1).random(k).astype(np.float32) + 0.5
    t_logits, t_labels = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(softmax_cross_entropy(t_logits, t_labels).numpy(),
                               np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6, atol=1e-6)
    for w in (None, cw):
        got = weighted_cross_entropy_mean(t_logits, t_labels,
                                          None if w is None else torch.from_numpy(w))
        want = jax_wce(jnp.asarray(logits), jnp.asarray(labels), None if w is None else w)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    # torch's own CrossEntropyLoss(weight=w) semantics
    want = torch.nn.CrossEntropyLoss(weight=torch.from_numpy(cw))(t_logits, t_labels)
    np.testing.assert_allclose(weighted_cross_entropy_mean(t_logits, t_labels,
                                                           torch.from_numpy(cw)).item(),
                               want.item(), rtol=1e-6)


@pytest.mark.parametrize("k", [7, 2])
def test_classification_uncertainty_matches_jax(k):
    logits, _ = _logits_labels(k, seed=2)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    np.testing.assert_allclose(entropy_uncertainty(probs, k).numpy(),
                               np.asarray(jax_entropy(jnp.asarray(probs.numpy()), k)),
                               rtol=1e-6, atol=1e-6)
    for alpha in (1.0, 2.5):
        got = classification_uncertainty_weights(torch.from_numpy(logits), k, alpha)
        want = jax_cls_weights(jnp.asarray(logits), k, alpha)
        assert got.shape == (len(logits),)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mc_dropout_uncertainty_matches_jax():
    logits, _ = _logits_labels(7, seed=3, n=4)
    x = jnp.zeros((4, 1))
    mean, var = jax_mc_dropout(lambda xx, rngs: jnp.asarray(logits), x, jax.random.key(0),
                               num_samples=4, task_type="classification")
    g = torch.Generator().manual_seed(0)
    tmean, tvar = mc_dropout_uncertainty(lambda xx, gen: torch.from_numpy(logits),
                                         torch.zeros(4, 1), g, num_samples=4,
                                         task_type="classification")
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), rtol=1e-6, atol=1e-7)
    assert tvar.shape == (4,) and torch.all(tvar == 0) and np.all(np.asarray(var) == 0)
    # outputs that vary by sample: logits plus noise from each pass's key,
    # the same four draws fed to the port in JAX's order
    key = jax.random.key(1)

    def noisy(xx, rngs):
        return jnp.asarray(logits) + 2.0 * jax.random.normal(rngs["dropout"], logits.shape)

    mean, var = jax_mc_dropout(noisy, x, key, num_samples=4, task_type="classification")
    draws = iter([np.array(noisy(x, {"dropout": k})) for k in jax.random.split(key, 4)])
    tmean, tvar = mc_dropout_uncertainty(lambda xx, gen: torch.from_numpy(next(draws)),
                                         torch.zeros(4, 1), g, num_samples=4,
                                         task_type="classification")
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(var), rtol=1e-5, atol=1e-8)
    assert tvar.shape == (4,) and torch.all(tvar > 0) and tvar.max() > 1e-2


# ---------------------------------------------------------------- metrics
def test_classification_metrics_match_jax():
    rs = np.random.default_rng(5)
    y_true = rs.integers(0, 7, 40)
    y_true[y_true == 4] = 3  # class 4 absent: zero support
    y_pred = np.where(rs.random(40) < 0.6, y_true, rs.integers(0, 7, 40))
    probs = rs.random((40, 7))
    probs[:, 2] = np.round(probs[:, 2], 1)  # ties in the rank statistic
    names = [f"c{i}" for i in range(7)]
    np.testing.assert_array_equal(metrics.confusion_matrix(y_true, y_pred, 7),
                                  jax_metrics.confusion_matrix(y_true, y_pred, 7))
    assert (metrics.classification_report(y_true, y_pred, 7, names)
            == jax_metrics.classification_report(y_true, y_pred, 7, names))
    np.testing.assert_allclose(metrics.per_class_accuracy(y_true, y_pred, 7),
                               jax_metrics.per_class_accuracy(y_true, y_pred, 7), rtol=1e-6)
    scores = np.round(rs.random(40), 1)  # binary, with ties
    binary = (y_true > 3).astype(np.int64)
    np.testing.assert_allclose(metrics.roc_auc(binary, scores),
                               jax_metrics.roc_auc(binary, scores), rtol=1e-6)
    np.testing.assert_allclose(metrics.macro_roc_auc_ovr(y_true, probs),
                               jax_metrics.macro_roc_auc_ovr(y_true, probs), rtol=1e-6)
    assert np.isnan(metrics.roc_auc(np.zeros(4), np.arange(4.0)))


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_classifier_matches_jax_live_and_folded(stage):
    v = jax_cls_variables(stage, seed=stage)
    x = _images(2, TEST_PX[stage], seed=stage)
    want = np.asarray(JaxClassifier(stage=stage, num_classes=7).apply(v, jnp.asarray(x), False))
    assert want.std() > 0.1
    with torch.no_grad():
        live = port_classifier(stage, v)(nchw(x)).numpy()
        folded = port_classifier(stage, v, use_bn=False)(nchw(x)).numpy()
    np.testing.assert_allclose(live, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(folded, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_state_dict_names_are_the_references():
    names = set(HerlevClassificationModel(4, 7).state_dict())
    assert {"classifier.3.weight", "classifier.6.bias", "classifier.9.weight",
            "unet.inc.conv.conv_op.0.weight", "unet.inc.conv.conv_op.4.running_var",
            "unet.down3.mpconv.1.conv_op.3.weight"} <= names
    assert not any(k.startswith(("unet.down4", "unet.up", "unet.outc")) for k in names)
    assert HerlevClassificationModel(4, 7).classifier[9].weight.shape == (7, 256)
    for stage in (1, 2, 3):
        blocks = {k.split(".")[1] for k in HerlevClassificationModel(stage).state_dict()
                  if k.startswith("unet.")}
        assert blocks == {"inc", "down1", "down2", "down3"}.intersection(
            {"inc"} | {f"down{i}" for i in range(5 - stage, 4)}), (stage, blocks)


def test_reference_pth_both_ways(tmp_path):
    """A .pth from ugpg_tpu's classification export loads in the port, a
    port-written one in ugpg_tpu, and both give equal logits."""
    stage = 2
    v = jax_cls_variables(stage, seed=11)
    x = _images(2, 64, seed=11)
    jax_save_checkpoint(tmp_path / "jax_ckpt", v, metadata={"stage": stage, "epoch": 3})
    export_torch_checkpoint(str(tmp_path / "jax_ckpt"), str(tmp_path / "from_jax.pth"),
                            task_type="classification")
    got_stage, sd = load_checkpoint(tmp_path / "from_jax.pth")
    assert got_stage == stage and any(k.startswith("unet.up1.") for k in sd)
    model = HerlevClassificationModel(stage, 7)
    model.load_state_dict(classifier_state_dict(sd, stage), strict=True)
    want = np.asarray(JaxClassifier(stage=stage, num_classes=7).apply(v, jnp.asarray(x), False))
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(nchw(x)).numpy(), want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)

    # the port writes the reference's full key set ...
    full = full_classifier_state_dict(model.state_dict(), stage)
    assert set(full) == set(sd)
    for key, value in model.state_dict().items():
        assert torch.equal(full[key], value), key
    save_checkpoint(tmp_path / "port.pth", full, stage=stage, epoch=1,
                    config={"num_classes": 7})
    # ... which ugpg_tpu's importer and loader take
    variables, jstage = import_torch_checkpoint(str(tmp_path / "port.pth"), num_classes=7,
                                                task_type="classification",
                                                output_dir=str(tmp_path / "imported"))
    loaded, _, meta = jax_load_checkpoint(tmp_path / "imported")
    assert jstage == stage and meta["stage"] == stage
    for tree in (variables, loaded):
        got = np.asarray(JaxClassifier(stage=stage, num_classes=7).apply(tree, jnp.asarray(x),
                                                                          False))
        np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)

    # the decoder keys alone are dropped: anything else still fails a strict load
    bad = dict(sd)
    bad["unet.down3.extra"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected"):
        model.load_state_dict(classifier_state_dict(bad, stage), strict=True)
    missing = {k: t for k, t in sd.items() if not k.startswith("classifier.9")}
    with pytest.raises(RuntimeError, match="Missing"):
        model.load_state_dict(classifier_state_dict(missing, stage), strict=True)


def test_dropout_semantics():
    h = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    for p in (0.5, 0.3, 0.2):
        out = dropout(h, p, g)
        kept = out != 0
        assert abs(kept.float().mean().item() - (1 - p)) < 0.01
        np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - p), rtol=1e-6)
    assert dropout(h, 0.0, g) is h
    # train mode and mc_dropout draw masks; eval does not
    model = port_classifier(1, jax_cls_variables(1, seed=5))
    x = nchw(_images(2, 32, seed=5))
    with torch.no_grad():
        a = model(x)
        assert torch.equal(model(x), a)
        g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        m1, m2 = model(x, mc_dropout=True, generator=g1), model(x, mc_dropout=True, generator=g2)
        assert torch.equal(m1, m2) and not torch.allclose(m1, a)
        model.dropout_rates = (0.0, 0.0, 0.0)
        assert torch.equal(model(x, mc_dropout=True, generator=g1), a)


# ---------------------------------------------------------------- the optimizer
def test_adam_freeze_and_plateau_match_jax():
    rs = np.random.default_rng(6)
    params = {"unet": {"w": rs.standard_normal((3, 4)).astype(np.float32)},
              "fc1": {"kernel": rs.standard_normal((4, 5)).astype(np.float32),
                      "bias": rs.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda a: rs.standard_normal(a.shape).astype(np.float32), params)
             for _ in range(5)]
    for frozen in (False, True):
        tx = jax_adam(1e-3, weight_decay=1e-4)
        if frozen:
            tx = jax_freeze(tx, ("unet",))
        jp = jax.tree.map(jnp.asarray, params)
        state = tx.init(jp)

        class Net(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.unet = torch.nn.ParameterDict(
                    {"w": torch.nn.Parameter(torch.from_numpy(params["unet"]["w"].copy()))})
                self.fc1 = torch.nn.ParameterDict(
                    {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                     for k, v in params["fc1"].items()})

        net = Net()
        trainable = freeze_subtrees(net, ("unet",)) if frozen else list(net.parameters())
        opt = torch_adam(trainable, 1e-3, weight_decay=1e-4)
        for g in grads:
            updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, updates)
            for name, p in net.named_parameters():
                if p.requires_grad:
                    root, leaf = name.split(".")
                    p.grad = torch.from_numpy(g[root][leaf])
            opt.step()
        for name, p in net.named_parameters():
            root, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[root][leaf]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        w = net.unet["w"]
        if frozen:  # unchanged, and no optimizer state
            assert torch.equal(w.detach(), torch.from_numpy(params["unet"]["w"]))
            assert not w.requires_grad and w not in opt.state
        else:
            assert w.requires_grad and opt.state[w]["exp_avg"].abs().sum() > 0

    # the plateau: the lr halves after patience + 1 bad epochs
    jsched, sched = JaxPlateau(factor=0.5, patience=5), ReduceLROnPlateau(factor=0.5, patience=5)
    jstate = jax_adam(1e-3).init({"a": jnp.zeros(2)})
    opt = torch_adam([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    losses = [1.0, 0.9, 0.9, 0.95, 0.91, 0.92, 0.93, 0.9, 0.8, 0.85] + [0.85] * 6
    lrs = []
    for loss in losses:
        jstate = jsched.step(loss, jstate)
        sched.step(loss, opt)
        lrs.append(get_learning_rate(opt))
        np.testing.assert_allclose(lrs[-1], jax_get_lr(jstate), rtol=1e-6)
        assert (sched.best, sched.num_bad_epochs) == (jsched.best, jsched.num_bad_epochs)
    assert lrs[6] == 1e-3 and lrs[7] == 5e-4 and lrs[-1] == 2.5e-4  # the 6th bad epoch


# ---------------------------------------------------------------- ProgressiveUNet
def test_progressive_unet_classification_matches_jax():
    v = jax_cls_variables(4, num_classes=3, seed=8)
    x = _images(1, 40, seed=8)
    jm = JaxProgressiveUNet(num_classes=3, stage=4, task_type="classification")
    assert jm.get_current_resolution() == 224
    want = np.asarray(jm.apply(v, jnp.asarray(x), target_resolution=48))
    m = ProgressiveUNet(num_classes=3, stage=4, task_type="classification").eval()
    assert m.get_current_resolution() == CLS_STAGE_RESOLUTIONS[4] == 224
    m.module(4).load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = m(nchw(x), target_resolution=48).numpy()
    assert got.shape == (1, 3)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert isinstance(m.module(1), HerlevClassificationModel)
