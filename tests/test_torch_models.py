"""The port's models against the JAX package: the weight bridge, BN folding
and the forward of PGUNet1..4 (width 0.25, eval mode), unfolded and folded.

Inputs and weights come from numpy seeds and go through both packages.
Logits must agree to 1e-4: both sides sum in float32 (JAX at "highest"
matmul precision, see conftest.py) in different orders, which leaves
differences near 1e-6 at these sizes; 1e-4 leaves two decades of room
while a wrong tap, pad or channel order shows up at 1e-2 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugpg_tpu.io.torch_export import convert_variables_to_state_dict
from ugpg_tpu.models.folding import fold_batchnorm as jax_fold_batchnorm
from ugpg_tpu.models.pgunet import STAGE_MODELS as JAX_STAGE_MODELS
from ugpg_tpu.models.pgunet import STAGE_RESOLUTIONS
from ugpg_tpu.progressive.transfer import flatten_tree, unflatten_tree
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.pgunet import STAGE_BLOCKS, STAGE_MODELS

LOGIT_TOL = 1e-4


def jax_variables(stage: int, width: float = 1.0, seed: int = 0) -> dict:
    """Seeded variables of a JAX PGUNet stage with non-trivial BN stats.

    Conv kernels are He-scaled normals (std sqrt(2/fan_in)) so activations
    keep their scale through the ReLU stack and the logits spread around
    0 -- a test where every probability sits at one value would prove
    little.  Shapes come from ``jax.eval_shape``: nothing is compiled.
    """
    res = STAGE_RESOLUTIONS[stage]
    module = JAX_STAGE_MODELS[stage](num_classes=1, width=width)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, res, res, 3)), False))
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
        else:  # conv and BN biases
            v = 0.1 * g.standard_normal(s.shape)
        flat[path] = np.asarray(v, np.float32)
    return unflatten_tree(flat)


def _port_model(stage, state_dict, use_bn):
    model = STAGE_MODELS[stage](num_classes=1, use_bn=use_bn, width=0.25).eval()
    model.load_state_dict(state_dict, strict=True)
    return model


def _port_logits(model, x_nhwc):
    with torch.inference_mode():
        out = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_state_dict_from_jax_matches_export_table(stage):
    variables = jax_variables(stage, width=0.25, seed=stage)
    got = state_dict_from_jax(variables)
    want, skipped = convert_variables_to_state_dict(variables)
    assert skipped == []
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.from_numpy(np.asarray(value)).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    _port_model(stage, got, use_bn=True)  # strict load


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_blocks_name_every_child(stage):
    """STAGE_BLOCKS lists each stage model's blocks, as the JAX export names them."""
    names = [name for name, _ in STAGE_MODELS[stage](width=0.0).named_children()]
    assert list(STAGE_BLOCKS[stage]) == names
    exported, _ = convert_variables_to_state_dict(jax_variables(stage, width=0.25, seed=stage))
    assert {key.split(".", 1)[0] for key in exported} == set(names)


def test_state_dict_from_jax_rejects_unmapped_leaves():
    variables = jax_variables(1, width=0.25)
    variables["params"]["extra"] = {"dense": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_from_jax(variables)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_forward_parity_unfolded_and_folded(stage):
    res = STAGE_RESOLUTIONS[stage]
    variables = jax_variables(stage, width=0.25, seed=10 + stage)
    x = np.random.default_rng(stage).random((2, res, res, 3), dtype=np.float32)

    jax_module = JAX_STAGE_MODELS[stage](num_classes=1, width=0.25)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x), False))
    assert want.shape == (2, res, res, 1) and want.std() > 0.1
    sd = state_dict_from_jax(variables)
    got = _port_logits(_port_model(stage, sd, use_bn=True), x)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)

    # folding: the port's fold equals the JAX fold, leaf for leaf (same
    # float32 ops in the same order), and the folded forward -- which runs
    # the kernels' plain versions on the CPU -- equals the JAX folded one
    jax_folded = jax_fold_batchnorm(variables)
    folded = fold_batchnorm(sd)
    want_sd = {k: v for k, v in convert_variables_to_state_dict(jax_folded)[0].items()}
    assert set(folded) == set(want_sd)
    for key, value in want_sd.items():
        np.testing.assert_allclose(folded[key].numpy(), value, rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    jax_folded_module = JAX_STAGE_MODELS[stage](num_classes=1, width=0.25, use_bn=False)
    want_folded = np.asarray(jax_folded_module.apply(jax_folded, jnp.asarray(x), False))
    got_folded = _port_logits(_port_model(stage, folded, use_bn=False), x)
    np.testing.assert_allclose(got_folded, want_folded, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got_folded, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_bf16_body_keeps_float32_heads():
    model = STAGE_MODELS[4](num_classes=1, use_bn=False, width=0.25, dtype=torch.bfloat16)
    assert model.inc.conv.conv_op[0].weight.dtype == torch.bfloat16
    assert model.outc4.conv.weight.dtype == torch.float32
    x = torch.rand(1, 3, 256, 256)
    with torch.inference_mode():
        out = model(x)
    assert out.dtype == torch.float32 and out.shape == (1, 1, 256, 256)
    assert torch.isfinite(out).all()
