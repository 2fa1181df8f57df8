"""The port's spatially sharded inference (``ugpg_tpu_torch/parallel/spatial.py``)
against the JAX package's ``parallel/spatial.py``, on the CPU.

Weights: seeded JAX variables at width 0.25 with non-trivial BN stats
(``tests/test_torch_models.py::jax_variables``' recipe), carried over with the
port's ``io/from_jax.py``.  JAX runs its shard_map program on 2, 4 or 8 of
the 8 fake CPU devices of ``tests/conftest.py``; the port runs the same
grid with the CPU at every position (one process drives the mesh).

Tolerances: logits and maps 1e-4, JAX's own (``tests/test_spatial.py``):
both sides are float32, the port on BN-folded weights and the JAX package
with live BN, summed in other orders.  Against the port's own unsharded
forward on the same padded image, 1e-5.  bf16 against float32: 0.15, as
in the JAX package's test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ugpg_tpu.models.pgunet import STAGE_MODELS as JAX_STAGE_MODELS
from ugpg_tpu.parallel.spatial import _axis_resize_bands as jax_axis_resize_bands
from ugpg_tpu.parallel.spatial import spatial_predict as jax_spatial_predict
from ugpg_tpu.parallel.spatial import spatial_stage_infer as jax_spatial_stage_infer
from ugpg_tpu_torch.eval.slide import native_forward
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.folding import fold_batchnorm
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.parallel import spatial
from ugpg_tpu_torch.parallel.mesh import make_mesh
from ugpg_tpu_torch.parallel.spatial import (
    SpatialWeights,
    make_spatial_infer,
    pad_to_divisible,
    spatial_divisor,
    spatial_predict,
    spatial_stage_infer,
)

TOL = 1e-4
CPU = torch.device("cpu")
WIDTH = 0.25


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(n_h, n_w=1):
    """(JAX mesh over the fake CPU devices, port mesh over the CPU), axes
    ("data", "model")."""
    jm = JaxMesh(np.asarray(jax.devices()[:n_h * n_w]).reshape(n_h, n_w), ("data", "model"))
    return jm, make_mesh(n_h, n_w, devices=[CPU] * (n_h * n_w))


def variables(stage, num_classes=1, seed=0):
    """(JAX variables at width 0.25 drawn by ``jax_variables``' recipe, with
    a ``num_classes`` head; the port's state dict of them)."""
    module = JAX_STAGE_MODELS[stage](num_classes=num_classes, width=WIDTH)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), False))
    g = np.random.default_rng(seed)

    def draw(path, s):
        coll, leaf = path[0].key, path[-1].key
        if coll == "batch_stats":
            v = 0.1 * g.standard_normal(s.shape) if leaf == "mean" else 1 + 0.2 * g.random(s.shape)
        elif leaf == "kernel":
            v = g.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            v = 1 + 0.1 * g.standard_normal(s.shape)
        else:
            v = 0.1 * g.standard_normal(s.shape)
        return np.asarray(v, np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v, state_dict_from_jax(v)


def images(n, h, w, seed=0):
    return np.random.default_rng(seed).standard_normal((n, h, w, 3)).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("stage,res,n_h", [(1, 32, 2), (2, 64, 2), (3, 64, 4), (4, 128, 2)])
def test_spatial_matches_jax_all_stages(stage, res, n_h):
    v, sd = variables(stage)
    x = images(2, res, res)
    jm, pm = meshes(n_h)
    got = spatial_stage_infer(sd, x, stage, pm)
    assert got.shape == (2, res, res, 1) and got.dtype == torch.float32
    _close(got, jax_spatial_stage_infer(v, jnp.asarray(x), stage, jm))


def test_spatial_2d_grid_matches_jax():
    """H over 'data', W over 'model': the corners come with the W halos of
    the H-extended blocks."""
    v, sd = variables(2)
    x = images(2, 64, 64, seed=1)
    jm, pm = meshes(2, 2)
    _close(spatial_stage_infer(sd, x, 2, pm, w_axis="model"),
           jax_spatial_stage_infer(v, jnp.asarray(x), 2, jm, w_axis="model"))


def test_spatial_2d_grid_rectangular_matches_jax():
    """A non-square slide on a 4 x 2 grid."""
    v, sd = variables(2)
    x = images(1, 64, 96, seed=2)
    jm, pm = meshes(4, 2)
    _close(spatial_stage_infer(sd, x, 2, pm, w_axis="model"),
           jax_spatial_stage_infer(v, jnp.asarray(x), 2, jm, w_axis="model"))


def test_spatial_multiclass_heads_match_jax():
    v, sd = variables(3, num_classes=3)
    x = images(1, 64, 64, seed=3)
    jm, pm = meshes(2)
    got = spatial_stage_infer(sd, x, 3, pm)
    assert got.shape == (1, 64, 64, 3)
    _close(got, jax_spatial_stage_infer(v, jnp.asarray(x), 3, jm))


def test_spatial_predict_pads_and_crops_as_jax():
    """pad=True: any (H, W) zero-padded to the grid's divisor, the maps
    cropped back; the uncertainty map from the kernel's operator."""
    v, sd = variables(2)
    x = images(1, 70, 52, seed=4)
    jm, pm = meshes(2, 2)
    assert spatial_divisor(2, pm, w_axis="model") == (8, 8)
    padded, (h, w) = pad_to_divisible(x, 2, pm, w_axis="model")
    assert (h, w) == (70, 52) and padded.shape[1:3] == (72, 56)
    padded_t, _ = pad_to_divisible(torch.from_numpy(x), 2, pm, w_axis="model")
    assert torch.equal(padded_t, torch.from_numpy(padded))
    preds, probs, unc = spatial_predict(sd, x, pm, stage=2, w_axis="model", pad=True)
    jp, jprobs, junc = jax_spatial_predict(v, jnp.asarray(x), jm, stage=2, w_axis="model",
                                           pad=True)
    assert probs.shape == (1, 70, 52, 1)
    _close(probs, jprobs)
    _close(unc, junc)
    _close(unc, 1.0 - 2.0 * (probs - 0.5).abs(), 1e-6)
    near = np.abs(np.asarray(jprobs) - 0.5) < TOL
    np.testing.assert_array_equal(np.asarray(preds)[~near], np.asarray(jp)[~near])


@pytest.mark.parametrize("stage,shape,w_axis,px", [(4, (2, 1), None, (64, 80)),
                                                   (4, (2, 2), "model", (64, 64)),
                                                   (1, (4, 2), "model", (40, 36))])
def test_spatial_predict_equals_the_unsharded_forward_on_the_padded_image(stage, shape,
                                                                            w_axis, px):
    """Port against port: the sharded maps are ``native_forward``'s on the
    same padded image, cropped."""
    _, sd = variables(stage, seed=5)
    _, pm = meshes(*shape)
    x = torch.from_numpy(images(1, *px, seed=6)).sigmoid()
    padded, (h, w) = pad_to_divisible(x, stage, pm, w_axis=w_axis)
    model = STAGE_MODELS[stage](use_bn=False, width=WIDTH).eval()
    model.load_state_dict(fold_batchnorm(sd))
    want = [t[:, :h, :w] for t in native_forward(model, padded, (1, 1))]
    got = spatial_predict(SpatialWeights(sd, stage, pm), x, pm, stage=stage, w_axis=w_axis,
                          pad=True)
    assert [g.shape for g in got] == [(1, h, w, 1)] * 3
    _close(got[1], want[1], 1e-5)
    _close(got[2], want[2], 1e-5)
    near = (want[1] - 0.5).abs() < 1e-5
    assert torch.equal(got[0][~near], want[0][~near])


def test_spatial_bf16_tracks_float32():
    _, sd = variables(4, seed=7)
    x = images(1, 128, 128, seed=8)
    _, pm = meshes(2)
    want = spatial_stage_infer(sd, x, 4, pm)
    got = spatial_stage_infer(sd, x, 4, pm, dtype=torch.bfloat16)
    assert got.dtype == torch.float32  # the heads stay float32
    _close(got, want, 0.15)


def test_spatial_rejects_indivisible_shapes():
    _, sd = variables(4, seed=9)
    _, pm = meshes(4)
    x = np.zeros((1, 272, 272, 3), np.float32)  # 272 not divisible by 4 shards * 16
    with pytest.raises(ValueError, match="divisible"):
        spatial_stage_infer(sd, x, 4, pm)
    with pytest.raises(ValueError, match="not divisible"):
        spatial._axis_resize_bands(30, 60, 4)


@pytest.mark.parametrize("n_in,n_out,shards", [(16, 32, 2), (32, 64, 4), (63, 126, 3),
                                               (8, 64, 8), (64, 128, 8)])
def test_axis_resize_bands_match_jax(n_in, n_out, shards):
    np.testing.assert_array_equal(spatial._axis_resize_bands(n_in, n_out, shards),
                                  jax_axis_resize_bands(n_in, n_out, shards))


def test_programs_are_memoised_and_weights_reused():
    _, sd = variables(2, seed=10)
    _, pm = meshes(2)
    assert make_spatial_infer(2, pm) is make_spatial_infer(2, pm)
    assert make_spatial_infer(2, pm) is not make_spatial_infer(2, pm, dtype=torch.bfloat16)
    x = images(1, 32, 32, seed=11)
    weights = SpatialWeights(sd, 2, pm)
    assert torch.equal(spatial_stage_infer(weights, x, 2, pm), spatial_stage_infer(sd, x, 2, pm))
    with pytest.raises(ValueError, match="SpatialWeights of stage 2"):
        spatial_stage_infer(weights, x, 2, pm, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no copy"):
        spatial_stage_infer(weights, x, 2, make_mesh(2, devices=["meta", "meta"]))
