"""The port's speed predictor against the JAX package: features, the MLP with
carried parameters, and training (from carried initial weights, and from the
port's own) on the same numpy dataset."""
import jax
import numpy as np
import pytest
import torch

from repro.core import predictor as jpred
from repro.core.interference import OFFLINE_MODEL_PROFILES as JAX_PROFILES
from repro.core.interference import online_profile
from repro_torch.core import predictor as pred
from repro_torch.core.interference import OFFLINE_MODEL_PROFILES
from repro_torch.models.convert import mlp_from_jax

EPOCHS = 120          # build_measured_predictor's default


@pytest.fixture(scope="module")
def dataset():
    """`repro`'s synthetic profiling dataset (numpy), shared by both sides."""
    return jpred.make_dataset(np.random.default_rng(0), n=2000)


@pytest.fixture(scope="module")
def jax_run(dataset):
    feats, targets = dataset
    return jpred.train_predictor(jax.random.PRNGKey(0), feats, targets,
                                 epochs=EPOCHS, seed=0)


def test_feature_contract_copied():
    assert np.array_equal(pred.FEATURE_RANGES, jpred.FEATURE_RANGES)
    assert pred.N_FEATURES == jpred.N_FEATURES
    assert OFFLINE_MODEL_PROFILES == {
        k: type(OFFLINE_MODEL_PROFILES[k])(**vars(v))
        for k, v in JAX_PROFILES.items()}
    on = online_profile("translate", 60.0)
    for off in OFFLINE_MODEL_PROFILES.values():
        got = pred.pair_features(on, off, 0.35)
        want = jpred.pair_features(on, JAX_PROFILES[off.name], 0.35)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mlp_init_shapes_and_scale():
    params = pred.mlp_init(torch.Generator().manual_seed(0), device="cpu")
    ref = jpred.mlp_init(jax.random.PRNGKey(0))
    assert [tuple(p["w"].shape) for p in params] == \
        [tuple(p["w"].shape) for p in ref]
    assert all(not bool(p["b"].any()) for p in params)
    w = params[1]["w"]
    assert float(w.std()) == pytest.approx((2.0 / 64) ** 0.5, rel=0.1)


def test_predictions_with_carried_parameters(dataset):
    feats, _ = dataset
    ref = jpred.mlp_init(jax.random.PRNGKey(3))
    port = pred.SpeedPredictor({"T4": mlp_from_jax(
        jax.tree.map(np.asarray, ref), device="cpu")})
    want = jpred.SpeedPredictor({"T4": ref}).predict("T4", feats[:333])
    got = port.predict("T4", feats[:333])
    assert got.shape == want.shape == (333,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert port.predict("T4", feats[:0]).shape == (0,)
    one = port.predict_pair("T4", online_profile("vision", 30.0),
                            OFFLINE_MODEL_PROFILES["VGG16"], 0.5)
    assert 0.0 < one < 1.0


def test_training_from_carried_weights_tracks_reference(dataset, jax_run):
    """Same initial weights, same permutation and batch order: the
    validation-MAE history follows the reference's, epoch by epoch, within
    2e-3 (fp32 sums in another order, over 1,440 momentum-SGD steps)."""
    feats, targets = dataset
    init = mlp_from_jax(jax.tree.map(np.asarray,
                                     jpred.mlp_init(jax.random.PRNGKey(0))),
                        device="cpu")
    _, hist = pred.train_predictor(torch.Generator(), feats, targets,
                                   epochs=EPOCHS, seed=0, init=init)
    _, want = jax_run
    np.testing.assert_allclose(hist["val_mae"], want["val_mae"], atol=2e-3)
    np.testing.assert_allclose(hist["train_loss"], want["train_loss"],
                               atol=2e-4)


def test_training_from_scratch_lands_near_reference(dataset, jax_run):
    feats, targets = dataset
    _, hist = pred.train_predictor(torch.Generator().manual_seed(0), feats,
                                   targets, epochs=EPOCHS, seed=0)
    _, want = jax_run
    assert abs(hist["val_mae"][-1] - want["val_mae"][-1]) < 0.01
    assert hist["val_mae"][-1] < hist["val_mae"][0]
