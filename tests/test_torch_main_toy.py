"""The port's toy pipeline end to end on the CPU: ``cli.main_toy
full_pipeline`` on ``configs/tests/toyclassifier.yml`` (a micro run), the
port's ``cli.evaluate`` on its output with the weight, ``cov`` and dense
predictives, the regressor's pipeline, and the golden banana operating point
through the port.

The golden MAP is the JAX package's orbax checkpoint: JAX reads it here (as
``tests/test_golden_banana.py`` does) and the test holds the committed
conversion (``tests/golden/banana_torch``) to it bit for bit before the
port's weight predictor meets band (a) of ``test_golden_banana.py``. The
port's CPU Gram is plain f32 ``torch.matmul``: on this Gram it keeps two
round-off eigenvalues above the ``rank_tol`` mask that the JAX package's
does not (ROADMAP, Queue C), which puts its NLL 0.01 above and its
radius-1.05 AUROC 0.03 below the JAX package's at the same S.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_inducing_points_tpu.data import toy as jtoy
from laplace_inducing_points_tpu.models.registry import get_model as jget_model
from laplace_inducing_points_tpu.models.state import create_train_state
from laplace_inducing_points_tpu.utils.checkpoint import load_train_state
from laplace_inducing_points_tpu_torch.cli import evaluate, main_toy
from laplace_inducing_points_tpu_torch.core.params import params_from_jax
from laplace_inducing_points_tpu_torch.data.loader import ArrayDataset, make_dataloaders
from laplace_inducing_points_tpu_torch.data.toy import (FIXTURE_DIR, load_dataset,
                                                        train_test_val_split)
from laplace_inducing_points_tpu_torch.evaluation.harness import (auroc_ood,
                                                                  eval_dataset_extended)
from laplace_inducing_points_tpu_torch.inference.lla import ScalableLLAPredictor
from laplace_inducing_points_tpu_torch.models.state import ModelState
from laplace_inducing_points_tpu_torch.models.toy import SimpleClassifier
from laplace_inducing_points_tpu_torch.utils.checkpoint import (load_array, load_params,
                                                                load_run_meta)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CONFIG = os.path.join(REPO, "configs", "tests", "toyclassifier.yml")
GOLDEN = os.path.join(REPO, "tests", "golden", "banana")
GOLDEN_TORCH = os.path.join(REPO, "tests", "golden", "banana_torch")


@pytest.fixture(scope="module")
def micro_run(tmp_path_factory):
    """``main_toy full_pipeline`` on the test config: banana at the config's
    (default) generation parameters, written by the JAX package into the
    run's data directory, with the figures of ``--plot_Z --comparison``."""
    root = tmp_path_factory.mktemp("main_toy")
    jtoy.ensure_toy_npz("banana", data_dir=str(root / "data"), n=200)
    dirs = ["--ckpt_map", str(root / "map"), "--ckpt_induc", str(root / "ind"),
            "--data_dir", str(root / "data")]
    text = open(TEST_CONFIG).read() + "data:\n  n: 200\n"
    config = root / "toyclassifier_n200.yml"
    config.write_text(text)
    result = main_toy.main(["full_pipeline", "--dataset", "banana", "--config", str(config),
                            "--device", "cpu", "--num_mc_samples_lla", "6", "--plot_Z",
                            "--comparison", "--fig_dir", str(root / "fig"), *dirs])
    return root, str(config), dirs, result


def test_main_toy_full_pipeline_micro_run(micro_run):
    root, _, _, result = micro_run
    mp, ind = result["map"], result["inducing"]
    assert mp["steps"] == 2 * 5 and math.isfinite(mp["loss_first"]) and math.isfinite(
        mp["loss_last"])
    assert ind["steps"] == 2 and ind["objective"] == "gram" and ind["z_moved"] > 0
    assert result["alpha_ip"] == 0.01
    assert result["figures"] == {"MAP decision surface": True,
                                 "LLA predictive on the grid": True,
                                 "LA-vs-LLA predictive means": True,
                                 "IP-LLA mean and std": True}
    assert (root / "map" / "map_banana.pt").exists()
    assert load_array(str(root / "ind"), "ind_banana", 2).shape == (8, 2)
    assert load_run_meta(str(root / "ind"), "ind_banana") == {"alpha_ip": 0.01,
                                                               "objective": "gram"}
    assert sorted(p.name for p in (root / "fig").iterdir()) == [
        "banana_classifier_lla_ip.png", "banana_classifier_map.png",
        "banana_ip_lla_comparison.png", "banana_mean_comparison.png", "ips_trajectory.png"]


@pytest.mark.parametrize("predictive", ["weight", "cov", "dense"])
def test_evaluate_on_the_micro_run(micro_run, predictive):
    root, config, dirs, _ = micro_run
    flags = [] if predictive == "dense" else ["--scalable", "--predictive", predictive]
    out = root / f"eval_{predictive}.jsonl"
    records = evaluate.main(["--dataset", "banana", "--config", config, "--iters", "2",
                             "--device", "cpu", "--out_json", str(out), *flags, *dirs])
    assert len(records) == 2
    for rec in records:
        assert rec["predictive"] == predictive and rec["alpha"] == 0.01
        for key in ("nll", "acc", "brier", "ece", "factor_s", "per_batch_s"):
            assert math.isfinite(rec[key]), key
    if predictive == "cov":
        # the second repetition reads the statistics of every batch from the cache
        assert records[0]["stats_cache_hits"] == 0
        assert records[1]["stats_cache_hits"] == records[1]["batches"]
    assert json.loads(out.read_text().splitlines()[1])["nll"] == records[1]["nll"]


def test_main_toy_map_restarts_keep_the_lowest_validation_nll(micro_run, tmp_path):
    """``--map_restarts 2 --map_alpha_factor 2``: two MAP fits, candidate 0
    the default draw, the one with the lower validation NLL saved."""
    root, config, dirs, _ = micro_run
    dirs = [d if d != str(root / "map") else str(tmp_path / "map") for d in dirs]
    out = main_toy.main(["train_map", "--dataset", "banana", "--config", config, "--device",
                         "cpu", "--map_restarts", "2", "--map_alpha_factor", "2",
                         "--fig_dir", str(tmp_path / "fig"), *dirs])
    nlls = out["map"]["val_nlls"]
    assert len(nlls) == 2 and all(math.isfinite(v) for v in nlls) and nlls[0] != nlls[1]
    from laplace_inducing_points_tpu_torch.data.toy import ensure_toy_npz
    from laplace_inducing_points_tpu_torch.training.map import evaluate_loader
    from laplace_inducing_points_tpu_torch.utils.checkpoint import load_state

    x, y = load_dataset(ensure_toy_npz("banana", data_dir=str(root / "data"), n=200))
    tr, te, va = train_test_val_split(x, y)
    val = make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va), 32)[2]
    kept = load_state(str(tmp_path / "map"), "map_banana", SimpleClassifier(32, 3, 2, 2),
                      "classifier", torch.device("cpu"))
    assert evaluate_loader(kept, val)[0] == pytest.approx(min(nlls), rel=1e-6)


def test_main_toy_regressor_pipeline(tmp_path):
    """The sine regressor: MAP with its logvar, Z on the gram objective, the
    dense 1-D predictive with X and with Z, and ``visualize`` from the saved
    checkpoints."""
    jtoy.ensure_toy_npz("sine", data_dir=str(tmp_path / "data"), n=60, noise=0.3, seed=1)
    config = tmp_path / "sine.yml"
    config.write_text(
        "model: {name: regressor, type: regressor, num_h: 8, num_l: 2, seed: 3}\n"
        "data: {n: 60, noise: 0.3, seed: 1}\n"
        "optimization:\n  alpha: 0.05\n  full_set_size: 48\n"
        "  map: {batch_size: 16, epochs: 4, lr: 0.01, seed: 2}\n"
        "  ip: {m: 6, batch_size: 16, epochs: 3, lr: 0.01, mc_samples: 4, seed: 5}\n")
    common = ["--ckpt_map", str(tmp_path / "map"), "--ckpt_induc", str(tmp_path / "ind"),
              "--data_dir", str(tmp_path / "data"), "--dataset", "sine", "--config",
              str(config), "--device", "cpu"]
    dirs = [*common, "--fig_dir", str(tmp_path / "fig")]
    result = main_toy.main(["full_pipeline", *dirs])
    assert abs(result["map"]["logvar"]) > 0 and result["inducing"]["z_moved"] > 0
    res = result["regression_1d"]
    assert all(np.all(np.isfinite(v)) for v in res.values())
    assert np.all(res["ip_std"] > 0) and res["xlin"].shape == (100, 1)
    flat, _, logvar = load_params(str(tmp_path / "map"), "map_sine")
    assert logvar == result["map"]["logvar"]
    again = main_toy.main(["visualize", *dirs])
    np.testing.assert_allclose(again["regression_1d"]["ip_std"], res["ip_std"], rtol=1e-6)
    rec = evaluate.main(["--iters", "1", *common])[0]
    assert rec["predictive"] == "dense" and math.isfinite(rec["nll"]) and rec["rmse"] > 0


def _loader(name, batch_size=32):
    x, y = load_dataset(str(FIXTURE_DIR / name))
    tr, te, va = train_test_val_split(x, y)
    return make_dataloaders(ArrayDataset(*tr), ArrayDataset(*te), ArrayDataset(*va),
                            batch_size)[1]


def test_golden_banana_band_a_through_the_port():
    """The JAX package's golden MAP and Z at its recorded α (0.0025),
    ``full_set_size`` 450, range clip 1.0 and S = 200 through the port's
    weight predictor: band (a) of ``test_golden_banana.py`` (``:115-119``)."""
    model = jget_model({"name": "classifier", "type": "classifier", "num_h": 16,
                        "num_l": 3, "num_c": 2})
    jstate = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 2)),
                                optax.adam(1e-3), model_kind="classifier")
    jstate = load_train_state(jstate, os.path.join(GOLDEN, "map"))
    ref_flat, ref_spec = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    flat, spec, logvar = load_params(GOLDEN_TORCH, "map_banana")
    assert spec == ref_spec and logvar is None
    np.testing.assert_array_equal(flat.numpy(), ref_flat.numpy())

    state = ModelState(SimpleClassifier(16, 3, 2, 2), flat, "classifier")
    Z = torch.as_tensor(load_array(GOLDEN, "ind_banana", 500))
    alpha = load_run_meta(GOLDEN, "ind_banana")["alpha_ip"]
    assert alpha == pytest.approx(0.0025)
    with torch.no_grad():
        pred = ScalableLLAPredictor(state, Z, full_set_size=450, range_clip_min=1.0)
        common = dict(alpha=alpha, full_set_size=450, num_mc_samples=200, predictor=pred)
        rec = eval_dataset_extended(state, _loader("banana.npz"), Z,
                                    generator=torch.Generator().manual_seed(0), **common)
        auroc = {r: auroc_ood(state, rec["probs"], _loader(name), Z,
                              generator=torch.Generator().manual_seed(1), **common)
                 for r, name in ((2.0, "ring_r2.npz"), (1.05, "ring_r1p05.npz"))}
    assert rec["nll"] == pytest.approx(0.233, abs=0.03), rec
    assert rec["ece"] == pytest.approx(0.146, abs=0.03), rec
    assert rec["acc"] == pytest.approx(0.98, abs=0.021), rec
    assert auroc[2.0] >= 0.97
    assert auroc[1.05] == pytest.approx(0.892, abs=0.05)


def test_port_and_smoke_import_no_jax_by_grep():
    """No module of the port and not ``chip_smoke.py`` has an import line for
    ``jax``, ``flax``, ``optax`` or the JAX package."""
    import re

    pattern = re.compile(r"^\s*(from|import) (jax|flax|optax|laplace_inducing_points_tpu)\b",
                         re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(REPO, "laplace_inducing_points_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = [f for f in files if pattern.search(open(f).read())]
    assert not bad, bad
