"""The port's analysis and visualization tool
(dlrm_tpu_torch/tools/visualize.py) against the JAX package's
(dlrm_tpu/tools/visualize.py), as tests/test_tools.py runs it: main() end
to end on a checkpoint the JAX package wrote, and analyze_model_data's
artifacts, clusters.txt header and TOTAL row. representations() holds the
three stages to the JAX model's on the same params (the port's init carried
over with bridge.py) and the same batches: fp32 throughout, within rtol
1e-5 / atol 1e-6 (only the order of fp32 sums differs); its final stage
equals the port's own forward logits bit for bit, quantized towers
included. Importing the module loads neither matplotlib nor scikit-learn
(the card's machine has neither)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.config import TrainConfig as JaxTrainConfig
from dlrm_tpu.data.random_data import RandomDataset as JaxRandomDataset
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.ops.mlp import apply_mlp
from dlrm_tpu.tools import visualize as jviz
from dlrm_tpu.train import checkpoint as jckpt
from dlrm_tpu_torch.bridge import params_to_jax
from dlrm_tpu_torch.config import DLRMConfig, TrainConfig
from dlrm_tpu_torch.data.random_data import RandomDataset
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.tools import visualize as viz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(embedding_dim=4, table_sizes=(60, 30, 40), mlp_bot=(4, 8, 4),
          mlp_top=(8, 4, 1), loss="bce", num_indices_per_lookup=4)
TC = dict(mini_batch_size=64, num_batches=2, numpy_rand_seed=5,
          round_targets=True)
HEADER = ["cluster", "size", "click_rate", "pred_click_rate", "accuracy",
          "majority_class", "purity"]


def _port(seed):
    model = DLRMModel(DLRMConfig(**KW))
    return model, model.init_params(seed=seed, device="cpu")


def _jax_params(params):
    return jax.tree_util.tree_map(jnp.asarray, params_to_jax(params))


def _jax_stages(model, params, batches, max_points):
    """The JAX tool's three stages (the body of its jitted reps)."""
    inputs, inters, finals, labels = [], [], [], []
    for hb in batches:
        b = hb.to_device()
        ly = model.apply_emb(params, b)
        x = apply_mlp(params["bot"], b.dense, model.cfg.sigmoid_bot)
        z = model.interact(params, x, ly.astype(x.dtype))
        logits = model.logits_from_interaction(params, z)
        lbl = np.asarray(b.labels).ravel()
        keep = lbl >= 0
        inputs.append(np.concatenate(
            [np.asarray(b.dense)[keep],
             np.asarray(ly).reshape(ly.shape[0], -1)[keep]], axis=1))
        inters.append(np.asarray(z)[keep])
        finals.append(np.asarray(logits)[keep])
        labels.append(lbl[keep])
    return ({"input": np.concatenate(inputs)[:max_points],
             "interaction": np.concatenate(inters)[:max_points],
             "final": np.concatenate(finals)[:max_points]},
            np.concatenate(labels)[:max_points])


def test_representations_match_jax():
    model, params = _port(2)
    batches = list(RandomDataset(model.cfg, TrainConfig(**TC)))
    got, y = viz.representations(model, params, batches, "cpu",
                                 max_points=100)
    jmodel = JaxModel(JaxConfig(**KW))
    want, y_j = _jax_stages(jmodel, _jax_params(params),
                            JaxRandomDataset(jmodel.cfg,
                                             JaxTrainConfig(**TC)), 100)
    np.testing.assert_array_equal(y, y_j)
    assert sorted(got) == ["final", "input", "interaction"]
    for stage in got:
        assert got[stage].shape == want[stage].shape, stage
        np.testing.assert_allclose(got[stage], want[stage], rtol=1e-5,
                                   atol=1e-6, err_msg=stage)
    assert got["input"].shape == (100, 4 + 3 * 4)


@pytest.mark.parametrize("quantized", [False, True])
def test_final_stage_is_the_forward_logits(quantized):
    """The logits from the kept interaction equal the forward's, bit for
    bit: no stage re-runs or changes the model's arithmetic (a quantized
    checkpoint's int8 towers and int4 tables included)."""
    model, params = _port(3)
    if quantized:
        params = model.quantize_mlps(
            model.quantize_embeddings(params, 4), 8)
    hb = RandomDataset(model.cfg, TrainConfig(**TC))[0]
    got, _ = viz.representations(model, params, [hb], "cpu")
    with torch.no_grad():
        _, logits = model.apply_with_logits(params, hb.to_device("cpu"))
    np.testing.assert_array_equal(got["final"], logits.numpy())


def test_visualize_cli_end_to_end(tmp_path):
    """main() on a checkpoint the JAX package wrote: the JAX test's
    artifacts."""
    model, params = _port(1)
    ck = str(tmp_path / "ck")
    jckpt.save_checkpoint(ck, _jax_params(params), meta={"epoch": 1})
    out = str(tmp_path / "plots")
    rc = viz.main(
        [
            "--load-model", ck,
            "--output-dir", out,
            "--proj-method", "pca",
            "--arch-sparse-feature-size", "4",
            "--arch-embedding-size", "60-30-40",
            "--arch-mlp-bot", "4-8-4",
            "--arch-mlp-top", "8-4-1",
            "--num-batches", "3",
            "--mini-batch-size", "32",
        ],
        device="cpu",
    )
    assert rc == 0
    files = os.listdir(out)
    assert sorted(f for f in files if f.startswith("emb_table_")) == [
        "emb_table_00.png", "emb_table_01.png", "emb_table_02.png"]
    assert "categorical_counts.png" in files
    assert "clusters.txt" in files
    assert any(f.startswith("repr_") for f in files)


def test_visualize_deep_analysis_artifacts(tmp_path):
    """analyze_model_data: the per-stage plot families, the cluster plots,
    clusters.txt's header and a TOTAL row whose size and click rate equal
    the JAX tool's on the same params and batches."""
    model, params = _port(2)
    batches = list(RandomDataset(model.cfg, TrainConfig(**TC)))
    out = str(tmp_path / "deep")
    files = viz.analyze_model_data(model, params, batches, out,
                                   method="pca", max_points=128,
                                   device="cpu")
    names = [os.path.basename(f) for f in files]
    for stage in ("input", "interaction", "final"):
        assert f"repr_{stage}.png" in names
    assert "clusters.png" in names
    assert "clusters.txt" in names
    assert any(n.startswith("cluster_") for n in names)
    txt = open(os.path.join(out, "clusters.txt")).read().splitlines()
    assert txt[0].split("\t") == HEADER
    assert txt[-1].startswith("TOTAL")

    jmodel = JaxModel(JaxConfig(**KW))
    jout = str(tmp_path / "jax")
    jviz.analyze_model_data(jmodel, _jax_params(params),
                            list(JaxRandomDataset(jmodel.cfg,
                                                  JaxTrainConfig(**TC))),
                            jout, method="pca", max_points=128)
    jtxt = open(os.path.join(jout, "clusters.txt")).read().splitlines()
    assert jtxt[0] == txt[0]
    assert jtxt[-1].split("\t")[:3] == txt[-1].split("\t")[:3]


def test_import_needs_no_plotting_packages():
    """The card's half imports neither matplotlib nor scikit-learn."""
    code = ("import sys, dlrm_tpu_torch.tools.visualize; "
            "bad = [m for m in ('matplotlib', 'sklearn') if m in sys.modules];"
            " sys.exit(f'imported {bad}' if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
