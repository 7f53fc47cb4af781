"""Embedding / data / model analysis and visualization (the port of
dlrm_tpu/tools/visualize.py, over the port's model and checkpoints):

  * 2-D projections of trained embedding tables (visualize_embeddings_umap,
    reference :78-239): UMAP when installed, else t-SNE / PCA from
    scikit-learn;
  * categorical frequency analysis of the input data
    (analyse_categorical_counts, :240-366);
  * projections of the model's representations at the input / interaction /
    final stages, per class, with a cluster analysis (analyze_model_data,
    :451-1014): HDBSCAN when installed, else KMeans.

The model's half runs on the card: representations() computes the three
stages there. The projection, clustering and plotting run on the host;
scikit-learn and matplotlib are imported only inside the functions that
need them, so that importing this module and representations() work
without them (umap and hdbscan are optional, as in the JAX package).

Usage:
  python -m dlrm_tpu_torch.tools.visualize --load-model <ckpt-dir> \\
      --output-dir plots [--skip-data-plots] ...
main(argv, device="cuda") runs the model on the card; device="cpu" on the
CPU (the tests do). The checkpoint may be either package's
(train/checkpoint.py reads both).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _projector(kind: str, n_components: int = 2, seed: int = 0,
               n_samples: int = 0):
    """Best-available 2-D projector: umap > tsne > pca. n_samples bounds
    the t-SNE perplexity (must be < n_samples — small Criteo tables have
    as few as 3 rows)."""
    if kind == "umap":
        try:
            import umap

            return umap.UMAP(n_components=n_components, random_state=seed)
        except ImportError:
            print("umap not installed; falling back to t-SNE")
            kind = "tsne"
    if kind == "tsne":
        from sklearn.manifold import TSNE

        perplexity = 30.0
        if n_samples:
            perplexity = max(1.0, min(30.0, (n_samples - 1) / 3.0))
        return TSNE(n_components=n_components, random_state=seed,
                    init="pca", perplexity=perplexity)
    from sklearn.decomposition import PCA

    return PCA(n_components=n_components, random_state=seed)


def _clusterer(min_cluster_size: int = 10, seed: int = 0):
    """HDBSCAN when available (reference behavior), else KMeans."""
    try:
        import hdbscan

        return hdbscan.HDBSCAN(min_cluster_size=min_cluster_size)
    except ImportError:
        from sklearn.cluster import KMeans

        class _KM:
            def fit_predict(self, x):
                k = max(2, min(16, x.shape[0] // max(1, min_cluster_size)))
                return KMeans(n_clusters=k, random_state=seed,
                              n_init=4).fit_predict(x)

        return _KM()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_embedding_tables(
    params: Dict,
    table_sizes: Sequence[int],
    row_offsets: Sequence[int],
    output_dir: str,
    method: str = "umap",
    max_rows: int = 5000,
    seed: int = 0,
) -> List[str]:
    """One 2-D projection scatter per table (reference :78-239)."""
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    stacked = params["emb"]["stacked"].float().cpu().numpy()
    outputs = []
    for t, n in enumerate(table_sizes):
        off = int(row_offsets[t])
        w = stacked[off: off + n]
        if w.shape[0] > max_rows:
            sel = np.random.RandomState(seed).choice(
                w.shape[0], max_rows, replace=False
            )
            w = w[sel]
        if w.shape[0] < 5:
            continue
        proj = _projector(method, seed=seed, n_samples=w.shape[0])
        z = proj.fit_transform(w)
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.scatter(z[:, 0], z[:, 1], s=2, alpha=0.5)
        ax.set_title(f"table {t} ({n} rows) — {type(proj).__name__}")
        path = os.path.join(output_dir, f"emb_table_{t:02d}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        outputs.append(path)
    return outputs


def analyse_categorical_counts(
    x_cat: np.ndarray,  # [n, 26] contiguous ids
    counts: Sequence[int],
    output_dir: str,
) -> str:
    """Per-column access-frequency histograms (reference :240-366): sorted
    unique-value counts on a log scale, one subplot per feature."""
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    num_cols = x_cat.shape[1]
    rows = int(np.ceil(num_cols / 4))
    fig, axes = plt.subplots(rows, 4, figsize=(16, 3 * rows))
    for c in range(num_cols):
        ax = axes.flat[c]
        freq = np.bincount(x_cat[:, c], minlength=int(counts[c]))
        ax.plot(np.sort(freq)[::-1])
        ax.set_yscale("symlog")
        ax.set_title(f"cat {c} ({counts[c]} ids)", fontsize=8)
    for c in range(num_cols, rows * 4):
        axes.flat[c].axis("off")
    path = os.path.join(output_dir, "categorical_counts.png")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def representations(model, params: Dict, batches, device="cuda",
                    max_points: int = 4000):
    """The model's representations of up to max_points labelled rows of
    `batches` (HostBatch), computed on `device`: ({"input": dense features
    beside the flattened pooled embeddings, "interaction": the top MLP's
    input, "final": the fp32 logits}, labels), numpy on the host. The
    logits come from the interaction already computed (no second pass over
    the bottom MLP); a quantized checkpoint runs its quantized towers."""
    from dlrm_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    inputs, inters, finals, labels = [], [], [], []
    total = 0
    with torch.no_grad():
        for hb in batches:
            b = hb.to_device(dev)
            ly = model.apply_emb(params, b)
            z = model.interaction_from_pooled(params, b.dense, ly)
            logits = model.logits_from_interaction(params, z)
            lbl = b.labels.reshape(-1).cpu().numpy()
            keep = lbl >= 0
            ly_f = ly.reshape(ly.shape[0], -1).float().cpu().numpy()
            inputs.append(np.concatenate(
                [b.dense.float().cpu().numpy()[keep], ly_f[keep]], axis=1))
            inters.append(z.float().cpu().numpy()[keep])
            finals.append(logits.float().cpu().numpy()[keep])
            labels.append(lbl[keep])
            total += int(keep.sum())
            if total >= max_points:
                break
    stages = {
        "input": np.concatenate(inputs)[:max_points],
        "interaction": np.concatenate(inters)[:max_points],
        "final": np.concatenate(finals)[:max_points],
    }
    return stages, np.concatenate(labels)[:max_points]


def analyze_model_data(
    model,
    params: Dict,
    batches,
    output_dir: str,
    method: str = "umap",
    max_points: int = 4000,
    seed: int = 0,
    device="cuda",
) -> List[str]:
    """Project model representations at three stages — raw input features,
    post-interaction, final logits neighborhood — per-class colored, plus a
    cluster assignment on the interaction representation (reference
    :451-1014). representations() runs on `device`; the rest on the
    host."""
    X, y = representations(model, params, batches, device, max_points)
    plt = _pyplot()
    os.makedirs(output_dir, exist_ok=True)
    # predictions / correctness masks drive the reference's full plot
    # family (visualize_umap_data, reference :613-765: all-classes,
    # all-predictions, per-class, correct, errors, per-prediction)
    logit1 = X["final"][:, 0] if X["final"].ndim == 2 else X["final"]
    prob = 1.0 / (1.0 + np.exp(-logit1))
    pred = (prob >= 0.5).astype(np.float32)
    correct = pred == y
    outputs = []
    proj2 = {}
    for stage, feats in X.items():
        if feats.ndim == 2 and feats.shape[1] < 2:
            # final logits are 1-D: pair with the label axis trivially
            feats = np.concatenate([feats, np.zeros_like(feats)], axis=1)
        z2 = _projector(method, seed=seed,
                        n_samples=feats.shape[0]).fit_transform(feats)
        proj2[stage] = z2
        panels = [
            ("by label", None, y, "coolwarm"),
            ("by prediction", None, pred, "coolwarm"),
            ("class 0", y == 0, None, None),
            ("class 1", y == 1, None, None),
            ("correct", correct, None, None),
            ("errors", ~correct, None, None),
            ("predict 0", pred == 0, None, None),
            ("predict 1", pred == 1, None, None),
        ]
        fig, axes = plt.subplots(2, 4, figsize=(20, 10))
        for (title, mask, color, cmap), ax in zip(panels, axes.ravel()):
            if mask is None:
                ax.scatter(z2[:, 0], z2[:, 1], s=3, c=color, cmap=cmap,
                           alpha=0.6)
            else:
                ax.scatter(z2[~mask, 0], z2[~mask, 1], s=1,
                           c=[(0.8, 0.8, 0.8)], alpha=0.3)
                ax.scatter(z2[mask, 0], z2[mask, 1], s=3, alpha=0.6)
                title = f"{title} ({int(mask.sum())})"
            ax.set_title(f"{stage}: {title}", fontsize=9)
        path = os.path.join(output_dir, f"repr_{stage}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        outputs.append(path)

    # ---- cluster analysis on the interaction representation (reference
    # hdbscan_clustering :765-843 + the per-cluster deep dives :843-1014)
    cl = _clusterer().fit_predict(X["interaction"])
    z2 = proj2["interaction"]
    inlier = cl >= 0
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(12, 5))
    ax0.scatter(z2[~inlier, 0], z2[~inlier, 1], s=1, c=[(0.5, 0.5, 0.5)],
                alpha=0.5)
    ax0.set_title(f"outliers ({int((~inlier).sum())})")
    ax1.scatter(z2[inlier, 0], z2[inlier, 1], s=2, c=cl[inlier],
                cmap="Spectral")
    ax1.set_title(f"inliers ({int(inlier.sum())})")
    cpath = os.path.join(output_dir, "clusters.png")
    fig.savefig(cpath, dpi=110)
    plt.close(fig)
    outputs.append(cpath)

    # per-cluster per-class statistics: size, click rate, predicted click
    # rate, accuracy, majority class + purity
    rows = []
    for c in np.unique(cl):
        m = cl == c
        maj = 1 if y[m].mean() >= 0.5 else 0
        rows.append((
            int(c), int(m.sum()), float(y[m].mean()),
            float(pred[m].mean()), float(correct[m].mean()),
            maj, float((y[m] == maj).mean()),
        ))
    with open(os.path.join(output_dir, "clusters.txt"), "w") as f:
        f.write(
            "cluster\tsize\tclick_rate\tpred_click_rate\taccuracy\t"
            "majority_class\tpurity\n"
        )
        for r in rows:
            f.write(
                f"{r[0]}\t{r[1]}\t{r[2]:.4f}\t{r[3]:.4f}\t{r[4]:.4f}\t"
                f"{r[5]}\t{r[6]:.4f}\n"
            )
        f.write(
            f"TOTAL\t{len(y)}\t{y.mean():.4f}\t{pred.mean():.4f}\t"
            f"{correct.mean():.4f}\t-\t-\n"
        )
    outputs.append(os.path.join(output_dir, "clusters.txt"))

    # deep dive into the largest clusters: members by label and by
    # correctness (the per-cluster analysis plots, reference :843-1014)
    real = [r for r in rows if r[0] >= 0] or rows
    top = sorted(real, key=lambda r: -r[1])[:4]
    for c, size, *_ in top:
        m = cl == c
        fig, (a0, a1) = plt.subplots(1, 2, figsize=(12, 5))
        for ax, col, ttl in ((a0, y[m], "by label"),
                             (a1, correct[m].astype(float), "by correctness")):
            ax.scatter(z2[~m, 0], z2[~m, 1], s=1, c=[(0.85, 0.85, 0.85)],
                       alpha=0.3)
            ax.scatter(z2[m, 0], z2[m, 1], s=4, c=col, cmap="coolwarm",
                       alpha=0.8)
            ax.set_title(f"cluster {c} (n={size}): {ttl}", fontsize=9)
        path = os.path.join(output_dir, f"cluster_{c}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        outputs.append(path)
    return outputs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DLRM analysis & visualization")
    p.add_argument("--load-model", type=str, required=True)
    p.add_argument("--output-dir", type=str, default="plots")
    p.add_argument("--proj-method", type=str, default="umap",
                   choices=["umap", "tsne", "pca"])
    p.add_argument("--arch-sparse-feature-size", type=int, default=2)
    p.add_argument("--arch-embedding-size", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-bot", type=str, default="4-3-2")
    p.add_argument("--arch-mlp-top", type=str, default="4-2-1")
    p.add_argument("--arch-interaction-op", type=str, default="dot")
    p.add_argument("--num-batches", type=int, default=8)
    p.add_argument("--mini-batch-size", type=int, default=128)
    p.add_argument("--skip-embedding-plots", action="store_true")
    p.add_argument("--skip-data-plots", action="store_true")
    return p


def config_from_args(args):
    from dlrm_tpu_torch.config import DLRMConfig

    return DLRMConfig(
        embedding_dim=args.arch_sparse_feature_size,
        table_sizes=tuple(int(x) for x in args.arch_embedding_size.split("-")),
        mlp_bot=tuple(int(x) for x in args.arch_mlp_bot.split("-")),
        mlp_top=tuple(int(x) for x in args.arch_mlp_top.split("-")),
        interaction=args.arch_interaction_op,
    )


def load(args, device="cuda"):
    """(model, params, data) of the flags: the checkpoint's params on
    `device` and the reference's random data (round targets: the per-class
    panels need {0, 1} labels)."""
    from dlrm_tpu_torch.config import TrainConfig
    from dlrm_tpu_torch.data.random_data import RandomDataset
    from dlrm_tpu_torch.device import resolve_device
    from dlrm_tpu_torch.models.dlrm import DLRMModel
    from dlrm_tpu_torch.train import checkpoint as ckpt

    dev = resolve_device(device)
    cfg = config_from_args(args)
    model = DLRMModel(cfg)
    template = model.init_params(seed=0, device=dev)
    params, _, meta = ckpt.load_checkpoint(args.load_model, template)
    print(f"loaded checkpoint from {args.load_model}: {meta}")
    tc = TrainConfig(mini_batch_size=args.mini_batch_size,
                     num_batches=args.num_batches, round_targets=True)
    return model, params, RandomDataset(cfg, tc)


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    args = build_parser().parse_args(argv)
    model, params, data = load(args, device)
    cfg = model.cfg
    if not args.skip_embedding_plots:
        outs = plot_embedding_tables(
            params, cfg.table_sizes, model.row_offsets, args.output_dir,
            args.proj_method,
        )
        print(f"wrote {len(outs)} embedding plots")
    if not args.skip_data_plots:
        x_cat = np.concatenate([hb.idx[:, :, 0].T for hb in data])
        analyse_categorical_counts(x_cat, cfg.table_sizes, args.output_dir)
        outs = analyze_model_data(
            model, params, data, args.output_dir, args.proj_method,
            device=device,
        )
        print(f"wrote representation analyses: {outs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
