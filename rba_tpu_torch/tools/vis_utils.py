"""Query-embedding analysis utilities: clustering and 2-D projection plots (a copy of
``rba_tpu/tools/vis_utils.py``; ``extract_query_embeddings`` reads the port's model).

After the reference's ``tools/vis_utils.py``: kmeans / meanshift / dbscan / optics /
hdbscan clustering of the decoder's query embeddings and t-SNE / PCA scatter plots, to
see what the 100 object queries specialize to.  sklearn and matplotlib are imported where
they are used (the GPU machine has neither): kmeans falls back to numpy, a plot to an
``.npy`` of its coordinates.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def kmeans_numpy(x: np.ndarray, k: int, iters: int = 100, seed: int = 0):
    rng = np.random.RandomState(seed)
    centers = x[rng.choice(len(x), k, replace=False)].copy()
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.stack([
            x[assign == i].mean(0) if (assign == i).any() else centers[i] for i in range(k)
        ])
        if np.allclose(new, centers):
            break
        centers = new
    return assign, centers


def cluster(x: np.ndarray, method: str = "kmeans", **kwargs) -> np.ndarray:
    """Cluster (N, D) embeddings; returns integer labels."""
    try:
        from sklearn import cluster as skc

        if method == "kmeans":
            return skc.KMeans(n_clusters=kwargs.get("k", 8), n_init=10).fit_predict(x)
        if method == "meanshift":
            return skc.MeanShift().fit_predict(x)
        if method == "dbscan":
            return skc.DBSCAN(eps=kwargs.get("eps", 0.5)).fit_predict(x)
        if method == "optics":
            return skc.OPTICS().fit_predict(x)
        if method == "hdbscan":
            return skc.HDBSCAN().fit_predict(x)
    except ImportError:
        pass
    assign, _ = kmeans_numpy(x, kwargs.get("k", 8))
    return assign


# ---------------------------------------------------------------------------
# per-method clustering with the reference's parameterization
# (reference vis_utils.py:16-98)
# ---------------------------------------------------------------------------

def apply_kmeans(data: np.ndarray, n_clusters: int, max_iter: int = 300):
    """→ (labels, cluster_centers) (reference :16-22)."""
    try:
        from sklearn.cluster import KMeans

        km = KMeans(n_clusters=n_clusters, max_iter=max_iter, n_init=10).fit(data)
        return km.labels_, km.cluster_centers_
    except ImportError:
        return kmeans_numpy(data, n_clusters, iters=max_iter)


def cluster_with_meanshift(data: np.ndarray, bandwidth="auto", quantile: float = 0.2,
                           n_samples: int = 2000, bin_seeding: bool = True):
    """→ (labels, cluster_centers); bandwidth estimated from the data when
    "auto" (reference :24-34)."""
    from sklearn.cluster import MeanShift, estimate_bandwidth

    if bandwidth == "auto":
        bandwidth = estimate_bandwidth(
            data, quantile=quantile, n_samples=min(n_samples, len(data))
        )
        if bandwidth <= 0:
            bandwidth = None
    ms = MeanShift(bandwidth=bandwidth, bin_seeding=bin_seeding).fit(data)
    return ms.labels_, ms.cluster_centers_


def cluster_with_dbscan(data: np.ndarray, eps: float = 0.5, min_samples: int = 5,
                        metric: str = "euclidean", leaf_size: int = 30,
                        scale_data: bool = False):
    """→ labels, -1 = noise (reference :36-56)."""
    from sklearn.cluster import DBSCAN

    if scale_data:
        from sklearn.preprocessing import StandardScaler

        data = StandardScaler().fit_transform(data)
    return DBSCAN(eps=eps, min_samples=min_samples, metric=metric,
                  leaf_size=leaf_size).fit_predict(data)


def cluster_with_optics(data: np.ndarray, min_samples: int = 5, max_eps: float = 1000,
                        metric: str = "euclidean", min_cluster_size=None):
    """(reference :58-73)"""
    from sklearn.cluster import OPTICS

    return OPTICS(min_samples=min_samples, max_eps=max_eps, metric=metric,
                  min_cluster_size=min_cluster_size).fit_predict(data)


def cluster_with_hdbscan(data: np.ndarray, min_samples: int = 5,
                         metric: str = "euclidean", min_cluster_size: int = 5,
                         cluster_selection_epsilon: float = 0.0):
    """(reference :75-98; sklearn >= 1.3 ships HDBSCAN natively)"""
    from sklearn.cluster import HDBSCAN

    return HDBSCAN(min_samples=min_samples, metric=metric,
                   min_cluster_size=min_cluster_size,
                   cluster_selection_epsilon=cluster_selection_epsilon).fit_predict(data)


def find_pca_n_components_for_variance_threshold(
    variance_ratio: np.ndarray, threshold: float
) -> int:
    """Smallest n with cumulative explained variance ≥ threshold
    (reference :126-137)."""
    cum = np.cumsum(variance_ratio)
    idx = np.searchsorted(cum, threshold)
    return int(min(idx + 1, len(variance_ratio)))


def pca_explained_variance(x: np.ndarray) -> np.ndarray:
    xc = x - x.mean(0)
    _, s, _ = np.linalg.svd(xc, full_matrices=False)
    var = s**2
    return var / var.sum()


def find_n_clusters_elbow_method(features: np.ndarray, k_min: int, k_max: int):
    """Inertia per k (reference :375-388); the elbow is read off the curve."""
    inertias = []
    for k in range(k_min, k_max + 1):
        labels, centers = apply_kmeans(features, k)
        inertias.append(float(((features - centers[labels]) ** 2).sum()))
    return list(range(k_min, k_max + 1)), inertias


def silhouette_scores(features: np.ndarray, k_min: int, k_max: int):
    """Mean silhouette per k (reference yellow_brick_silhouette_method :400-407)."""
    from sklearn.metrics import silhouette_score

    ks, scores = [], []
    for k in range(k_min, k_max + 1):
        labels, _ = apply_kmeans(features, k)
        if len(np.unique(labels)) < 2:
            continue
        ks.append(k)
        scores.append(float(silhouette_score(features, labels)))
    return ks, scores


def project_2d(x: np.ndarray, method: str = "tsne", seed: int = 0) -> np.ndarray:
    """(N, D) → (N, 2) via t-SNE or PCA."""
    if method == "pca":
        xc = x - x.mean(0)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        return xc @ vt[:2].T
    from sklearn.manifold import TSNE

    return TSNE(n_components=2, random_state=seed, init="pca").fit_transform(x)


def plot_embeddings(
    x: np.ndarray,
    labels: Optional[np.ndarray] = None,
    method: str = "pca",
    out_path: str = "embeddings.png",
):
    coords = project_2d(x, method)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        sc = ax.scatter(coords[:, 0], coords[:, 1], c=labels, cmap="tab20", s=18)
        if labels is not None:
            fig.colorbar(sc)
        ax.set_title(f"query embeddings ({method})")
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    except ImportError:
        np.save(out_path + ".npy", coords)
    return coords


def plot_bar(y, x=None, x_label="x", y_label="y", title="", out_path=None):
    """(reference :139-155)"""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.bar(np.arange(len(y)) if x is None else x, y)
        ax.set_xlabel(x_label); ax.set_ylabel(y_label); ax.set_title(title)
        if out_path:
            fig.savefig(out_path, dpi=120)
        plt.close(fig)
    except ImportError:
        pass


def plot_line(x, y, x_label="x", y_label="y", markers=False, title="", out_path=None):
    """(reference :157-171)"""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(x, y, marker="o" if markers else None)
        ax.set_xlabel(x_label); ax.set_ylabel(y_label); ax.set_title(title)
        if out_path:
            fig.savefig(out_path, dpi=120)
        plt.close(fig)
    except ImportError:
        pass


def plot_clusters(
    data: np.ndarray,
    method: str = "kmeans",
    cluster_mode: str = "tsne",
    custom_embedding: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
    **kwargs,
):
    """Cluster + 2-D scatter, the plot_*_clusters_tsne family collapsed into
    one entry point (reference :173-373): cluster in the ORIGINAL space,
    color the t-SNE/PCA projection by cluster id."""
    if method == "kmeans":
        labels, _ = apply_kmeans(data, kwargs.get("n_clusters", kwargs.get("k", 8)))
    elif method == "meanshift":
        labels, _ = cluster_with_meanshift(data, **kwargs)
    elif method == "dbscan":
        labels = cluster_with_dbscan(data, **kwargs)
    elif method == "optics":
        labels = cluster_with_optics(data, **kwargs)
    elif method == "hdbscan":
        labels = cluster_with_hdbscan(data, **kwargs)
    else:
        raise ValueError(method)
    coords = custom_embedding if custom_embedding is not None else project_2d(data, cluster_mode)
    if out_path:
        plot_embeddings(data, labels=np.asarray(labels), method=cluster_mode, out_path=out_path)
    return np.asarray(labels), coords


def extract_query_embeddings(model) -> Dict[str, np.ndarray]:
    """The decoder's learnable query tensors of the port's model, for analysis."""
    pred = model.sem_seg_head["predictor"]
    return {
        "query_feat": pred.query_feat.detach().float().cpu().numpy(),
        "query_embed": pred.query_embed.detach().float().cpu().numpy(),
    }
