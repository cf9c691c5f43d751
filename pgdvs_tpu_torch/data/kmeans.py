"""K-means for the DyCheck reader's spatial source selection.

The JAX package's DyCheck reader clusters the train camera centres with
``sklearn.cluster.KMeans(n_clusters, random_state=0, n_init="auto")``; the
card's machine has no scikit-learn, so the port carries this copy of what
that call does (scikit-learn 1.9, dense input, unit sample weights), in
numpy on the host:

* the data's dtype (float32 or float64, what the reader's camera centres
  are) is the dtype of every step; other dtypes become float64;
* the data centred on its mean, ``tol = 1e-4 * mean(var(X, axis=0))``;
* k-means++ from ``np.random.RandomState(seed)``: the first centre by
  ``choice(n, p=w / w.sum())``, then ``2 + int(log k)`` local trials per
  centre drawn by ``uniform(trials) * potential`` and ``searchsorted`` on the
  cumulative squared distances, the trial that lowers the potential most
  kept; its squared distances computed in float64 and stored in the data's
  dtype, as ``_euclidean_distances_upcast`` does;
* n_init "auto" = one run of Lloyd's algorithm, at most 300 iterations:
  labels from ``|c|^2 - 2 x.c`` (first minimum), centres as the per-cluster
  sums (in sample order, partial sums per chunk of 256 samples) times
  ``1 / weight``, empty clusters relocated to the samples farthest from
  their centres; stopping on unchanged labels or a squared centre shift at
  or under ``tol``, then one more labelling pass if the labels still moved.

Sums of more than one chunk (256 samples) and BLAS's summation order may
differ from scikit-learn's in the last bits, which moves centres by ~1e-7
and labels only at exact ties.
"""

from __future__ import annotations

import numpy as np

CHUNK = 256


def _sq_dists_upcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances [len(a), len(b)] in float64, stored in the inputs'
    dtype, clamped at 0 (``_euclidean_distances`` with squared=True)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    return np.maximum(d.astype(a.dtype, copy=False), 0)


def kmeans_plusplus(x: np.ndarray, k: int, rs: np.random.RandomState) -> np.ndarray:
    """k-means++ initial centres [k, F] of the (centred) data."""
    n = x.shape[0]
    w = np.ones(n, dtype=x.dtype)
    n_trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rs.choice(n, p=w / w.sum())]
    closest = _sq_dists_upcast(centers[0, np.newaxis], x)
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=n_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d_cand = _sq_dists_upcast(x[cand], x)
        np.minimum(closest, d_cand, out=d_cand)
        cand_pot = d_cand @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = d_cand[best]
        centers[c] = x[cand[best]]
    return centers


def _labels(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest centre of each sample by ``|c|^2 - 2 x.c`` (first minimum)."""
    cn = np.einsum("ij,ij->i", centers, centers)
    return np.argmin(cn[None, :] + (-2.0 * (x @ centers.T)).astype(x.dtype),
                     axis=1).astype(np.int32)


def _lloyd_step(x, centers):
    """One E + M step: (labels, new centres, squared-shift total)."""
    k, f = centers.shape
    labels = _labels(x, centers)
    sums = np.zeros((k, f), x.dtype)
    weight = np.zeros(k, x.dtype)
    for start in range(0, x.shape[0], CHUNK):
        part = np.zeros((k, f), x.dtype)
        np.add.at(part, labels[start:start + CHUNK], x[start:start + CHUNK])
        sums += part
        np.add.at(weight, labels[start:start + CHUNK], 1)
    empty = np.nonzero(weight == 0)[0]
    if empty.size:
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
        if dist.max() != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                sums[old_id] -= x[far_idx]
                sums[new_id] = x[far_idx]
                weight[new_id] = 1
                weight[old_id] -= 1
    new = sums.copy()
    biggest = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            new[j] *= x.dtype.type(1.0) / weight[j]
        else:
            new[j] = new[biggest]
    shift = np.array([np.sqrt(np.sum((new[j] - centers[j]) ** 2, dtype=x.dtype))
                      for j in range(k)], x.dtype)
    return labels, new, float((shift ** 2).sum())


class KMeans:
    """``KMeans(n_clusters, random_state=seed).fit(x)``: ``labels_`` and
    ``cluster_centers_`` as scikit-learn 1.9's k-means++ / Lloyd with
    n_init "auto" gives them (module docstring)."""

    def __init__(self, n_clusters: int, random_state: int = 0, max_iter: int = 300,
                 tol: float = 1e-4):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, x) -> "KMeans":
        x = np.array(x, copy=True)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        if x.shape[0] < self.n_clusters:
            raise ValueError(f"n_samples={x.shape[0]} should be >= "
                             f"n_clusters={self.n_clusters}.")
        tol = np.mean(np.var(x, axis=0)) * self.tol
        mean = x.mean(axis=0)
        x -= mean
        centers = kmeans_plusplus(x, self.n_clusters, np.random.RandomState(self.random_state))
        labels_old = np.full(x.shape[0], -1, np.int32)
        strict = False
        for it in range(self.max_iter):
            labels, centers, shift = _lloyd_step(x, centers)
            self.n_iter_ = it + 1
            if np.array_equal(labels, labels_old):
                strict = True
                break
            if shift <= tol:
                break
            labels_old = labels
        if not strict:
            labels = _labels(x, centers)
        self.labels_ = labels
        self.cluster_centers_ = centers + mean
        return self
