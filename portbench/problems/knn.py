"""``kind: knn`` — single-cell kNN graphs (Config E): cells as points of a
mixture in a profile space, each joined to its ``k`` nearest cells, the
tested modules being clusters of the mixture; run through
``sparse_module_preservation`` with data, the correlation statistics
computed on the fly.

The draw, all from the configuration's ``structure_seed``: every cell's
cluster (clusters of log-uniform size, cells in a shuffled order; the
first ``modules`` clusters are the tested modules, the rest the
background), each cluster's centre, per dimension normal with sd
``cluster_spread``, and each cell's point, its cluster's centre plus
standard normal noise in every dimension. The test dataset is a second
draw of the same cells: a module among the first ``preserved_share``
keeps its centre; the cells of any other module are scattered over
background clusters, so that module has no locality there. Each cell's
``k`` nearest cells (squared Euclidean distance in float64, on the card)
are its edges, weighted by a Gaussian kernel ``exp(-d² / mean_i)``, with
``mean_i`` the mean squared distance to those ``k``, as scanpy's
``pp.neighbors(method='gauss')`` weighs them; ``SparseAdjacency.from_coo``
symmetrizes. The data ``samples × nodes`` handed to the port are the
points, float32.

The run's seed numbers the cells: a permutation drawn from it relabels
every node of both datasets. A symmetrized kNN graph has hub cells whose
degree sets the width of the port's padded neighbour lists, and with it
the memory and the work of every permutation; drawn from the run's seed,
that width, the peak and the call time moved with the seed. So every seed
runs the same graphs, in its own numbering.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.check import CallAnswer
from ..reference.problems import KnnReference
from .common import call_seed, check_keys, engine_config, modules_of, seed63

#: the configuration keys this kind applies, beside ``common.COMMON_KEYS``
KEYS = ("nodes", "k", "samples", "modules", "module_size_range", "cluster_spread",
        "preserved_share")
#: rows of the distance matrix computed at once
_ROWS = 2048


def structure(cfg: dict):
    """``(cluster, centres, scatter, noise)`` from the structure seed: each
    cell's cluster (tested modules first), the clusters' centres ``(C,
    samples)``, per cell the background cluster it takes in the test
    dataset where its module is not preserved, and each dataset's noise
    ``(2, nodes, samples)``."""
    rng = np.random.default_rng(cfg["structure_seed"])
    n, lo, hi = cfg["nodes"], *cfg["module_size_range"]
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(np.exp(rng.uniform(np.log(lo), np.log(hi)))), n - sum(sizes)))
    order = rng.permutation(n)
    cluster = np.repeat(np.arange(len(sizes)), sizes)[np.argsort(order)]
    centres = rng.normal(0.0, cfg["cluster_spread"], size=(len(sizes), cfg["samples"]))
    scatter = rng.integers(cfg["modules"], len(sizes), size=n)
    noise = rng.standard_normal((2, n, cfg["samples"]))
    return cluster, centres, scatter, noise


def knn_edges(x: torch.Tensor, k: int):
    """COO ``(rows, cols, weights)`` of each point's ``k`` nearest points:
    ``x`` is ``(points, dims)`` in float64 on the card."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    cols, d2 = [], []
    for a in range(0, n, _ROWS):
        b = min(n, a + _ROWS)
        d = sq[a:b, None] + sq[None, :] - 2.0 * (x[a:b] @ x.T)
        d[torch.arange(b - a, device=x.device), torch.arange(a, b, device=x.device)] = \
            float("inf")
        v, i = torch.topk(d, k, dim=1, largest=False)
        cols.append(i)
        d2.append(v.clamp_min(0.0))
    cols, d2 = torch.cat(cols), torch.cat(d2)
    w = torch.exp(-d2 / d2.mean(1, keepdim=True).clamp_min(1e-12))
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    return (rows, cols.reshape(-1).cpu().numpy().astype(np.int64),
            w.reshape(-1).to(torch.float32).cpu().numpy())


class Session:
    """One run's inputs and calls of the port."""

    def __init__(self, cfg: dict, seed: int, device):
        from netrep_tpu_torch.ops.sparse import SparseAdjacency

        check_keys(cfg, KEYS)
        self.cfg, self.seed = cfg, seed
        self.engine = engine_config(cfg)
        self.device = torch.device(device)
        n, K = cfg["nodes"], cfg["modules"]
        cluster, centres, scatter, noise = structure(cfg)
        kept = int(K * cfg["preserved_share"])
        moved = (cluster >= kept) & (cluster < K)
        # node new[i] is cell i in this run's numbering
        new = np.random.default_rng([seed63(seed), 0xCE11]).permutation(n)
        self.coo, self.data = [], []
        for side, c in enumerate((cluster, np.where(moved, scatter, cluster))):
            pts = (centres[c] + noise[side]).astype(np.float32)
            rows, cols, w = knn_edges(torch.as_tensor(pts, device=self.device).double(),
                                      cfg["k"])
            self.coo.append((new[rows], new[cols], w))
            data = np.empty((cfg["samples"], n), dtype=np.float32)
            data[:, new] = pts.T
            self.data.append(data)
        self.adj = [SparseAdjacency.from_coo(*c, n) for c in self.coo]
        labels = np.empty(n, dtype=object)
        labels[new] = np.where(cluster < K, (cluster + 1).astype(str), "0")
        self.labels = labels
        self.modules = modules_of(labels)

    def call(self, index: int, n_perm: int, options: dict):
        """One ``sparse_module_preservation`` call with the mix's keyword
        ``options``."""
        from netrep_tpu_torch.models.sparse_api import sparse_module_preservation

        seed = call_seed(self.seed, index)
        res = sparse_module_preservation(
            self.adj[0], self.adj[1], self.labels, discovery_data=self.data[0],
            test_data=self.data[1], n_perm=n_perm, seed=seed, config=self.engine,
            device=str(self.device), **options)
        return {"seed": seed, "n_perm": n_perm, "result": res,
                "profile": dict(res.profile or {})}

    answer = staticmethod(lambda rec: CallAnswer(
        rec["seed"], rec["n_perm"], np.asarray(rec["result"].observed, np.float64),
        np.asarray(rec["result"].p_values, np.float64),
        lambda idx, r=rec["result"]: np.asarray(r.nulls)[np.asarray(idx)]))

    def reference(self):
        return KnnReference(self.coo[0], self.data[0], self.coo[1], self.data[1],
                            self.cfg["nodes"], self.modules, self.engine.summary_method,
                            self.engine.power_iters, self.device)

    def cost_shape(self) -> None:
        """No cost count: the sparse path runs no kernel of its own."""
        return None
