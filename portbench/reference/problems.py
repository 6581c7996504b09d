"""The reference's view of a cell's inputs: what a module's discovery side
is, and the test submatrices and data slices of any batch of node sets.
Built from the arrays the benchmark drew, never from the program's."""

from __future__ import annotations

import numpy as np
import torch

from .netstats import Discovery, Precision, discovery, standardize


class DenseReference:
    """Dense inputs: ``(data, correlation, network)`` of the discovery and
    the test cohort as host float64 arrays (data ``(s, n)``); the null's
    summary profile by ``method`` (``'power'`` with ``n_iter`` steps, or
    ``'eigh'``), as the configuration states."""

    def __init__(self, disc, test, modules, method: str, n_iter: int, device):
        self.disc, self.test = disc, test
        self.modules = [np.asarray(m, dtype=np.int64) for m in modules]
        self.n_pool = int(test[1].shape[0])
        self.method, self.n_iter = method, int(n_iter)
        self.device = torch.device(device)
        self._held: dict[str, tuple] = {}

    def discovery(self, k: int, prec: Precision) -> Discovery:
        idx = self.modules[k]
        data, corr, net = self.disc
        sub = np.ix_(idx, idx)
        return discovery(*(torch.as_tensor(a, device=self.device)
                           for a in (corr[sub], net[sub], data[:, idx])), prec)

    def _test(self, prec: Precision):
        if prec.name not in self._held:
            self._held.clear()
            data, corr, net = self.test
            put = lambda a: torch.as_tensor(a).to(self.device, prec.dtype)
            self._held[prec.name] = (put(corr), put(net), put(data.T).contiguous())
        return self._held[prec.name]

    def test_parts(self, idx: torch.Tensor, prec: Precision):
        corr, net, dataT = self._test(prec)
        a, b = idx[:, :, None], idx[:, None, :]
        return corr[a, b], net[a, b], dataT[idx].transpose(-1, -2)

    def release(self) -> None:
        self._held.clear()


def symmetric_edges(rows, cols, vals, n: int):
    """An undirected graph from COO triplets as a user gives them: self-loops
    and zero weights dropped, each unordered pair once ``(lo, hi, weight)``,
    a pair given more than once (in either direction) taking its last
    weight in input order."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    keep = (rows != cols) & (vals != 0)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
    key = lo * n + hi
    _, first_of_reversed = np.unique(key[::-1], return_index=True)
    last = key.size - 1 - first_of_reversed
    return lo[last], hi[last], vals[last]


class KnnReference:
    """Sparse graphs given as COO triplets, with data ``(s, n)``; a module's
    correlation submatrix is its data slice's Pearson correlation; the
    null's summary profile as in :class:`DenseReference`."""

    def __init__(self, disc_coo, disc_data, test_coo, test_data, n: int,
                 modules, method: str, n_iter: int, device):
        self.n = self.n_pool = int(n)
        self.disc_edges = symmetric_edges(*disc_coo, n)
        self.test_edges = symmetric_edges(*test_coo, n)
        self.disc_data, self.test_data = disc_data, test_data
        self.modules = [np.asarray(m, dtype=np.int64) for m in modules]
        self.method, self.n_iter = method, int(n_iter)
        self.device = torch.device(device)
        self._held: dict[str, tuple] = {}

    @staticmethod
    def _corr(data: torch.Tensor, prec: Precision) -> torch.Tensor:
        z = standardize(data)
        return prec.mm(z.transpose(-1, -2), z) / max(data.shape[-2] - 1, 1)

    def discovery(self, k: int, prec: Precision) -> Discovery:
        idx = self.modules[k]
        where = np.full(self.n, -1, dtype=np.int64)
        where[idx] = np.arange(idx.size)
        lo, hi, w = self.disc_edges
        inside = (where[lo] >= 0) & (where[hi] >= 0)
        net = np.zeros((idx.size, idx.size))
        net[where[lo[inside]], where[hi[inside]]] = w[inside]
        net[where[hi[inside]], where[lo[inside]]] = w[inside]
        data = prec.cast(torch.as_tensor(self.disc_data[:, idx], device=self.device))
        return discovery(self._corr(data, prec), torch.as_tensor(net, device=self.device),
                         data, prec)

    def _test(self, prec: Precision):
        if prec.name not in self._held:
            self._held.clear()
            lo, hi, w = (torch.as_tensor(a, device=self.device) for a in self.test_edges)
            adj = torch.zeros((self.n, self.n), dtype=torch.float32, device=self.device)
            adj[lo, hi] = w.to(torch.float32)
            adj[hi, lo] = w.to(torch.float32)
            dataT = torch.as_tensor(self.test_data.T).to(self.device, prec.dtype)
            self._held[prec.name] = (adj, dataT.contiguous())
        return self._held[prec.name]

    def test_parts(self, idx: torch.Tensor, prec: Precision):
        adj, dataT = self._test(prec)
        data = dataT[idx].transpose(-1, -2)
        net = adj[idx[:, :, None], idx[:, None, :]].to(prec.dtype)
        return self._corr(data, prec), net, data

    def release(self) -> None:
        self._held.clear()
