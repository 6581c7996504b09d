"""``kind: dense`` — cohorts of genes with planted co-expression modules,
handed to ``module_preservation`` as host float64 ``(data, correlation,
network)`` arrays, as the R shim hands them.

The generator is a copy of ``chip_smoke.py``'s ``make_cohorts`` and
``mats`` at commit 53bdfe689d3220fe33f3e7b7699923adc36ce31a, changed in
two ways: the structure (module sizes, gene order) comes from the
configuration's ``structure_seed``, so every run does the same work per
permutation, and the values (noise, loadings, module factors) come from the
run's seed, drawn on the card in float64 in a few large calls. Module
``k`` adds a shared factor times per-gene loadings to its genes in the
discovery cohort, and, for the first ``preserved_share`` of the modules, in
the test cohort too. The configuration's ``storage``, ``tf32`` and
``engine`` settings are what the port runs with.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.check import CallAnswer
from ..reference.problems import DenseReference
from .common import WIDTH, call_seed, check_keys, engine_config, modules_of, seed63

#: the two cohorts' dataset names: the discovery and the test
NAMES = ("disc", "test")
#: the configuration keys this kind applies, beside ``common.COMMON_KEYS``
KEYS = ("genes", "samples", "modules", "module_size_range", "preserved_share",
        "loading_range", "beta")


def structure(cfg: dict):
    """``(sizes, order)``: module sizes and the gene order modules take
    their genes from, from the structure seed."""
    rng = np.random.default_rng(cfg["structure_seed"])
    lo, hi = cfg["module_size_range"]
    sizes = rng.integers(lo, hi + 1, size=cfg["modules"])
    order = rng.permutation(cfg["genes"])
    return sizes, order


def draw_cohorts(cfg: dict, seed: int, device) -> tuple[list, np.ndarray]:
    """The discovery's and the test cohort's data ``(samples, genes)`` on
    ``device`` in float64, and the node labels."""
    sizes, order = structure(cfg)
    n, s, K, C = cfg["genes"], cfg["samples"], cfg["modules"], len(NAMES)
    g = torch.Generator(device=device)
    g.manual_seed(seed63(seed))
    x = torch.randn((C, s, n), generator=g, dtype=torch.float64, device=device)
    lo, hi = cfg["loading_range"]
    loads = torch.empty(int(sizes.sum()), dtype=torch.float64, device=device)
    loads.uniform_(lo, hi, generator=g)
    factors = torch.randn((C, K, s), generator=g, dtype=torch.float64, device=device)
    labels = np.full(n, "0", dtype=object)
    kept = int(K * cfg["preserved_share"])
    at = 0
    for k, sz in enumerate(sizes):
        nodes = torch.as_tensor(order[at:at + sz], device=device)
        load = loads[at:at + sz]
        at += sz
        labels[order[at - sz:at]] = str(k + 1)
        for c in range(C):
            if c == 0 or k < kept:
                x[c][:, nodes] += factors[c, k][:, None] * load[None, :]
    return list(x), labels


def matrices(x: torch.Tensor, beta: float):
    """``(correlation, network)`` of one cohort: the genes' Pearson
    correlation and ``|corr| ** beta``, in float64 on ``x``'s device."""
    z = (x - x.mean(0)) / x.std(0)
    c = (z.T @ z) / (x.shape[0] - 1)
    c = (c + c.T) * 0.5
    c.fill_diagonal_(1.0)
    c.clamp_(-1.0, 1.0)
    return c, c.abs() ** beta


class Session:
    """One run's inputs and calls of the port."""

    def __init__(self, cfg: dict, seed: int, device):
        check_keys(cfg, KEYS)
        self.cfg, self.seed = cfg, seed
        self.engine = engine_config(cfg)
        self.device = torch.device(device)
        x, self.labels = draw_cohorts(cfg, seed, self.device)
        self.cohorts = []
        for c in range(len(NAMES)):
            corr, net = matrices(x[c], cfg["beta"])
            self.cohorts.append(tuple(a.cpu().numpy() for a in (x[c], corr, net)))
            del corr, net
        del x
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.modules = modules_of(self.labels)

    def call(self, index: int, n_perm: int, options: dict):
        """One ``module_preservation`` call of the discovery against the
        test cohort, with the mix's keyword ``options``."""
        from netrep_tpu_torch.models.preservation import module_preservation

        seed = call_seed(self.seed, index)
        res = module_preservation(
            network={k: c[2] for k, c in zip(NAMES, self.cohorts)},
            data={k: c[0] for k, c in zip(NAMES, self.cohorts)},
            correlation={k: c[1] for k, c in zip(NAMES, self.cohorts)},
            module_assignments=list(self.labels), discovery=NAMES[0], test=NAMES[1],
            n_perm=n_perm, seed=seed, config=self.engine, device=str(self.device),
            **options)
        return {"seed": seed, "n_perm": n_perm, "result": res,
                "profile": dict(res.profile or {})}

    @staticmethod
    def answer(rec: dict) -> CallAnswer:
        res = rec["result"]
        nulls = res.nulls
        return CallAnswer(
            rec["seed"], rec["n_perm"], np.asarray(res.observed, np.float64),
            np.asarray(res.p_values, np.float64),
            (lambda idx: None) if nulls is None
            else (lambda idx: np.asarray(nulls)[np.asarray(idx)]))

    def reference(self):
        return DenseReference(self.cohorts[0], self.cohorts[1], self.modules,
                              self.engine.summary_method, self.engine.power_iters,
                              self.device)

    def cost_shape(self) -> dict:
        """What the cost count needs: module sizes, samples, power steps,
        stored test matrices (one where the network derives from the
        correlation), storage width, chunk."""
        return {"sizes": [int(m.size) for m in self.modules],
                "samples": self.cfg["samples"], "power_iters": self.engine.power_iters,
                "n_mats": 1 if self.engine.network_from_correlation else 2,
                "width": WIDTH[self.engine.dtype], "chunk": self.engine.chunk_size}
