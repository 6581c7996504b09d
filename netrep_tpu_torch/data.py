"""Synthetic fixtures of the port: planted-module (discovery, test) pairs.

Copies of ``make_example_pair``, ``make_mixed_pair`` and ``pair_frames``
from ``netrep_tpu/data.py``: the same seed gives the same matrices as there,
so tests and ``chip_smoke.py`` feed both packages identical inputs. Every
draw comes from a seeded numpy generator.
"""

from __future__ import annotations

import zlib

import numpy as np

__all__ = ["make_example_pair", "make_mixed_pair", "pair_frames"]


def make_example_pair(
    rng: np.random.Generator,
    n_disc: int = 90,
    n_test: int = 80,
    n_overlap: int = 70,
    n_samples_disc: int = 40,
    n_samples_test: int = 35,
    module_sizes: tuple[int, ...] = (15, 12, 10, 8),
    noise: float = 0.7,
    beta: float = 2.0,
) -> dict:
    """Synthetic discovery/test co-expression pair with planted modules.

    Parameters
    ----------
    rng : numpy Generator driving every random draw.
    n_disc, n_test : node counts of the discovery / test datasets.
    n_overlap : number of discovery nodes also present in the test dataset
        (test nodes appear in shuffled order, so name-based alignment is
        exercised).
    n_samples_disc, n_samples_test : sample counts of the data matrices.
    module_sizes : planted module sizes (labels "1", "2", ...; remaining
        discovery nodes are background "0").
    noise : per-node noise level multiplier (lower = tighter modules).
    beta : soft-threshold power for the adjacency (`|corr| ** beta`).

    Returns
    -------
    dict with keys ``discovery`` / ``test`` (each ``{data, correlation,
    network, names}``), ``labels`` ({node_name: module_label}), and
    ``module_sizes`` ({label: size}).
    """
    if sum(module_sizes) > n_disc:
        raise ValueError(
            f"sum(module_sizes)={sum(module_sizes)} exceeds n_disc={n_disc}; "
            "planted modules must fit in the discovery dataset"
        )
    if not (0 <= n_overlap <= min(n_disc, n_test)):
        raise ValueError(
            f"n_overlap={n_overlap} must be between 0 and "
            f"min(n_disc, n_test)={min(n_disc, n_test)}"
        )
    names_disc = [f"g{i:04d}" for i in range(n_disc)]
    extra = [f"t{i:04d}" for i in range(n_test - n_overlap)]
    names_test = list(rng.permutation(names_disc[:n_overlap] + extra))

    labels = np.zeros(n_disc, dtype=object)
    pos = 0
    latents = {}
    for k, sz in enumerate(module_sizes, start=1):
        labels[pos: pos + sz] = str(k)
        latents[str(k)] = (
            rng.standard_normal(n_samples_disc),
            rng.standard_normal(n_samples_test),
        )
        pos += sz
    labels[pos:] = "0"

    n_planted = int(sum(module_sizes))

    def build(names, n_samples, which):
        x = rng.standard_normal((n_samples, len(names)))
        for j, nm in enumerate(names):
            if nm in names_disc[:n_planted]:
                k = labels[names_disc.index(nm)]
                if k != "0":
                    # per-node sign and noise level are deterministic in the
                    # node name, hence consistent across datasets — gives the
                    # module a heterogeneous, *preserved* degree structure
                    # (cor.degree has no signal in equal-SNR toy data).
                    sgn = 1.0 if zlib.crc32(nm.encode()) % 3 else -1.0
                    lvl = 0.35 + 1.3 * ((zlib.crc32(nm.encode()[::-1]) % 97) / 97)
                    x[:, j] = sgn * latents[k][which] + lvl * noise * x[:, j]
        corr = np.corrcoef(x, rowvar=False)
        net = np.abs(corr) ** beta
        np.fill_diagonal(net, 1.0)
        return x, corr, net

    d_data, d_corr, d_net = build(names_disc, n_samples_disc, 0)
    t_data, t_corr, t_net = build(names_test, n_samples_test, 1)

    return dict(
        discovery=dict(data=d_data, correlation=d_corr, network=d_net, names=names_disc),
        test=dict(data=t_data, correlation=t_corr, network=t_net, names=names_test),
        labels={nm: str(l) for nm, l in zip(names_disc, labels)},
        module_sizes={
            str(k): sz for k, sz in enumerate(module_sizes, start=1)
        },
    )


def make_mixed_pair(
    n_genes: int,
    n_modules: int,
    n_samples: int = 40,
    module_size: tuple[int, int] = (16, 28),
    preserved_fraction: float = 0.5,
    strength: tuple[float, float] = (0.6, 2.2),
    seed: int = 0,
) -> dict:
    """Mixed preserved/random fixture: the first ``preserved_fraction`` of
    the planted modules replicate in the test dataset, the rest are noise
    there.

    Each module is a single latent factor with *heterogeneous per-node
    loadings* drawn once and reused in the test dataset for preserved
    modules — equal loadings would leave the within-module correlation
    pattern flat and ``cor.cor``/``cor.degree`` without signal. Preserved
    modules come out significant on every statistic; random modules on
    none.

    Returns ``{discovery, test, specs, pool}`` where ``discovery``/``test``
    are ``(data, correlation, network)`` float32 triples, ``specs`` is the
    aligned ``(label, indices)`` module list (labels "1", "2", ... in
    planted order: preserved first), and ``pool`` is the full node range.
    """
    rng = np.random.default_rng(seed)
    sizes = rng.integers(module_size[0], module_size[1] + 1, size=n_modules)
    if int(sizes.sum()) > n_genes:
        raise ValueError(
            f"planted modules ({int(sizes.sum())} nodes) exceed "
            f"n_genes={n_genes}"
        )
    n_preserved = int(round(preserved_fraction * n_modules))
    xd = rng.standard_normal((n_samples, n_genes))
    xt = rng.standard_normal((n_samples, n_genes))
    specs, pos = [], 0
    for k, sz in enumerate(sizes):
        load = rng.uniform(*strength, size=int(sz))
        xd[:, pos: pos + sz] += rng.standard_normal((n_samples, 1)) * load
        if k < n_preserved:
            xt[:, pos: pos + sz] += rng.standard_normal((n_samples, 1)) * load
        specs.append((str(k + 1), np.arange(pos, pos + sz, dtype=np.int32)))
        pos += sz

    def mats(x):
        corr = np.corrcoef(x, rowvar=False)
        np.fill_diagonal(corr, 1.0)
        return (
            x.astype(np.float32),
            corr.astype(np.float32),
            (np.abs(corr) ** 2).astype(np.float32),
        )

    return dict(
        discovery=mats(xd),
        test=mats(xt),
        specs=specs,
        pool=np.arange(n_genes, dtype=np.int32),
        n_preserved=n_preserved,
    )


def pair_frames(pair: dict) -> tuple[dict, dict]:
    """Package a :func:`make_example_pair` result as the pandas inputs
    (named nodes) ``module_preservation`` takes — the one shared copy of
    this transform for tests, docs, and notebooks. Lives here (not in a
    test conftest) so imports are path-stable under any pytest import mode.
    """
    import pandas as pd

    def mk(ds):
        names = ds["names"]
        return dict(
            data=pd.DataFrame(ds["data"], columns=names),
            correlation=pd.DataFrame(ds["correlation"], index=names,
                                     columns=names),
            network=pd.DataFrame(ds["network"], index=names, columns=names),
        )

    return mk(pair["discovery"]), mk(pair["test"])
