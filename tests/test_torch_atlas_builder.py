"""The port's atlas tile network builder (``netrep_tpu_torch.atlas``:
``TiledNetwork``, ``build_sparse_network`` with exact tile screening)
against the JAX package's on the same numpy inputs, ``device="cpu"``.

Fixtures are the JAX tests': ``default_rng(3)`` 20 samples × 300 genes
with four planted modules (``tests/test_atlas.py``; edge 64 leaves a
44-column tail tile) and the 512-gene, 40-sample, 8-group grouped-support
data (``tests/test_atlas_screen.py``), where screening skips most tiles.

Against the JAX build: the same selected edges in the same emit order
(read from each package's final checkpoint, whose ``x_atlas_*`` extras
hold the COO list as the pass emitted it), r and weights within 1e-6,
degree within 1e-5 (float32 per-tile row sums in another order; 7.6e-6
measured, about 2 float32 steps of a degree near 32), and equal
``selected_edges`` and tile tallies. The tile plane is host numpy in both
packages, so its arrays are equal bit for bit. Within the port, bit for
bit: screened and unscreened builds, interrupted-and-resumed and
uninterrupted builds (across a screening toggle too), and a 2-way CPU mesh
and the unsplit build. Error texts equal the JAX package's.

An atlas checkpoint crosses packages: both fingerprint strings digest the
spec through ``content_digest``, which agrees, and the file format is
shared, so a JAX-written interrupted build resumes in the port (and the
other way round) to the resuming package's uninterrupted edges.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import netrep_tpu  # noqa: E402
from netrep_tpu.atlas import TiledNetwork as JTiled  # noqa: E402
from netrep_tpu.atlas import build_sparse_network as jbuild  # noqa: E402
from netrep_tpu.atlas import builder as jbuilder  # noqa: E402
from netrep_tpu.atlas import tiles as jtiles  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.atlas import (  # noqa: E402
    TiledNetwork, build_sparse_network, derived_net_np, supertile_maxima,
    tile_norm_maxima,
)
from netrep_tpu_torch.atlas import builder as tbuilder  # noqa: E402
from netrep_tpu_torch.models.sparse_api import sparse_module_preservation  # noqa: E402
from netrep_tpu_torch.ops.sparse import SparseAdjacency  # noqa: E402
from netrep_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

BETA = 2.0
EDGE = 64
JCFG = JConfig(autotune=False)
R_TOL = 1e-6
DEG_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: beside other test
    processes, torch's per-core thread pool only contends for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def grouped_support(genes, samples, groups, seed=0):
    """``tests/test_atlas_screen.py``'s cell-type-block data: each gene
    expressed in one sample block over a small everywhere-noise floor."""
    rng = np.random.default_rng(seed)
    x = 0.01 * rng.standard_normal((samples, genes))
    gsz, ssz = genes // groups, samples // groups
    for g in range(groups):
        c0, c1 = g * gsz, (g + 1) * gsz if g < groups - 1 else genes
        r0, r1 = g * ssz, (g + 1) * ssz if g < groups - 1 else samples
        blk = rng.standard_normal((r1 - r0, c1 - c0))
        fac = rng.standard_normal(r1 - r0)
        blk += 1.5 * fac[:, None] * (rng.random(c1 - c0) < 0.5)
        x[r0:r1, c0:c1] += blk - blk.mean(axis=0)
    return x


def planted():
    """``tests/test_atlas.py``'s ``atlas_data``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((20, 300))
    for k in range(4):
        x[:, k * 22:(k + 1) * 22] += 1.2 * rng.standard_normal(20)[:, None]
    return x


DATA = {"planted": planted(), "structured": grouped_support(512, 40, 8,
                                                            seed=11)}
RULES = {"topk": dict(top_k=6), "tau": dict(tau=0.3)}


def dense_r(x):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = np.corrcoef(x, rowvar=False)
    np.fill_diagonal(r, 0.0)
    return r


def port(x, **kw):
    kw.setdefault("tile_edge", EDGE)
    return build_sparse_network(TiledNetwork.from_data(x, BETA),
                                device="cpu", **kw)


def jax_(x, **kw):
    kw.setdefault("tile_edge", EDGE)
    return jbuild(JTiled.from_data(x, BETA), config=JCFG, **kw)


def coo(path):
    """The emitted COO list a pass's final checkpoint holds."""
    with np.load(path) as z:
        return {k[8:]: z[k] for k in z.files if k.startswith("x_atlas_")}


def same_build(a, b):
    """Bit-equal outputs of two builds of the port."""
    for name in ("adjacency", "correlation"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert np.array_equal(ga.nbr, gb.nbr)
        assert np.array_equal(ga.wgt, gb.wgt)
    assert a.selected_edges == b.selected_edges
    if a.degree is None or b.degree is None:
        assert a.degree is None and b.degree is None
    else:
        assert np.array_equal(a.degree, b.degree)


def interrupt_at(stop):
    def progress(done, total):
        if done == stop:
            raise KeyboardInterrupt
    return progress


def same_error(port_call, jax_call, exc=ValueError):
    with pytest.raises(exc) as et:
        port_call()
    with pytest.raises(exc) as ej:
        jax_call()
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the build against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("screen", (False, True), ids=("plain", "screened"))
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("data", DATA)
def test_build_equals_jax(data, rule, screen, tmp_path):
    x = DATA[data]
    kw = dict(RULES[rule], screen=screen, checkpoint_every=1)
    pt = port(x, checkpoint_path=str(tmp_path / "port.npz"), **kw)
    jx = jax_(x, checkpoint_path=str(tmp_path / "jax.npz"), **kw)
    # the selected (row, col) pairs in the emit order
    cp, cj = coo(tmp_path / "port.npz"), coo(tmp_path / "jax.npz")
    assert np.array_equal(cp["rows"], cj["rows"])
    assert np.array_equal(cp["cols"], cj["cols"])
    np.testing.assert_allclose(cp["corr"], cj["corr"], rtol=0, atol=R_TOL)
    for name in ("adjacency", "correlation"):
        gp, gj = getattr(pt, name), getattr(jx, name)
        assert np.array_equal(gp.nbr, gj.nbr)
        np.testing.assert_allclose(gp.wgt, gj.wgt, rtol=0, atol=R_TOL)
    if screen:
        assert pt.degree is None and jx.degree is None
    else:
        np.testing.assert_allclose(pt.degree, jx.degree, rtol=0,
                                   atol=DEG_TOL)
    for f in ("n", "tile_edge", "n_blocks", "selected_edges", "supertile",
              "tiles_total", "tiles_dispatched", "tiles_skipped",
              "strip_bytes_full"):
        assert getattr(pt, f) == getattr(jx, f), f
    if rule == "topk":
        # the same arrays cross to the host (τ: the port sends survivors
        # only, the JAX package a fixed capacity)
        assert pt.strip_bytes_moved == jx.strip_bytes_moved
    if screen and data == "structured":
        assert pt.tiles_skipped > 0


def test_topk_matches_dense_reference():
    """The per-row top-k of the dense float64 correlation, stable order,
    and the degree over the whole derived network."""
    x, k = DATA["planted"], 6
    build = port(x, top_k=k)
    r = dense_r(x)
    net = derived_net_np(r, BETA)
    n = x.shape[1]
    rows, cols, vals = [], [], []
    for i in range(n):
        order = np.argsort(-np.abs(r[i]), kind="stable")[:k]
        rows += [i] * k
        cols += list(order)
        vals += list(net[i, order])
    ref = SparseAdjacency.from_coo(rows, cols, vals, n, symmetrize=True)
    got, want = build.adjacency.to_dense(), ref.to_dense()
    assert ((got != 0) == (want != 0)).all()
    np.testing.assert_allclose(got, want, atol=R_TOL)
    np.testing.assert_allclose(build.degree, net.sum(axis=1), atol=DEG_TOL)
    assert build.selected_edges == n * k


def test_tau_matches_dense_reference():
    x, tau = DATA["structured"], 0.3
    build = port(x, tau=tau, screen=True)
    r = dense_r(x)
    sel = np.abs(r) >= tau
    got = build.correlation.to_dense()
    assert ((got != 0) == (sel | sel.T)).all()
    np.testing.assert_allclose(got[sel], r[sel], atol=R_TOL)
    assert build.adjacency.nnz == build.correlation.nnz


# ---------------------------------------------------------------------------
# within the port, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("data", DATA)
def test_screened_equals_unscreened(data, rule):
    x = DATA[data]
    plain = port(x, degree=False, **RULES[rule])
    screened = port(x, screen=True, **RULES[rule])
    same_build(plain, screened)
    assert screened.tiles_dispatched + screened.tiles_skipped == \
        screened.tiles_total
    if data == "structured":
        assert screened.tiles_skipped / screened.tiles_total >= 0.5
        assert 0 < screened.strip_bytes_moved < screened.strip_bytes_full


@pytest.mark.parametrize("rule", RULES)
def test_interrupt_resume_equals_uninterrupted(rule, tmp_path):
    x = DATA["planted"]
    full = port(x, **RULES[rule])
    ck = str(tmp_path / "atlas.npz")
    with pytest.raises(KeyboardInterrupt):
        port(x, checkpoint_path=ck, checkpoint_every=1,
             progress=interrupt_at(2), **RULES[rule])
    with np.load(ck) as z:
        assert {k for k in z.files if k.startswith("x_atlas_")} == {
            "x_atlas_rows", "x_atlas_cols", "x_atlas_corr",
            "x_atlas_tiles_dispatched", "x_atlas_tiles_skipped",
            "x_atlas_bytes_full", "x_atlas_bytes_moved",
        }
        assert int(z["completed"]) == 2
    resumed = port(x, checkpoint_path=ck, checkpoint_every=1, **RULES[rule])
    same_build(resumed, full)
    for f in ("tiles_dispatched", "tiles_skipped", "strip_bytes_full",
              "strip_bytes_moved"):
        assert getattr(resumed, f) == getattr(full, f), f


@pytest.mark.parametrize("first,second", [(True, False), (False, True)],
                         ids=["screened-then-plain", "plain-then-screened"])
def test_resume_across_screening_toggle(first, second, tmp_path):
    x = DATA["structured"]
    kw = dict(top_k=5, degree=False)
    full = port(x, **kw)
    ck = str(tmp_path / "atlas.npz")
    with pytest.raises(KeyboardInterrupt):
        port(x, screen=first, checkpoint_path=ck, checkpoint_every=1,
             progress=interrupt_at(3), **kw)
    resumed = port(x, screen=second, checkpoint_path=ck, checkpoint_every=1,
                   **kw)
    same_build(resumed, full)
    assert resumed.tiles_dispatched + resumed.tiles_skipped == \
        resumed.tiles_total


def test_screened_tau_interrupt_resumes_screened(tmp_path):
    x = DATA["structured"]
    kw = dict(tau=0.3, screen=True)
    full = port(x, **kw)
    ck = str(tmp_path / "atlas.npz")
    with pytest.raises(KeyboardInterrupt):
        port(x, checkpoint_path=ck, checkpoint_every=1,
             progress=interrupt_at(2), **kw)
    resumed = port(x, checkpoint_path=ck, checkpoint_every=1, **kw)
    same_build(resumed, full)
    assert resumed.tiles_skipped == full.tiles_skipped
    assert resumed.tiles_dispatched == full.tiles_dispatched


@pytest.mark.parametrize("screen", (False, True), ids=("plain", "screened"))
@pytest.mark.parametrize("rule", RULES)
def test_two_way_mesh_equals_unsplit(rule, screen):
    """The product calls split over a 2-way ``perm`` axis (two CPU
    devices; ``tiles.T`` covers two calls at edge 64, so each device
    runs one)."""
    x = DATA["structured"]
    mesh = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    kw = dict(RULES[rule], screen=screen)
    single = port(x, **kw)
    split = port(x, mesh=mesh, **kw)
    same_build(split, single)
    assert split.tiles_skipped == single.tiles_skipped


def test_every_tile_runs_through_one_call_shape(monkeypatch):
    """The exactness of screening rests on one product shape: every
    ``torch.bmm`` of a screened and an unscreened pass takes
    ``(TILE_BATCH, edge, s) × (TILE_BATCH, s, edge)``."""
    shapes = set()
    real = torch.bmm

    def spy(a, b):
        shapes.add((tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "bmm", spy)
    x = DATA["structured"]
    port(x, top_k=6, degree=False)
    port(x, top_k=6, screen=True)
    port(x, tau=0.3, screen=True)
    tb, s = tbuilder.TILE_BATCH, x.shape[0]
    assert shapes == {((tb, EDGE, s), (tb, s, EDGE))}


# ---------------------------------------------------------------------------
# screening's exactness (property test, the JAX package's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(top_k=6), dict(tau=0.3)],
                         ids=["topk", "tau"])
@pytest.mark.parametrize("seed,genes,samples,groups", [
    (11, 512, 40, 8),      # structured: screening fires
    (3, 300, 20, 1),       # unstructured noise + modules: bounds near 1
])
def test_skipped_tiles_provably_below_threshold(kw, seed, genes, samples,
                                                groups):
    """At the moment a tile is skipped, its true max |r| (dense float64)
    is strictly below the threshold the skip was judged against, at the
    coarse and the refine level, for the τ cut and the running top-k
    floor."""
    if groups == 1:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((samples, genes))
        for k in range(4):
            x[:, k * 22:(k + 1) * 22] += (
                1.2 * rng.standard_normal(samples)[:, None]
            )
    else:
        x = grouped_support(genes, samples, groups, seed=seed)
    r = np.abs(dense_r(x))
    skips = []

    def observer(block, level, tiles, threshold):
        skips.append((block, level, np.asarray(tiles), float(threshold)))

    port(x, screen=True, supertile=3, screen_segments=8,
         _screen_observer=observer, **kw)
    checked = 0
    for block, level, tiles, threshold in skips:
        lo, hi = block * EDGE, min((block + 1) * EDGE, genes)
        for t in tiles:
            c0, c1 = t * EDGE, min((t + 1) * EDGE, genes)
            assert float(r[lo:hi, c0:c1].max()) < threshold, (
                f"block {block} skipped tile {t} at {level} level with "
                f"threshold {threshold} but true max |r| is "
                f"{r[lo:hi, c0:c1].max()}"
            )
            checked += 1
    if groups > 1:
        assert checked > 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ("neither", "both", "tau_zero", "top_k_zero",
                                  "screen_degree"))
def test_refusals_are_jax_texts(case):
    x = DATA["planted"]
    kw = {"neither": {}, "both": dict(top_k=4, tau=0.5),
          "tau_zero": dict(tau=0.0), "top_k_zero": dict(top_k=0),
          "screen_degree": dict(top_k=4, screen=True, degree=True)}[case]
    same_error(lambda: port(x, **kw), lambda: jax_(x, **kw))


@pytest.mark.parametrize("change", ("beta", "rule", "k", "degree"))
def test_checkpoint_of_another_problem_is_refused(change, tmp_path):
    x = DATA["planted"]
    ck = str(tmp_path / "atlas.npz")
    with pytest.raises(KeyboardInterrupt):
        port(x, top_k=5, checkpoint_path=ck, progress=interrupt_at(1))
    if change == "beta":
        call = lambda: build_sparse_network(  # noqa: E731
            TiledNetwork.from_data(x, 3.0), top_k=5, tile_edge=EDGE,
            checkpoint_path=ck, device="cpu")
    else:
        kw = {"rule": dict(tau=0.5), "k": dict(top_k=6),
              "degree": dict(top_k=5, degree=False)}[change]
        call = lambda: port(x, checkpoint_path=ck, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="different problem"):
        call()


@pytest.mark.parametrize("name", ("telemetry", "fault_policy"))
def test_later_keywords_name_their_item(name):
    with pytest.raises(NotImplementedError,
                       match=f"{name}= is not ported yet: ROADMAP.md Queue 1 "
                             "item 16 "):
        port(DATA["planted"], top_k=4, **{name: object()})


def test_no_card_means_no_build():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sparse_network(TiledNetwork.from_data(DATA["planted"], BETA),
                             top_k=4)


def test_degree_defaults_follow_screen():
    x = DATA["structured"]
    assert port(x, top_k=4, screen=True).degree is None
    un = port(x, top_k=4)
    assert un.degree is not None and un.degree.shape == (x.shape[1],)


# ---------------------------------------------------------------------------
# the tile plane and the host helpers against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "beta", (2.0, (3.0, "signed"), [2.0, "signed-hybrid"]),
    ids=("unsigned", "signed", "hybrid"))
def test_tiled_network_equals_jax(beta):
    x = DATA["planted"]
    tp, tj = TiledNetwork.from_data(x, beta), JTiled.from_data(x, beta)
    assert np.array_equal(tp.xc, tj.xc)
    assert np.array_equal(tp.stddev, tj.stddev)
    assert tp.beta == tj.beta
    assert np.array_equal(tp.z32(), tj.z32())
    assert tp.spec_digest() == tj.spec_digest()
    I, J = np.arange(10, 74), slice(250, 300)
    assert np.array_equal(tp.corr_tile(I, J), tj.corr_tile(I, J))
    assert np.array_equal(tp.adjacency_tile(I, J), tj.adjacency_tile(I, J))
    r = tp.corr_tile(I, J)
    assert np.array_equal(derived_net_np(r, beta),
                          jtiles.derived_net_np(r, beta))


@pytest.mark.parametrize("segments", (1, 3, 8, 64))
def test_moments_and_bound_tables_equal_jax(segments):
    x = DATA["structured"]
    tp, tj = TiledNetwork.from_data(x, BETA), JTiled.from_data(x, BETA)
    A = tp.column_moments(segments)
    assert A is tp.column_moments(segments)          # memoized
    assert np.array_equal(A, tj.column_moments(segments))
    for edge, n_tiles in ((64, 8), (100, 6), (48, 11)):
        M = tile_norm_maxima(A, edge, n_tiles)
        assert np.array_equal(M, jtiles.tile_norm_maxima(A, edge, n_tiles))
        for f in (1, 3, 8):
            assert np.array_equal(supertile_maxima(M, f),
                                  jtiles.supertile_maxima(M, f))


def test_degenerate_tiles_keep_corrcoefs_nan_mask():
    """``tests/test_degenerate_inputs.py``'s pin on the port: a constant
    gene makes NaN exactly where ``np.corrcoef`` puts them across a ragged
    tile grid (edge 16 over 40 columns), finite values to float64
    rounding; the tiles equal the JAX package's bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((30, 40))
    x[:, 5] = 2.5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = np.corrcoef(x, rowvar=False)
    tp = TiledNetwork.from_data(x, 2.0, allow_degenerate=True)
    tj = JTiled.from_data(x, 2.0, allow_degenerate=True)
    n, edge = x.shape[1], 16
    got = np.empty((n, n))
    for i0 in range(0, n, edge):
        I = np.arange(i0, min(i0 + edge, n))
        for j0 in range(0, n, edge):
            J = np.arange(j0, min(j0 + edge, n))
            tile = tp.corr_tile(I, J)
            assert np.array_equal(tile, tj.corr_tile(I, J), equal_nan=True)
            got[np.ix_(I, J)] = tile
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-12)
    assert (tp.z32()[5] == 0).all()


@pytest.mark.parametrize("case", ("dims", "samples", "nonfinite", "constant",
                                  "names_len", "names_dup", "beta"))
def test_from_data_refusals_are_jax_texts(case):
    x = DATA["planted"][:, :30].copy()
    kw, beta = {}, BETA
    if case == "dims":
        x = x[0]
    elif case == "samples":
        x = x[:1]
    elif case == "nonfinite":
        x[3, 4] = np.nan
    elif case == "constant":
        x[:, [2, 7]] = 1.5
    elif case == "names_len":
        kw = dict(names=["a"] * 3)
    elif case == "names_dup":
        kw = dict(names=["g"] * 30)
    else:
        beta = 0.0
    same_error(lambda: TiledNetwork.from_data(x, beta, **kw),
               lambda: JTiled.from_data(x, beta, **kw))


def test_host_helpers_equal_jax():
    for s in (2, 40, 1000):
        assert tbuilder._bound_margin(s) == jbuilder._bound_margin(s)
    for tau in (0.1, 0.3, 0.45, 1 / 3, 0.9999999):
        assert tbuilder._tau_ceil32(tau) == jbuilder._tau_ceil32(tau)
    for n_work in (1, 3, 8, 9, 33):
        for ax in (1, 2, 3):
            assert tbuilder._bucket_width(n_work, ax) == \
                jbuilder._bucket_width(n_work, ax)
    rng = np.random.default_rng(5)
    m, k = 12, 4
    cv = np.sort(rng.random((m, k)).astype(np.float32), axis=1)[:, ::-1]
    cc = rng.integers(0, 50, (m, k)).astype(np.int64)
    cr = rng.standard_normal((m, k)).astype(np.float32)
    # ties against the running candidates, and empty slots
    nv = np.concatenate([cv[:, :2], np.full((m, 2), -1, np.float32)], axis=1)
    nc = np.concatenate([cc[:, :2] + 1, np.full((m, 2), jbuilder._COL_SENTINEL,
                                                np.int64)], axis=1)
    nr = rng.standard_normal((m, k)).astype(np.float32)
    for a, b in zip(tbuilder._merge_topk(cv, cc, cr, nv, nc, nr, k),
                    jbuilder._merge_topk(cv, cc, cr, nv, nc, nr, k)):
        assert np.array_equal(a, b)
    assert tbuilder._COL_SENTINEL == jbuilder._COL_SENTINEL
    assert np.array_equal(tbuilder._KEY_DATA, jbuilder._KEY_DATA)


def test_topk_key_keeps_lax_top_k_tie_order():
    """Equal scores come out by ascending position, -1 slots last, as
    ``lax.top_k`` orders them."""
    score = torch.tensor([[0.5, 0.7, 0.5, -1.0, 0.7, 0.0, 0.5, -1.0]])
    r = torch.arange(8, dtype=torch.float32)[None] / 10
    idx, r_sel, vals = tbuilder._topk(r, score, 8)
    assert idx.tolist() == [[1, 4, 0, 2, 6, 5, 3, 7]]
    assert np.array_equal(vals, score.numpy()[:, idx[0]])
    assert np.array_equal(r_sel, r.numpy()[:, idx[0]])


# ---------------------------------------------------------------------------
# checkpoints across packages, and the bridge to the sparse engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ("jax", "port"))
@pytest.mark.parametrize("screen", (False, True), ids=("plain", "screened"))
def test_checkpoint_crosses_packages(writer, screen, tmp_path):
    """A build interrupted in one package resumes in the other to the
    resuming package's uninterrupted edges and emit order, r within
    1e-6."""
    x = DATA["structured"]
    kw = dict(top_k=5, screen=screen, degree=False, checkpoint_every=1)
    first, second = (jax_, port) if writer == "jax" else (port, jax_)
    ck = str(tmp_path / "atlas.npz")
    with pytest.raises(KeyboardInterrupt):
        first(x, checkpoint_path=ck, progress=interrupt_at(3), **kw)
    resumed = second(x, checkpoint_path=ck, **kw)
    full_ck = str(tmp_path / "full.npz")
    full = second(x, checkpoint_path=full_ck, **kw)
    a, b = coo(ck), coo(full_ck)
    assert np.array_equal(a["rows"], b["rows"])
    assert np.array_equal(a["cols"], b["cols"])
    np.testing.assert_allclose(a["corr"], b["corr"], rtol=0, atol=R_TOL)
    assert np.array_equal(resumed.correlation.nbr, full.correlation.nbr)
    np.testing.assert_allclose(resumed.correlation.wgt, full.correlation.wgt,
                               rtol=0, atol=R_TOL)
    assert resumed.tiles_dispatched + resumed.tiles_skipped == \
        resumed.tiles_total


def test_bridge_to_sparse_engine_equals_jax():
    """``tests/test_atlas.py``'s bridge: the build's adjacency and the data
    go into ``sparse_module_preservation``; counts and p-values equal the
    JAX package's run of its own build."""
    x = DATA["planted"]
    assign = {f"node_{i}": "0" for i in range(x.shape[1])}
    for k in range(4):
        for i in range(k * 22, (k + 1) * 22):
            assign[f"node_{i}"] = str(k + 1)
    pt, jx = port(x, top_k=6), jax_(x, top_k=6)
    kw = dict(discovery_data=x, test_data=x, n_perm=64, seed=0)
    rp = sparse_module_preservation(pt.adjacency, pt.adjacency, assign,
                                    config=EngineConfig(chunk_size=32),
                                    device="cpu", **kw)
    rj = netrep_tpu.sparse_module_preservation(
        jx.adjacency, jx.adjacency, assign,
        config=JConfig(chunk_size=32, autotune=False), **kw)
    assert rp.observed.shape == (4, 7) and np.isfinite(rp.p_values).all()
    np.testing.assert_allclose(rp.observed, rj.observed, rtol=0, atol=1e-5)
    assert np.array_equal(rp.p_values, rj.p_values)
    from netrep_tpu.ops import pvalues as jpv

    for got, want in zip(jpv.tail_counts(rp.observed, rp.nulls),
                         jpv.tail_counts(rj.observed, rj.nulls)):
        assert np.array_equal(got, want)
