"""The port's all-pairs grid (``netrep_tpu_torch.models.grid``) against
the JAX package's ``grid_preservation`` on the same seeded inputs, on the
CPU, and against the port's own solo ``module_preservation`` calls.

Held, for the cold grid (fixed and adaptive), the resumed grid, the
incremental grid (one cohort changed: its row and column recompute,
warm-started) and the interrupted grid (a pack fails mid-null, the same
call resumes it): in every cell equal p-values, ``counts_hi/lo/eff``,
``n_perm_used``, ``completed`` and ``total_space``; observed statistics
within the Queue 3 bounds (99.9% to 1e-5, all to 1e-4); equal
``GridResult.stats`` counters (cells, permutations, packs, dedup). Each
port cell also equals its solo call (warm-started cells: the solo call
given the same ``adaptive_priors``). Cell files cross packages both ways;
manifests do not (their config hash is ``repr(EngineConfig)``). The
telemetry readers ``grid_summary``/``render_grid`` equal the JAX
package's on the same event file, and every refusal's text is the JAX
package's. With ``fleet=`` (each cell routed to a replica of an
in-process serving fleet) every cell equals the in-process grid's, its
solo call's and the JAX ``grid_preservation(fleet=)``'s, routed to the
same replica ids.

The fixture is ``tests/test_grid.py``'s (three cohorts of 30 nodes, two
with module assignments: four cells in three column packs)."""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from netrep_tpu import grid_preservation as jgrid  # noqa: E402
from netrep_tpu.models.results import PreservationResult as JResult  # noqa: E402
from netrep_tpu.ops.sequential import StopRule as JRule  # noqa: E402
from netrep_tpu.serve import packer as jpk  # noqa: E402
from netrep_tpu.utils import telemetry as jtm  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.models.grid import grid_preservation  # noqa: E402
from netrep_tpu_torch.models.preservation import module_preservation  # noqa: E402
from netrep_tpu_torch.models.results import PreservationResult  # noqa: E402
from netrep_tpu_torch.ops.sequential import StopRule  # noqa: E402
from netrep_tpu_torch.serve import packer as tpk  # noqa: E402
from netrep_tpu_torch.utils import telemetry as ttm  # noqa: E402
from netrep_tpu_torch.utils.config import EngineConfig  # noqa: E402

N, S = 30, 40
NPERM = 64
SEED = 7
NAMES = ["a", "b", "c"]
PAIRS = [("a", "b"), ("a", "c"), ("b", "a"), ("b", "c")]
CFG = dict(chunk_size=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk(seed):
    r = np.random.default_rng(seed)
    data = r.normal(size=(S, N))
    corr = np.corrcoef(data, rowvar=False)
    return np.abs(corr) ** 2, corr, data


def _cohorts():
    network, correlation, data = {}, {}, {}
    for i, n in enumerate(NAMES):
        network[n], correlation[n], data[n] = _mk(100 + i)
    assign = {
        "a": {f"node_{i}": str(1 + (i % 3)) for i in range(N)},
        "b": {f"node_{i}": str(1 + (i % 4)) for i in range(N)},
    }
    return network, correlation, data, assign


def _changed(inputs):
    """The inputs with cohort c (test-only) replaced."""
    network, correlation, data, assign = inputs
    network, correlation, data = dict(network), dict(correlation), dict(data)
    network["c"], correlation["c"], data["c"] = _mk(999)
    return network, correlation, data, assign


def _port(inputs, adaptive, grid_dir=None, **kw):
    network, correlation, data, assign = inputs
    return grid_preservation(
        network, data=data, correlation=correlation,
        module_assignments=assign, n_perm=NPERM, null="all", seed=SEED,
        config=EngineConfig(**CFG), adaptive=adaptive,
        adaptive_rule=StopRule(min_perms=8) if adaptive else None,
        grid_dir=grid_dir, device="cpu", **kw)


def _jax(inputs, adaptive, grid_dir=None, **kw):
    network, correlation, data, assign = inputs
    return jgrid(
        network, data=data, correlation=correlation,
        module_assignments=assign, n_perm=NPERM, null="all", seed=SEED,
        config=JConfig(**CFG, autotune=False), adaptive=adaptive,
        adaptive_rule=JRule(min_perms=8) if adaptive else None,
        grid_dir=grid_dir, **kw)


def _solo(inputs, d, t, adaptive, priors=None):
    network, correlation, data, assign = inputs
    kw = {}
    if adaptive:
        kw = dict(adaptive=True, adaptive_rule=StopRule(min_perms=8))
        if priors is not None:
            kw["adaptive_priors"] = priors
    return module_preservation(
        network, data=data, correlation=correlation,
        module_assignments=assign[d], discovery=d, test=t, n_perm=NPERM,
        null="all", seed=SEED, config=EngineConfig(**CFG), simplify=False,
        device="cpu", **kw)[d][t]


def _stats(g):
    return {k: v for k, v in g.stats.items() if k != "wall_s"}


def assert_cell(got, want, what):
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (what, f)
    if want.n_perm_used is None:
        assert got.n_perm_used is None, what
    else:
        assert np.array_equal(got.n_perm_used, want.n_perm_used), what
    for f in ("completed", "total_space", "p_type", "n_perm"):
        assert getattr(got, f) == getattr(want, f), (what, f)
    assert list(got.module_labels) == list(want.module_labels), what
    diff = np.abs(np.asarray(got.observed) - np.asarray(want.observed))
    assert diff.max() <= 1e-4 and np.mean(diff <= 1e-5) >= 0.999, what


def assert_grids(got, want):
    assert _stats(got) == _stats(want)
    cells = sorted((d, t) for d, t, _ in want.cells())
    assert sorted((d, t) for d, t, _ in got.cells()) == cells
    for d, t in cells:
        assert_cell(got.cell(d, t), want.cell(d, t), (d, t))


def assert_solo(cell, solo, what):
    """A port cell against its solo call: equal p-values, counts and
    permutation counts (the solo call keeps its null; the cell, counts).
    """
    from netrep_tpu_torch.ops import pvalues as tpv

    assert np.array_equal(cell.p_values, solo.p_values), what
    tallies = tpv.tail_counts(solo.observed, solo.nulls[:solo.completed])
    for f, want in zip(("counts_hi", "counts_lo", "counts_eff"), tallies):
        assert np.array_equal(getattr(cell, f), want), (what, f)
    if solo.n_perm_used is None:
        assert cell.completed == solo.completed, what
    else:
        assert np.array_equal(cell.n_perm_used, solo.n_perm_used), what
        # an adaptive cell's ``completed`` is its pack's depth (capped at
        # its n_perm), as in the JAX package: at least its own run's
        assert cell.completed >= solo.completed, what
    assert np.abs(cell.observed - solo.observed).max() <= 1e-6, what


@pytest.fixture(scope="module")
def atlas(tmp_path_factory):
    """The adaptive grid in both packages, each into its own directory:
    cold, then again (resumed), then with cohort c changed
    (incremental)."""
    inputs = _cohorts()
    tdir = str(tmp_path_factory.mktemp("port_grid"))
    jdir = str(tmp_path_factory.mktemp("jax_grid"))
    runs = {}
    for key, inp in (("cold", inputs), ("resume", inputs),
                     ("delta", _changed(inputs))):
        runs[key] = (_port(inp, True, tdir), _jax(inp, True, jdir))
    return inputs, tdir, jdir, runs


@pytest.mark.parametrize("phase", ["cold", "resume", "delta"])
def test_adaptive_grid_matches_jax(atlas, phase):
    got, want = atlas[3][phase]
    assert_grids(got, want)
    st = got.stats
    if phase == "cold":
        assert st["cells_computed"] == 4 and st["packs"] == 3
        assert st["dedup"]["hits"] > 0
    elif phase == "resume":
        assert st["cells_reused"] == 4 and st["perms_evaluated"] == 0
    else:
        assert (st["cells_computed"], st["cells_reused"],
                st["cells_warmstarted"]) == (2, 2, 2)


def test_fixed_grid_matches_jax_and_solo():
    inputs = _cohorts()
    got, want = _port(inputs, False), _jax(inputs, False)
    assert_grids(got, want)
    for d, t in PAIRS:
        assert_solo(got.cell(d, t), _solo(inputs, d, t, False), (d, t))


@pytest.mark.parametrize("d,t", PAIRS)
def test_adaptive_cells_equal_solo(atlas, d, t):
    inputs, _tdir, _jdir, runs = atlas
    assert_solo(runs["cold"][0].cell(d, t), _solo(inputs, d, t, True),
                (d, t))
    assert_solo(runs["resume"][0].cell(d, t), _solo(inputs, d, t, True),
                (d, t))


@pytest.mark.parametrize("d", ["a", "b"])
def test_warm_started_cells_equal_solo_with_priors(atlas, d):
    inputs, _tdir, _jdir, runs = atlas
    prev = runs["cold"][0].cell(d, "c")
    priors = (np.asarray(prev.counts_hi, np.int64),
              np.asarray(prev.counts_lo, np.int64),
              np.asarray(prev.n_perm_used, np.int64))
    want = _solo(_changed(inputs), d, "c", True, priors=priors)
    assert_solo(runs["delta"][0].cell(d, "c"), want, d)


def test_cell_files_cross_packages_manifests_do_not(atlas, tmp_path):
    inputs, tdir, jdir, runs = atlas
    for d, t in PAIRS:
        name = f"cell_{d}__{t}.npz"
        assert_cell(JResult.load(os.path.join(tdir, name)),
                    PreservationResult.load(os.path.join(jdir, name)),
                    (d, t))
    # a JAX manifest's config hash is not the port's: every cell
    # recomputes cold (no priors), equal to the port's own cold grid
    cross = str(tmp_path / "cross")
    shutil.copytree(jdir, cross)
    again = _port(inputs, True, cross)
    assert again.stats["cells_reused"] == 0
    assert again.stats["cells_warmstarted"] == 0
    for d, t in PAIRS:
        assert_cell(again.cell(d, t), runs["cold"][0].cell(d, t), (d, t))


def _fail_on(pk, at):
    """A ``PackMonitor.update`` that raises at its ``at``-th call."""
    real = pk.PackMonitor.update
    calls = []

    def update(self, vals, take):
        calls.append(take)
        if len(calls) == at:
            raise RuntimeError("injected mid-pack failure")
        return real(self, vals, take)

    return update


def test_interrupted_grid_resumes_to_the_uninterrupted_one(
        atlas, tmp_path, monkeypatch):
    """A pack failing in its third chunk (the second column's) leaves its
    checkpoint behind; the same call resumes it, in both packages, to the
    uninterrupted grid."""
    inputs, _tdir, _jdir, runs = atlas
    dirs = {}
    for name, pk, run in (("port", tpk, _port), ("jax", jpk, _jax)):
        gdir = str(tmp_path / name)
        monkeypatch.setattr(pk.PackMonitor, "update", _fail_on(pk, 7))
        with pytest.raises(RuntimeError, match="injected"):
            run(inputs, True, gdir)
        monkeypatch.undo()
        assert os.listdir(os.path.join(gdir, "ckpt")), name
        dirs[name] = (gdir, run(inputs, True, gdir))
        assert not os.listdir(os.path.join(gdir, "ckpt")), name
    got, want = dirs["port"][1], dirs["jax"][1]
    assert_grids(got, want)
    cold = runs["cold"][0]
    for d, t in PAIRS:
        assert_cell(got.cell(d, t), cold.cell(d, t), (d, t))


def test_ctrl_c_keeps_the_pack_checkpoint(atlas, tmp_path, monkeypatch):
    """Port only (a deliberate difference, ROADMAP.md Queue 3): a
    KeyboardInterrupt ends the grid after the pack it lands in, which
    keeps its checkpoint and leaves its cells out; the same call then
    finishes the grid equal to the uninterrupted one."""
    inputs, _tdir, _jdir, runs = atlas
    gdir = str(tmp_path / "ctrl_c")
    real = tpk.PackMonitor.update
    calls = []

    def update(self, vals, take):
        calls.append(take)
        if len(calls) == 7:
            raise KeyboardInterrupt
        return real(self, vals, take)

    monkeypatch.setattr(tpk.PackMonitor, "update", update)
    part = _port(inputs, True, gdir)
    monkeypatch.undo()
    done = sorted((d, t) for d, t, _ in part.cells())
    assert 0 < len(done) < len(PAIRS)
    assert len(os.listdir(os.path.join(gdir, "ckpt"))) == 1
    full = _port(inputs, True, gdir)
    assert full.stats["cells_reused"] == len(done)
    for d, t in PAIRS:
        assert_cell(full.cell(d, t), runs["cold"][0].cell(d, t), (d, t))


def test_grid_telemetry_readers_match_jax(tmp_path):
    path = str(tmp_path / "grid.jsonl")
    inputs = _cohorts()
    gdir = str(tmp_path / "g")
    _port(inputs, True, gdir, telemetry=path)
    _port(_changed(inputs), True, gdir, telemetry=path)
    got = ttm.grid_summary(ttm.read_events(path))
    assert got == jtm.grid_summary(jtm.read_events(path))
    assert got["grids"] == 2 and got["dedup_hits"] > 0
    assert got["rows"]["a"]["warmstarted"] == 1
    text = ttm.render_grid(path)
    assert text == jtm.render_grid(path) and text.startswith("grid:")
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert ttm.render_grid(str(empty)) == "" == jtm.render_grid(str(empty))


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", ["null", "alternative", "derived",
                                  "unknown", "not_a_dict", "empty", "no_rows",
                                  "one_dataset"])
def test_refusals_match_jax(case):
    network, correlation, data, assign = _cohorts()
    kw = {
        "null": dict(null="both"),
        "alternative": dict(alternative="up"),
        "derived": dict(config="derived"),
        "unknown": dict(datasets=["a", "z"]),
        "not_a_dict": dict(module_assignments=["1"] * N),
        "empty": dict(module_assignments={}),
        "no_rows": dict(datasets=["c"]),
        "one_dataset": dict(datasets=["a"]),
    }[case]

    def call(fn, cfg_cls, **extra):
        args = {"module_assignments": assign, "n_perm": 8, **kw}
        if args.get("config") == "derived":
            args["config"] = cfg_cls(network_from_correlation=2.0)
        return lambda: fn(network, data=data, correlation=correlation,
                          **args, **extra)

    assert (_refusal(call(grid_preservation, EngineConfig, device="cpu"))
            == _refusal(call(jgrid, JConfig)))


def _fleet(pkg, root):
    """A two-replica in-process fleet of either package whose servers run
    the grid's engine config and null."""
    if pkg == "port":
        from netrep_tpu_torch.serve import ServeConfig, build_inprocess_fleet

        def make_config(rid, jpath, ckpt):
            return ServeConfig(journal=jpath, checkpoint_dir=ckpt,
                               fleet_label=rid, engine=EngineConfig(**CFG),
                               null="all", device="cpu")
    else:
        from netrep_tpu.serve import ServeConfig, build_inprocess_fleet

        def make_config(rid, jpath, ckpt):
            return ServeConfig(journal=jpath, checkpoint_dir=ckpt,
                               fleet_label=rid, null="all",
                               engine=JConfig(**CFG, autotune=False))
    return build_inprocess_fleet(2, root, make_config=make_config)


def assert_fleet_cell(got, want, what, tol):
    """A fleet-served cell against another grid's: equal p-values, counts
    and permutation counts; ``completed`` equal where the cells' packs
    match (fixed cells always); observed within ``tol``."""
    for f in ("p_values", "counts_hi", "counts_lo", "counts_eff"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (what, f)
    if want.n_perm_used is None:
        assert got.n_perm_used is None and got.completed == want.completed
    else:
        assert np.array_equal(got.n_perm_used, want.n_perm_used), what
    for f in ("total_space", "p_type", "n_perm"):
        assert getattr(got, f) == getattr(want, f), (what, f)
    assert list(got.module_labels) == list(want.module_labels), what
    assert np.abs(np.asarray(got.observed)
                  - np.asarray(want.observed)).max() <= tol, what


@pytest.mark.parametrize("adaptive", (False, True),
                         ids=("fixed", "adaptive"))
def test_fleet_grid_equals_in_process_grid(tmp_path, adaptive):
    """``fleet=`` routes every cell to a replica of the port's in-process
    fleet: each cell equals the in-process grid's and its solo call's, the
    grid's counters count four computed cells, and the telemetry marks
    the grid and its cells as fleet-routed."""
    inputs = _cohorts()
    fleet = _fleet("port", str(tmp_path / "fleet"))
    try:
        got = _port(inputs, adaptive, fleet=fleet,
                    telemetry=str(tmp_path / "tel.jsonl"))
        st = fleet.stats()
    finally:
        fleet.close()
    want = _port(inputs, adaptive)
    for d, t in PAIRS:
        assert_fleet_cell(got.cell(d, t), want.cell(d, t), (d, t), 1e-6)
        assert_solo(got.cell(d, t), _solo(inputs, d, t, adaptive), (d, t))
    assert got.stats["cells_computed"] == 4
    assert got.stats["perms_evaluated"] == want.stats["perms_evaluated"]
    assert sum(r["done"] for r in st["replicas"].values()) == 4
    events = [e for e in ttm.read_events(str(tmp_path / "tel.jsonl"))]
    start = [e["data"] for e in events if e["ev"] == "grid_start"]
    assert start[0]["fleet"] is True
    cells = [e["data"] for e in events if e["ev"] == "grid_cell_start"]
    assert len(cells) == 4 and all(c["fleet"] for c in cells)


@pytest.mark.parametrize("adaptive", (False, True),
                         ids=("fixed", "adaptive"))
def test_fleet_grid_equals_jax_fleet_grid(tmp_path, adaptive):
    """The port's ``grid_preservation(fleet=)`` against the JAX package's
    on the same inputs: equal p-values, counts and permutation counts in
    every cell, observed within the Queue 3 bound; every cell routed to
    the same replica id (the registrations' digests are equal)."""
    inputs = _cohorts()
    fleets = {pkg: _fleet(pkg, str(tmp_path / pkg))
              for pkg in ("port", "jax")}
    try:
        got = _port(inputs, adaptive, fleet=fleets["port"])
        want = _jax(inputs, adaptive, fleet=fleets["jax"])
        routes = {pkg: {(d, t): f.route("grid", d, t).rid
                        for d, t in PAIRS} for pkg, f in fleets.items()}
    finally:
        for f in fleets.values():
            f.close()
    assert routes["port"] == routes["jax"]
    assert len(set(routes["port"].values())) == 2
    for d, t in PAIRS:
        assert_fleet_cell(got.cell(d, t), want.cell(d, t), (d, t), 1e-4)
        assert got.cell(d, t).completed == want.cell(d, t).completed
