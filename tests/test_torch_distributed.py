"""The port's multi-process runtime (``netrep_tpu_torch.parallel.
distributed``) against the JAX package's ``netrep_tpu.parallel.
distributed``, and two-process runs over ``gloo`` on the CPU.

The single-process helpers mirror ``tests/test_distributed.py``: the
default summary (same keys), the partial-configuration error (same text),
a complete but unreachable configuration that raises, and the host copy
of ``gather_to_host``. The telemetry events are the JAX package's names.

The two-process runs start two fresh interpreters on 127.0.0.1, each
running :func:`_worker` (its source is handed to ``python -c``, so a
worker imports neither JAX nor this file). Both processes build the same
engines over a mesh whose perm axis spans them — ``make_mesh(2, 1,
devices=[cpu])`` (one perm row each), ``make_mesh(4, 1, devices=[cpu] *
2)`` (two each) and ``make_mesh(2, 2, devices=[cpu] * 2)`` (a perm row of
two row shards each, the psum gather) — and run the single-test and the
multi-test engines' fixed, streaming, adaptive and checkpointed loops.
Every rank's nulls, counts, ``n_perm_used`` and p-values must equal the
single-process run on a mesh of the same shape bit for bit, and only
rank 0 writes the checkpoint. With autotune stores seeded with different
best superchunks, both ranks run process 0's and only rank 0's store
gains a sample. A peer that dies makes the survivor's next
collective raise within the group's timeout.

One pair per mesh shape (2×1 and 4×1) also runs the sparse engine and
the screened null (``null_precision='bf16_rescue'``, materialized,
streaming, both adaptive loops, a streaming checkpoint resumed): each
rank equals the one-process run on the same mesh shape bit for bit, the
rescue counters included, and computes only its own shards (a spy on
``SparsePermutationEngine._values``). The fault drill injects a partial
device loss in rank 1 under a policy with a checkpoint: rank 1 raises
``CrossProcessRungError`` naming the shrink rung, rank 0 raises
``PeerLostError``, both well within the group's timeout, and a fresh pair
(with a transient fault retried in rank 1) resumes from process 0's
checkpoint to the unbroken run's null and p-values. Each run has its own
subprocess timeout (120 s); the processes are killed when it expires.
"""

import inspect
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import netrep_tpu  # noqa: E402
from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.ops.sparse import SparseAdjacency as JAdj  # noqa: E402
from netrep_tpu.parallel import distributed as jdist  # noqa: E402
from netrep_tpu.parallel.engine import ModuleSpec as JSpec  # noqa: E402
from netrep_tpu.parallel.engine import PermutationEngine as JEngine  # noqa: E402
from netrep_tpu.utils.config import EngineConfig as JConfig  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.ops.sparse import SparseAdjacency  # noqa: E402
from netrep_tpu_torch.parallel import distributed  # noqa: E402
from netrep_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from netrep_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from netrep_tpu_torch.utils.telemetry import Telemetry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 120
#: the group's collective timeout in the dead-peer run
DEAD_TIMEOUT_S = 20.0
N_PERM, SEED, CHUNK = 64, 5, 16
#: the fault drill's plans, rank 1 only: a partial device loss in the
#: third chunk, then (in the resumed pair) a transient fault in the fourth;
#: and a hang in the third chunk, abandoned after HANG_TIMEOUT_S
FAULT_PLAN, RESUME_PLAN = "device_lost_partial@40", "transient@56"
HANG_PLAN, HANG_TIMEOUT_S = "hang@40", 3.0
#: the unsplit parity tolerance of a null against the JAX package's
NULL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def autotune_store_module(tmp_path_factory):
    """The autotune store in a directory of this module's own while its
    module-scoped fixtures run: no test writes the default store."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NETREP_AUTOTUNE_STORE",
                  str(tmp_path_factory.mktemp("autotune")))
        yield


@pytest.fixture(autouse=True)
def autotune_store(tmp_path_factory, monkeypatch):
    """Each test its own autotune store, outside its ``tmp_path``: a
    setting another test measured never moves this one's superchunk,
    progress calls, events or checkpoint cadence."""
    monkeypatch.setenv("NETREP_AUTOTUNE_STORE",
                       str(tmp_path_factory.mktemp("autotune")))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs, as in its workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_launcher_env(monkeypatch):
    """Neither package's launcher variables leak in from the shell."""
    for var in (*distributed.ENV_VARS.values(), *distributed.TORCHRUN_VARS):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# single-process helpers, against the JAX package's
# ---------------------------------------------------------------------------

def test_single_process_defaults():
    assert distributed.is_initialized() is False
    info = distributed.initialize()  # no config, no launcher: one process
    jinfo = jdist.initialize()
    assert set(info) == set(jinfo)
    assert info["process_id"] == jinfo["process_id"] == 0
    assert info["process_count"] == jinfo["process_count"] == 1
    assert info["global_device_count"] == info["local_device_count"] >= 1
    assert distributed.initialize() == info  # idempotent
    assert distributed.is_initialized() is False
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert jinfo["global_device_count"] == jax.device_count()


def test_partial_config_rejected():
    assert distributed.ENV_VARS == jdist.ENV_VARS
    for kw in (dict(coordinator_address="10.0.0.1:1234"),
               dict(num_processes=4, process_id=0)):
        with pytest.raises(ValueError) as want:
            jdist.initialize(**kw)
        with pytest.raises(ValueError, match="partial multi-host "
                                             "configuration") as got:
            distributed.initialize(**kw)
        assert str(got.value) == str(want.value)


def test_env_vars_complete_partial_args(monkeypatch):
    """Env vars fill in omitted args; a then-complete configuration that
    cannot join raises (it is not taken for a single-process run)."""
    monkeypatch.setenv(distributed.ENV_VARS["num_processes"], "2")
    monkeypatch.setenv(distributed.ENV_VARS["process_id"], "1")
    t0 = time.monotonic()
    with pytest.raises(Exception):
        # nothing listens there: the client's rendezvous times out
        distributed.initialize(coordinator_address=f"127.0.0.1:{_free_port()}",
                               timeout_s=1.0)
    assert time.monotonic() - t0 < 60
    assert distributed.is_initialized() is False


def test_autodetect_failure_emits_and_continues(monkeypatch, caplog):
    """The launcher's variables present but no group to join: a warning,
    the JAX package's ``distributed_autodetect_failed`` event, and a
    single-process summary."""
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", _free_port()),
                 ("WORLD_SIZE", 2), ("RANK", 1)):
        monkeypatch.setenv(k, str(v))
    bus = Telemetry(watchdog_poll_s=0)
    seen = []
    bus.subscribe(lambda r: seen.append(r["ev"]))
    with bus.activate():
        info = distributed.initialize(timeout_s=1.0)
    assert info["process_count"] == 1 and not distributed.is_initialized()
    assert seen == ["distributed_autodetect_failed"]
    assert "did not join a process group" in caplog.text


def test_gather_to_host_single_process():
    x = torch.arange(12.0).reshape(3, 4)
    out = distributed.gather_to_host(x)
    jout = jdist.gather_to_host(jax.numpy.arange(12.0).reshape(3, 4))
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.asarray(jout))
    a, b = distributed.gather_to_host([x, x[:1]], axis=1)
    np.testing.assert_array_equal(a, x.numpy())
    np.testing.assert_array_equal(b, x[:1].numpy())
    t = np.arange(6, dtype=np.int64)
    assert distributed.sum_to_host(t) is t


def test_filter_addressable():
    cpu = [torch.device("cpu")] * 3
    assert distributed.filter_addressable(cpu) == cpu
    if not torch.cuda.is_available():
        assert distributed.filter_addressable(
            cpu[:1] + [torch.device("cuda", 0)]) == cpu[:1]


def test_a_failed_collective_is_peer_lost_and_never_retried():
    """A collective's backend error (``gloo``'s read error, whose text
    carries a transient marker) becomes ``PeerLostError``, classified
    ``fatal`` whatever its text; other errors pass through."""
    from netrep_tpu_torch.utils import faults

    gloo = RuntimeError("[pair.cc:537] Read error [127.0.0.1]:38028: "
                        "Connection reset by peer")
    assert faults.classify_error(gloo) == "transient"
    with pytest.raises(faults.PeerLostError, match="allgather") as got:
        with distributed._collective("allgather"):
            raise gloo
    assert got.value.__cause__ is gloo
    assert faults.classify_error(got.value) == "fatal"
    with pytest.raises(ValueError):
        with distributed._collective("allgather"):
            raise ValueError("not a collective's failure")


@pytest.mark.parametrize("rung,ck", [("shrink", "ck/null_d__t.npz"),
                                     ("cpu", "ck/null_d__t.npz"),
                                     ("none", None)])
def test_cross_process_rung_error_names_rung_rank_and_checkpoint(rung, ck):
    from netrep_tpu_torch.utils import faults

    cause = faults.InjectedPartialDeviceLost("injected partial device loss "
                                             "at permutation 40")
    e = faults.CrossProcessRungError(rung, 1, 2, ck, cause)
    assert (e.rung, e.rank, e.checkpoint) == (rung, 1, ck)
    text = str(e)
    assert text.startswith("rank 1 of 2: device lost (InjectedPartial")
    assert (f"{rung} rung" in text) == (rung != "none")
    assert ("launch every process again" in text) == (ck is not None)
    assert faults.classify_error(e) == "fatal"


def test_single_process_mesh_is_local():
    m = tmesh.make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    assert not m.spans_processes
    assert (m.ranks == 0).all() and m.is_local(1, 1)
    assert m.perm_row(1).ranks.shape == (1, 2)


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _runs(d, mesh, ckpt_dir):
    """Every loop this file holds across processes, on ``mesh``: a dict
    of result arrays. The same function runs in the two workers and, on a
    one-process mesh of the same shape, in the test."""
    import numpy as np
    import torch

    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.multitest import MultiTestEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    n_perm, seed, chunk = int(d["n_perm"]), int(d["seed"]), int(d["chunk"])
    specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
             zip(d["labels"], d["idx"])]
    row = mesh.shape["row"] > 1
    cfg = EngineConfig(chunk_size=chunk, superchunk=2,
                       matrix_sharding="row" if row else "replicated",
                       stat_mode="xla" if row else "auto")
    single = PermutationEngine(d["dc"], d["dn"], d["dd"], d["tc"], d["tn"],
                               d["td"], specs, d["pool"], config=cfg,
                               device="cpu", mesh=mesh)
    multi = MultiTestEngine(d["dc"], d["dn"], d["dd"], [d["tc"], d["t2c"]],
                            [d["tn"], d["t2n"]], [d["td"], d["t2d"]],
                            specs, d["pool"], config=cfg, device="cpu",
                            mesh=mesh)
    out = {}
    for name, eng in (("single", single), ("multi", multi)):
        obs = eng.observed()
        out[f"{name}_obs"] = obs
        out[f"{name}_null"] = eng.run_null(n_perm, key=seed)[0]
        sc = eng.run_null_streaming(n_perm, obs, key=seed)
        out[f"{name}_counts"] = np.stack([sc.hi, sc.lo, sc.eff])
        nulls, done, _fin = eng.run_null_adaptive(4 * n_perm, obs, key=seed)
        out[f"{name}_adaptive"] = nulls
        out[f"{name}_adaptive_done"] = np.asarray(done)
        sa = eng.run_null_adaptive_streaming(4 * n_perm, obs,
                                             key=seed)
        out[f"{name}_adaptive_stream"] = np.stack([sa.hi, sa.lo, sa.eff])
        out[f"{name}_n_used"] = sa.n_perm_used
        path = os.path.join(ckpt_dir, f"{name}.npz")
        calls = []

        def stop_after_two(done, total):
            calls.append(done)
            if len(calls) == 2:
                raise KeyboardInterrupt

        part, at = eng.run_null(n_perm, key=seed, progress=stop_after_two,
                                checkpoint_path=path, checkpoint_every=chunk)
        out[f"{name}_interrupted_at"] = np.asarray(at)
        out[f"{name}_resumed"] = eng.run_null(
            n_perm, key=seed, checkpoint_path=path)[0]
    return out


def _autotune_runs(d, mesh, rank, out_dir):
    """Default streaming nulls (single-test and multi-test) with this
    rank's own autotune store seeded so its best superchunk is 2 on rank
    0 and 4 on rank 1: the progress calls, counts, resolved superchunk
    and the store's samples afterwards."""
    import numpy as np

    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.multitest import MultiTestEngine
    from netrep_tpu_torch.utils import autotune
    from netrep_tpu_torch.utils.config import EngineConfig

    os.environ[autotune.STORE_ENV] = os.path.join(out_dir, f"store{rank}")
    best = 2 if rank == 0 else 4
    n_perm, seed = int(d["n_perm"]), int(d["seed"])
    specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
             zip(d["labels"], d["idx"])]
    cfg = EngineConfig(chunk_size=int(d["chunk"]))
    single = PermutationEngine(d["dc"], d["dn"], d["dd"], d["tc"], d["tn"],
                               d["td"], specs, d["pool"], config=cfg,
                               device="cpu", mesh=mesh)
    multi = MultiTestEngine(d["dc"], d["dn"], d["dd"], [d["tc"], d["t2c"]],
                            [d["tn"], d["t2n"]], [d["td"], d["t2d"]],
                            specs, d["pool"], config=cfg, device="cpu",
                            mesh=mesh)
    cache = autotune.AutotuneCache(device="cpu")
    out = {}
    for name, eng, extra in (("single", single, "superchunk"),
                             ("multi", multi, "T2|superchunk")):
        base = eng if name == "single" else eng.cohorts[0]
        key = base.autotune_key(extra)
        for k, rate in ((1, 1.0), (best, 1e9), (1, 1.25)):
            cache.record(key, k, rate)
        calls = []
        sc = eng.run_null_streaming(
            n_perm, eng.observed(), key=seed,
            progress=lambda done, total: calls.append(done))
        out[f"{name}_counts"] = np.stack([sc.hi, sc.lo, sc.eff])
        out[f"{name}_calls"] = np.asarray(calls)
        out[f"{name}_k"] = np.asarray(eng._stream_autotune_record[2]
                                      if eng._stream_autotune_record
                                      else -1)
        out[f"{name}_samples"] = np.asarray(cache.throughput(key, best))
    return out


def _sparse_runs(d, mesh, ckpt_dir):
    """``sparse_module_preservation`` on ``mesh``: observed values, null,
    ``completed`` and p-values, the calls of ``SparsePermutationEngine.
    _values`` in that run (one per chunk and shard of this process), and
    a run interrupted after two chunks and resumed from its checkpoint."""
    import numpy as np

    from netrep_tpu_torch.models.sparse_api import sparse_module_preservation
    from netrep_tpu_torch.ops.sparse import SparseAdjacency
    from netrep_tpu_torch.parallel.sparse import SparsePermutationEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    n, chunk = int(d["sp_n"]), int(d["chunk"])
    kw = dict(
        discovery_network=SparseAdjacency.from_arrays(
            d["sp_d_nbr"], d["sp_d_wgt"], n),
        test_network=SparseAdjacency.from_arrays(
            d["sp_t_nbr"], d["sp_t_wgt"], n),
        module_assignments=d["sp_labels"], discovery_data=d["sp_dx"],
        test_data=d["sp_tx"], n_perm=int(d["n_perm"]), seed=int(d["seed"]),
        config=EngineConfig(chunk_size=chunk), mesh=mesh, device="cpu")
    calls = []
    values = SparsePermutationEngine._values

    def spy(self, perm):
        calls.append(perm.shape[0])
        return values(self, perm)

    SparsePermutationEngine._values = spy
    try:
        res = sparse_module_preservation(**kw)
    finally:
        SparsePermutationEngine._values = values
    out = {"sparse_obs": res.observed, "sparse_null": res.nulls,
           "sparse_completed": np.asarray(res.completed),
           "sparse_p": res.p_values, "spy_sparse_values": np.asarray(calls)}
    path = os.path.join(ckpt_dir, "sparse.npz")
    seen = []

    def stop_after_two(done, total):
        seen.append(done)
        if len(seen) == 2:
            raise KeyboardInterrupt

    part = sparse_module_preservation(**kw, checkpoint_path=path,
                                      checkpoint_every=chunk,
                                      progress=stop_after_two)
    out["sparse_interrupted_at"] = np.asarray(part.completed)
    out["sparse_resumed"] = sparse_module_preservation(
        **kw, checkpoint_path=path).nulls
    return out


def _screened_runs(d, mesh, ckpt_dir):
    """The screened null (``stat_mode='xla'``, ``null_precision=
    'bf16_rescue'``) on ``mesh``: materialized, streaming, adaptive
    (both loops) and a streaming run interrupted after one superchunk and
    resumed, each with its ``RescueState`` counters; the resolved
    precision of ``'bf16_rescue'`` and ``'auto'``; and the texts of the
    fused and row-sharded refusals on such a mesh."""
    import dataclasses

    import numpy as np
    import torch

    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig

    n_perm, seed, chunk = int(d["n_perm"]), int(d["seed"]), int(d["chunk"])
    specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
             zip(d["labels"], d["idx"])]
    mats = (d["dc"], d["dn"], d["dd"], d["tc"], d["tn"], d["td"])
    cfg = EngineConfig(chunk_size=chunk, superchunk=2, stat_mode="xla",
                       null_precision="bf16_rescue")
    eng = PermutationEngine(*mats, specs, d["pool"], config=cfg,
                            device="cpu", mesh=mesh)
    obs = eng.observed() + float(d["screen_shift"])
    out = {"scr_obs": obs}

    def rescue(name):
        st = eng.last_rescue
        out[f"{name}_rescue"] = np.asarray([st.total, st.rescued,
                                            st.dispatches])

    out["scr_null"], done = eng.run_null(n_perm, key=seed, observed=obs)
    out["scr_done"] = np.asarray(done)
    rescue("scr_mat")
    sc = eng.run_null_streaming(n_perm, obs, key=seed)
    out["scr_counts"] = np.stack([sc.hi, sc.lo, sc.eff])
    rescue("scr_stream")
    nulls, done, _fin = eng.run_null_adaptive(4 * n_perm, obs, key=seed)
    out["scr_adaptive"], out["scr_adaptive_done"] = nulls, np.asarray(done)
    rescue("scr_adaptive")
    sa = eng.run_null_adaptive_streaming(4 * n_perm, obs, key=seed)
    out["scr_adaptive_stream"] = np.stack([sa.hi, sa.lo, sa.eff])
    out["scr_n_used"] = sa.n_perm_used
    out["scr_adaptive_stream_done"] = np.asarray(sa.completed)
    rescue("scr_adaptive_stream")
    path = os.path.join(ckpt_dir, "screened.npz")

    def stop_after_one(done, total):
        raise KeyboardInterrupt

    part = eng.run_null_streaming(n_perm, obs, key=seed,
                                  progress=stop_after_one,
                                  checkpoint_path=path,
                                  checkpoint_every=chunk)
    out["scr_interrupted_at"] = np.asarray(part.completed)
    fin = eng.run_null_streaming(n_perm, obs, key=seed, checkpoint_path=path)
    out["scr_resumed"] = np.stack([fin.hi, fin.lo, fin.eff])
    rescue("scr_resumed")
    out["scr_precision"] = np.asarray(eng._resolve_null_precision(obs))
    eng.config = dataclasses.replace(cfg, null_precision="auto")
    out["scr_auto"] = np.asarray(eng._resolve_null_precision(obs))
    per = mesh.devices.size // len(np.unique(mesh.ranks))
    for name, m, over in (
            ("fused", mesh, dict(stat_mode="fused")),
            ("row", make_mesh(mesh.shape["perm"], 2,
                              devices=[torch.device("cpu")] * 2 * per),
             dict(matrix_sharding="row"))):
        try:
            PermutationEngine(*mats, specs, d["pool"], device="cpu", mesh=m,
                              config=dataclasses.replace(cfg, **over))
            out[f"refuse_{name}"] = np.asarray("")
        except ValueError as e:
            out[f"refuse_{name}"] = np.asarray(str(e))
    return out


def _drill_kw(d):
    """``module_preservation``'s data arguments of the fault drill."""
    labels = np.full(d["dd"].shape[1], "0", dtype=object)
    for lab, idx in zip(d["labels"], d["idx"]):
        labels[np.asarray(idx)] = str(lab)
    return dict(network={"d": d["dn"], "t": d["tn"]},
                data={"d": d["dd"], "t": d["td"]},
                correlation={"d": d["dc"], "t": d["tc"]},
                module_assignments=list(labels), discovery="d", test="t",
                n_perm=int(d["n_perm"]), seed=int(d["seed"]))


def _drill(d, mesh, rank, mode, ckpt_dir):
    """The fault drill's ``module_preservation`` under a policy with a
    checkpoint on ``mesh`` (in mode ``hang`` with a ``hang_timeout_s``);
    rank 1 carries the ``mode``'s fault plan in its environment. The
    result, or the error's type, text, rung, rank and checkpoint, with the
    seconds to it."""
    import time

    import numpy as np

    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils import faults
    from netrep_tpu_torch.utils.config import EngineConfig, FaultPolicy

    os.makedirs(ckpt_dir, exist_ok=True)
    if rank == 1:
        os.environ[faults.PLAN_ENV] = str(d[f"{mode}_plan"])
    out = {"raised": np.asarray("")}
    t0 = time.monotonic()
    try:
        res = module_preservation(
            **_drill_kw(d), config=EngineConfig(chunk_size=int(d["chunk"])),
            mesh=mesh, device="cpu", checkpoint_dir=ckpt_dir,
            checkpoint_every=int(d["chunk"]),
            fault_policy=FaultPolicy(
                backoff_base_s=0.0, hang_timeout_s=(
                    float(d["hang_timeout_s"]) if mode == "hang" else None)))
        out.update(null=res.nulls, p=res.p_values,
                   completed=np.asarray(res.completed))
    except Exception as e:
        out.update(raised=np.asarray(type(e).__name__),
                   message=np.asarray(str(e)),
                   rung=np.asarray(str(getattr(e, "rung", ""))),
                   err_rank=np.asarray(getattr(e, "rank", -1)),
                   err_checkpoint=np.asarray(str(getattr(e, "checkpoint",
                                                         ""))))
    out["raise_s"] = np.asarray(time.monotonic() - t0)
    out["drill_files"] = np.asarray(sorted(os.listdir(ckpt_dir)))
    return out


def _worker(data_path, out_dir, rank, port, mode, ckpt_root=None):
    """One process of a two-process run: joins the group, builds the
    mesh of ``mode`` over its one CPU device(s), runs :func:`_runs` (or,
    in mode ``dead``, rank 1 leaves and rank 0 runs a null; in modes
    ``split2``/``split4`` :func:`_sparse_runs` and :func:`_screened_runs`;
    in modes ``fault``/``resume``/``hang`` :func:`_drill`, its checkpoint
    directory
    under ``ckpt_root``, default ``out_dir``) and saves what it got to
    ``out_dir/rank<rank>.npz``."""
    import os
    import time

    import numpy as np
    import torch

    from netrep_tpu_torch.parallel import distributed
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.mesh import make_mesh
    from netrep_tpu_torch.utils.config import EngineConfig
    from netrep_tpu_torch.utils.telemetry import Telemetry

    torch.set_num_threads(1)
    bus = Telemetry(watchdog_poll_s=0)
    events = []
    bus.subscribe(lambda r: events.append(r))
    d = dict(np.load(data_path, allow_pickle=True))
    cpu = torch.device("cpu")
    with bus.activate():
        info = distributed.initialize(
            f"127.0.0.1:{port}", 2, rank,
            timeout_s=(float(d["dead_timeout_s"])
                       if mode in ("dead", "fault", "hang") else 120.0))
        shape, per = {"perm2": ((2, 1), 1), "perm4": ((4, 1), 2),
                      "row": ((2, 2), 2), "dead": ((2, 1), 1),
                      "autotune": ((2, 1), 1), "split2": ((2, 1), 1),
                      "split4": ((4, 1), 2), "fault": ((2, 1), 1),
                      "resume": ((2, 1), 1), "hang": ((2, 1), 1)}[mode]
        mesh = make_mesh(*shape, devices=[cpu] * per)
        out = {"ranks": mesh.ranks, "info": np.asarray(
            [info["process_id"], info["process_count"]])}
        if mode == "dead":
            if rank == 1:
                os._exit(0)
            specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
                     zip(d["labels"], d["idx"])]
            eng = PermutationEngine(
                d["dc"], d["dn"], d["dd"], d["tc"], d["tn"], d["td"], specs,
                d["pool"], config=EngineConfig(chunk_size=int(d["chunk"])),
                device="cpu", mesh=mesh)
            t0 = time.monotonic()
            try:
                eng.run_null(int(d["n_perm"]), key=int(d["seed"]))
                out["raised"] = np.asarray("")
            except Exception as e:
                out["raised"] = np.asarray(type(e).__name__)
            out["raise_s"] = np.asarray(time.monotonic() - t0)
        elif mode == "autotune":
            out.update(_autotune_runs(d, mesh, rank, out_dir))
        elif mode in ("fault", "resume", "hang"):
            out.update(_drill(d, mesh, rank, mode, os.path.join(
                ckpt_root or out_dir, f"ckpt{rank}")))
        elif mode in ("split2", "split4"):
            ckpt_dir = os.path.join(out_dir, f"ckpt{rank}")
            os.makedirs(ckpt_dir, exist_ok=True)
            out.update(_sparse_runs(d, mesh, ckpt_dir))
            out.update(_screened_runs(d, mesh, ckpt_dir))
            out["ckpt_files"] = np.asarray(sorted(os.listdir(ckpt_dir)))
        else:
            ckpt_dir = os.path.join(out_dir, f"ckpt{rank}")
            os.makedirs(ckpt_dir, exist_ok=True)
            out.update(_runs(d, mesh, ckpt_dir))
            out["ckpt_files"] = np.asarray(sorted(os.listdir(ckpt_dir)))
    names = [r["ev"] for r in events]
    out["n_retry"] = np.asarray(names.count("retry_attempt"))
    out["n_abandoned"] = np.asarray(names.count("chunk_abandoned"))
    out["start_perms"] = np.asarray([r["data"]["start_perm"] for r in events
                                     if r["ev"] == "null_run_start"])
    out["n_init"] = np.asarray(names.count("distributed_init"))
    out["n_allgather"] = np.asarray(names.count("allgather"))
    out["allgather_bytes"] = np.asarray(sum(
        r["data"]["bytes"] for r in events if r["ev"] == "allgather"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()


#: added to the screened runs' observed values, so the screen decides
#: some permutations and rescues others on this fixture
SCREEN_SHIFT = 0.5
SPARSE_SIZES = (30, 9, 45, 20)


def _sparse_inputs() -> dict:
    """A 240-node kNN-style pair (6 random neighbours, symmetrized) with
    planted modules in both sides' data (20 and 16 samples), as the
    arrays a worker rebuilds its ``SparseAdjacency`` from."""
    rng = np.random.default_rng(0)
    n = 240
    out = {"sp_n": n}
    for side, s in (("d", 20), ("t", 16)):
        rows = np.repeat(np.arange(n), 6)
        adj = SparseAdjacency.from_coo(rows, rng.integers(0, n, n * 6),
                                       rng.uniform(0.05, 1.0, n * 6), n)
        x = rng.standard_normal((s, n))
        pos = 0
        for sz in SPARSE_SIZES:
            x[:, pos:pos + sz] += 1.2 * rng.standard_normal(s)[:, None]
            pos += sz
        out.update({f"sp_{side}_nbr": adj.nbr, f"sp_{side}_wgt": adj.wgt,
                    f"sp_{side}x": x})
    labels = np.full(n, "0", dtype=object)
    pos = 0
    for i, sz in enumerate(SPARSE_SIZES):
        labels[pos:pos + sz] = str(i + 1)
        pos += sz
    out["sp_labels"] = labels.astype(str)
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    a = make_mixed_pair(160, 3, n_samples=24, seed=5)
    b = make_mixed_pair(160, 3, n_samples=20, seed=6)
    (dd, dc, dn), (td, tc, tn) = a["discovery"], a["test"]
    t2d, t2c, t2n = b["test"]
    d = dict(dd=dd, dc=dc, dn=dn, td=td, tc=tc, tn=tn, t2d=t2d, t2c=t2c,
             t2n=t2n, pool=a["pool"],
             labels=np.asarray([lab for lab, _ in a["specs"]]),
             idx=np.asarray([np.asarray(i) for _, i in a["specs"]],
                            dtype=object),
             n_perm=N_PERM, seed=SEED, chunk=CHUNK,
             dead_timeout_s=DEAD_TIMEOUT_S, screen_shift=SCREEN_SHIFT,
             fault_plan=FAULT_PLAN, resume_plan=RESUME_PLAN,
             hang_plan=HANG_PLAN, hang_timeout_s=HANG_TIMEOUT_S,
             **_sparse_inputs())
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    np.savez(path, **d)
    return d, str(path)


def two_processes(data_path, out_dir, mode, ckpt_root=None) -> list[dict]:
    """Run :func:`_worker` as ranks 0 and 1; both are killed if they have
    not ended within ``RUN_TIMEOUT_S``. Returns each rank's saved dict
    (rank 1 of the dead-peer run saves none)."""
    port = _free_port()
    src = "\n\n".join(inspect.getsource(f) for f in (
        _runs, _autotune_runs, _sparse_runs, _screened_runs, _drill_kw,
        _drill, _worker))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import os\nimport numpy as np\n{src}\n"
         f"_worker({data_path!r}, {str(out_dir)!r}, {rank}, {port}, "
         f"{mode!r}, {None if ckpt_root is None else str(ckpt_root)!r})"],
        cwd=str(out_dir), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    deadline = time.monotonic() + RUN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for rank, log in zip((0, 1), logs):
        path = out_dir / f"rank{rank}.npz"
        if path.exists():
            got.append(dict(np.load(path)))
        elif not (mode == "dead" and rank == 1):
            raise AssertionError(f"rank {rank} saved nothing:\n{log}")
    return got


def _reference(d, shape, tmp_path):
    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(*shape, devices=[cpu] * (shape[0] * shape[1]))
    ck = tmp_path / "ref_ckpt"
    ck.mkdir()
    return _runs(d, mesh, str(ck))


@pytest.mark.parametrize("mode,shape", [
    ("perm2", (2, 1)), ("perm4", (4, 1)), ("row", (2, 2)),
])
def test_two_processes_equal_one(inputs, tmp_path, mode, shape):
    d, data_path = inputs
    ranks = two_processes(data_path, tmp_path, mode)
    want = _reference(d, shape, tmp_path)
    assert len(ranks) == 2
    for rank, got in enumerate(ranks):
        assert got["info"].tolist() == [rank, 2]
        np.testing.assert_array_equal(
            got["ranks"], np.repeat(np.arange(2), shape[0] // 2)[:, None]
            * np.ones(shape[1], dtype=int))
        assert int(got["n_init"]) == 1
        # one gather per materialized chunk, the adaptive ones included
        assert int(got["n_allgather"]) > 0 and int(got["allgather_bytes"]) > 0
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"{mode} {k}")
        # p-values from each rank's streaming counts: the one-process
        # run's from its materialized null, cohort by cohort
        for name in ("single", "multi"):
            obs, null = want[f"{name}_obs"], want[f"{name}_null"]
            counts = got[f"{name}_counts"]
            if name == "single":
                obs, null, counts = obs[None], null[None], counts[:, None]
            for t in range(obs.shape[0]):
                np.testing.assert_array_equal(
                    tpv.counts_pvalues(obs[t], *counts[:, t]),
                    tpv.permutation_pvalues(obs[t], null[t]))
        assert 0 < int(got["single_interrupted_at"]) < N_PERM
        # process 0 alone writes the checkpoint; process 1 resumed from
        # what process 0 read, its own directory untouched
        assert got["ckpt_files"].tolist() == (
            ["multi.npz", "single.npz"] if rank == 0 else [])


def test_ranks_run_process_zeros_superchunk(inputs, tmp_path):
    """Stores seeded with best superchunks 2 (rank 0) and 4 (rank 1):
    both ranks run 2, so they call the tally sum equally often and do not
    hang; counts equal the one-process run's, and only rank 0 records."""
    d, data_path = inputs
    ranks = two_processes(data_path, tmp_path, "autotune")
    assert len(ranks) == 2
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.parallel.multitest import MultiTestEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh(2, 1, devices=[cpu] * 2)
    specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
             zip(d["labels"], d["idx"])]
    cfg = EngineConfig(chunk_size=CHUNK, autotune=False)
    single = PermutationEngine(d["dc"], d["dn"], d["dd"], d["tc"], d["tn"],
                               d["td"], specs, d["pool"], config=cfg,
                               device="cpu", mesh=mesh)
    multi = MultiTestEngine(d["dc"], d["dn"], d["dd"], [d["tc"], d["t2c"]],
                            [d["tn"], d["t2n"]], [d["td"], d["t2d"]],
                            specs, d["pool"], config=cfg, device="cpu",
                            mesh=mesh)
    for name, eng in (("single", single), ("multi", multi)):
        sc = eng.run_null_streaming(N_PERM, eng.observed(), key=SEED)
        want = np.stack([sc.hi, sc.lo, sc.eff])
        for rank, got in enumerate(ranks):
            np.testing.assert_array_equal(got[f"{name}_counts"], want)
            # four chunks of 16 in superchunks of 2: two progress calls
            assert got[f"{name}_calls"].tolist() == [32, 64]
            assert int(got[f"{name}_k"]) == (2 if rank == 0 else -1)
        # the seed's sample, and on rank 0 the run's own
        assert got is ranks[1]
        assert ranks[0][f"{name}_samples"].size == 2
        assert ranks[1][f"{name}_samples"].size == 1


def test_dead_peer_raises_within_timeout(inputs, tmp_path):
    d, data_path = inputs
    t0 = time.monotonic()
    got = two_processes(data_path, tmp_path, "dead")
    assert len(got) == 1  # rank 1 left without a word
    raised = str(got[0]["raised"])
    assert raised, "rank 0's null ran on without its peer"
    assert float(got[0]["raise_s"]) < DEAD_TIMEOUT_S + 15
    assert time.monotonic() - t0 < RUN_TIMEOUT_S


# ---------------------------------------------------------------------------
# the sparse engine and the screened null across processes; the fault drill
# ---------------------------------------------------------------------------

SPLITS = {"split2": (2, 1), "split4": (4, 1)}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """``get(mode, ckpt_root=None) -> (ranks' dicts, out_dir)``: each
    mode's pair spawned once for the tests that read it."""
    cache = {}

    def get(mode, ckpt_root=None):
        if mode not in cache:
            out = tmp_path_factory.mktemp(mode)
            cache[mode] = (two_processes(inputs[1], out, mode, ckpt_root),
                           out)
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def one_process(inputs, tmp_path_factory):
    """The sparse and screened runs on a one-process mesh of each split's
    shape, once each."""
    d = inputs[0]
    cache = {}

    def get(mode):
        if mode not in cache:
            shape = SPLITS[mode]
            mesh = tmesh.make_mesh(*shape, devices=[torch.device("cpu")]
                                   * (shape[0] * shape[1]))
            ck = tmp_path_factory.mktemp(f"one_{mode}")
            cache[mode] = {**_sparse_runs(d, mesh, str(ck)),
                           **_screened_runs(d, mesh, str(ck))}
        return cache[mode]

    return get


def _assert_keys_equal(got, want, prefix, what):
    keys = [k for k in want if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", list(SPLITS))
def test_sparse_split_equals_one_process(spawned, one_process, mode):
    """Observed values, null, ``completed``, the interrupted and resumed
    null and the p-values equal the one-process run on the same mesh
    shape bit for bit; each rank ran ``_values`` once per chunk and own
    shard, at the shard's batch, and process 0 alone wrote the
    checkpoint."""
    ranks, _out = spawned(mode)
    want = one_process(mode)
    P = SPLITS[mode][0]
    chunks = N_PERM // CHUNK
    assert want["spy_sparse_values"].tolist() == [CHUNK // P] * chunks * P
    for rank, got in enumerate(ranks):
        _assert_keys_equal(got, want, "sparse_", f"{mode} rank {rank}")
        assert int(got["sparse_interrupted_at"]) == 2 * CHUNK
        own = got["spy_sparse_values"]
        assert own.tolist() == [CHUNK // P] * chunks * (P // 2)
        assert ("sparse.npz" in got["ckpt_files"].tolist()) == (rank == 0)


@pytest.mark.parametrize("mode", list(SPLITS))
def test_sparse_split_counts_equal_jax(inputs, spawned, mode):
    """Each rank's counts and p-values equal the JAX package's unsplit
    ``sparse_module_preservation`` on the same inputs and seed."""
    d = inputs[0]
    n = int(d["sp_n"])
    rj = netrep_tpu.sparse_module_preservation(
        discovery_network=JAdj(d["sp_d_nbr"], d["sp_d_wgt"], n),
        test_network=JAdj(d["sp_t_nbr"], d["sp_t_wgt"], n),
        module_assignments=d["sp_labels"], discovery_data=d["sp_dx"],
        test_data=d["sp_tx"], n_perm=N_PERM, seed=SEED,
        config=JConfig(chunk_size=CHUNK, autotune=False))
    jnull = np.asarray(rj.nulls)
    for got in spawned(mode)[0]:
        np.testing.assert_array_equal(got["sparse_p"], rj.p_values)
        for a, b in zip(tpv.tail_counts(got["sparse_obs"], got["sparse_null"]),
                        tpv.tail_counts(np.asarray(rj.observed), jnull)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", list(SPLITS))
def test_screened_across_processes_equals_one_process(spawned, one_process,
                                                      mode):
    """Materialized, streaming, both adaptive loops and a resumed
    streaming checkpoint: nulls, counts, ``completed``, ``n_perm_used``
    and the ``RescueState`` counters equal the one-process run on the
    same mesh shape bit for bit; an explicit ``bf16_rescue`` runs and
    ``'auto'`` resolves as in one process; the fused and row-sharded
    refusals keep their texts."""
    want = one_process(mode)
    assert str(want["scr_precision"]) == "bf16_rescue"
    t, r, _disp = want["scr_mat_rescue"]
    assert t == N_PERM and 0 < r < t  # some decided, some rescued
    ranks = spawned(mode)[0]
    assert len(ranks) == 2
    for rank, got in enumerate(ranks):
        _assert_keys_equal(got, want, "scr_", f"{mode} rank {rank}")
        _assert_keys_equal(got, want, "refuse_", f"{mode} rank {rank}")
        assert int(got["scr_interrupted_at"]) == 2 * CHUNK
        assert got["scr_resumed_rescue"][0] == N_PERM
        assert ("screened.npz" in got["ckpt_files"].tolist()) == (rank == 0)


def test_screened_across_processes_counts_equal_f32_and_jax_refusals(
        inputs, spawned):
    """The screened counts and p-values of each rank equal the float32
    run's; the refusals across processes are the JAX engine's texts."""
    d = inputs[0]
    from netrep_tpu_torch.parallel.engine import ModuleSpec, PermutationEngine
    from netrep_tpu_torch.utils.config import EngineConfig

    specs = [ModuleSpec(str(lab), idx, idx) for lab, idx in
             zip(d["labels"], d["idx"])]
    mats = (d["dc"], d["dn"], d["dd"], d["tc"], d["tn"], d["td"])
    f32 = PermutationEngine(*mats, specs, d["pool"], device="cpu",
                            config=EngineConfig(chunk_size=CHUNK,
                                                stat_mode="xla"))
    ranks = spawned("split2")[0]
    obs = ranks[0]["scr_obs"]
    null = f32.run_null(N_PERM, key=SEED)[0]
    want = np.stack(tpv.tail_counts(obs, null))
    ad = f32.run_null_adaptive_streaming(4 * N_PERM, obs, key=SEED)
    jspecs = [JSpec(str(lab), idx, idx) for lab, idx in
              zip(d["labels"], d["idx"])]
    texts = {}
    for name, over in (("fused", dict(stat_mode="fused")),
                       ("row", dict(matrix_sharding="row"))):
        jmesh = None
        if name == "row":
            from netrep_tpu.parallel import mesh as jmeshmod
            jmesh = jmeshmod.make_mesh(n_row_shards=2)
        with pytest.raises(ValueError) as ej:
            JEngine(*mats, jspecs, d["pool"], mesh=jmesh, config=JConfig(
                chunk_size=CHUNK, null_precision="bf16_rescue",
                **{"stat_mode": "xla", **over}))
        texts[name] = str(ej.value)
    for got in ranks:
        np.testing.assert_array_equal(
            np.stack(tpv.tail_counts(obs, got["scr_null"])), want)
        np.testing.assert_array_equal(got["scr_counts"], want)
        np.testing.assert_array_equal(
            tpv.counts_pvalues(obs, *got["scr_counts"]),
            tpv.permutation_pvalues(obs, null))
        np.testing.assert_array_equal(got["scr_n_used"], ad.n_perm_used)
        np.testing.assert_array_equal(
            got["scr_adaptive_stream"], np.stack([ad.hi, ad.lo, ad.eff]))
        for name, text in texts.items():
            assert str(got[f"refuse_{name}"]) == text


def test_device_loss_in_one_rank_ends_both_ranks(spawned):
    """A partial device loss in rank 1 under a policy with a checkpoint:
    rank 1 raises ``CrossProcessRungError`` naming the shrink rung, its
    rank and the checkpoint; rank 0's allgather raises ``PeerLostError``
    (never retried); both well within the group's timeout, and process
    0's checkpoint holds the two chunks completed before the fault."""
    (r0, r1), out = spawned("fault")
    assert str(r1["raised"]) == "CrossProcessRungError"
    assert str(r1["rung"]) == "shrink" and int(r1["err_rank"]) == 1
    assert str(r1["err_checkpoint"]).startswith(str(out / "ckpt1"))
    assert "shrink rung" in str(r1["message"])
    assert str(r0["raised"]) == "PeerLostError"
    assert "rank 0 of 2" in str(r0["message"])
    assert int(r0["n_retry"]) == int(r1["n_retry"]) == 0
    for r in (r0, r1):
        assert float(r["raise_s"]) < DEAD_TIMEOUT_S
    assert r1["drill_files"].tolist() == []
    (name,) = r0["drill_files"].tolist()
    loaded = tckpt.load_null_checkpoint(str(out / "ckpt0" / name))
    assert int(loaded["completed"]) == 2 * CHUNK


def test_fresh_launch_resumes_the_faulted_run(inputs, spawned, tmp_path):
    """A fresh pair resumes from process 0's checkpoint of the fault drill
    (rank 1 retrying a transient fault on the way) to the unbroken run's
    null and p-values on a one-process 2×1 mesh, bit for bit."""
    from netrep_tpu_torch.models.preservation import module_preservation
    from netrep_tpu_torch.utils.config import EngineConfig

    _ranks, fault_out = spawned("fault")
    ranks, _out = spawned("resume", ckpt_root=fault_out)
    d = inputs[0]
    whole = module_preservation(
        **_drill_kw(d), config=EngineConfig(chunk_size=CHUNK),
        mesh=tmesh.make_mesh(2, 1, devices=[torch.device("cpu")] * 2),
        device="cpu")
    rj = netrep_tpu.module_preservation(
        **_drill_kw(d), config=JConfig(chunk_size=CHUNK, autotune=False))
    assert len(ranks) == 2
    for rank, got in enumerate(ranks):
        assert str(got["raised"]) == "", str(got.get("message"))
        assert got["start_perms"].tolist() == [2 * CHUNK]
        assert int(got["completed"]) == N_PERM
        assert int(got["n_retry"]) == (1 if rank == 1 else 0)
        np.testing.assert_array_equal(got["null"], whole.nulls)
        np.testing.assert_array_equal(got["p"], whole.p_values)
        # and the JAX package's unbroken run on the same inputs and seed,
        # within the unsplit parity tolerance
        assert int(got["completed"]) == rj.completed
        np.testing.assert_array_equal(got["p"], rj.p_values)
        np.testing.assert_allclose(got["null"], rj.nulls, rtol=0,
                                   atol=NULL_TOL)


def test_abandoned_dispatch_across_processes_is_terminal(spawned):
    """A hang injected in rank 1 under a ``hang_timeout_s``: the abandoned
    dispatch is not re-dispatched beside a collective it may still enter.
    Rank 1 raises ``CrossProcessRungError`` with the abandon rung; rank 0,
    waiting in the chunk's allgather, raises ``PeerLostError`` when rank 1
    leaves, or abandons its own dispatch and raises the same error as
    rank 1. Neither retries, both end well within the group's timeout,
    and process 0's checkpoint holds the two chunks completed before the
    hang."""
    (r0, r1), out = spawned("hang")
    assert str(r1["raised"]) == "CrossProcessRungError"
    assert str(r1["rung"]) == "abandon" and int(r1["err_rank"]) == 1
    assert str(r1["message"]).startswith(
        "rank 1 of 2: dispatch abandoned (DispatchAbandonedError")
    assert str(r1["err_checkpoint"]).startswith(str(out / "ckpt1"))
    assert int(r1["n_abandoned"]) == 1
    assert (str(r0["raised"]), str(r0["rung"])) in (
        ("PeerLostError", ""), ("CrossProcessRungError", "abandon"))
    for r in (r0, r1):
        assert int(r["n_retry"]) == 0
        assert float(r["raise_s"]) < HANG_TIMEOUT_S + DEAD_TIMEOUT_S
    assert r1["drill_files"].tolist() == []
    (name,) = r0["drill_files"].tolist()
    loaded = tckpt.load_null_checkpoint(str(out / "ckpt0" / name))
    assert int(loaded["completed"]) == 2 * CHUNK


def test_screened_across_processes_equals_jax(inputs, spawned, tmp_path):
    """Each rank's screened null against the JAX package's unsplit
    screened engine (``stat_mode='xla'``, ``null_precision=
    'bf16_rescue'``) on the same inputs, shifted observed values and
    seed: the materialized null's counts and p-values, the streaming
    counts, the adaptive loops' ``completed``, counts and
    ``n_perm_used``, and each run's rescue ``total`` and ``rescued``."""
    import json

    from netrep_tpu.ops import pvalues as jpv
    from netrep_tpu.utils.telemetry import Telemetry as JTelemetry

    d = inputs[0]
    ranks = spawned("split2")[0]
    obs = ranks[0]["scr_obs"]
    jspecs = [JSpec(str(lab), idx, idx) for lab, idx in
              zip(d["labels"], d["idx"])]
    eng = JEngine(d["dc"], d["dn"], d["dd"], d["tc"], d["tn"], d["td"],
                  jspecs, d["pool"], config=JConfig(
                      chunk_size=CHUNK, superchunk=2, autotune=False,
                      stat_mode="xla", null_precision="bf16_rescue"))
    path = str(tmp_path / "tel.jsonl")
    tel = JTelemetry(path)
    try:
        jn, jdone = eng.run_null(N_PERM, key=SEED, observed=obs,
                                 telemetry=tel)
        js = eng.run_null_streaming(N_PERM, obs, key=SEED, telemetry=tel)
        ja = eng.run_null_adaptive(4 * N_PERM, obs, key=SEED, telemetry=tel)
        jas = eng.run_null_adaptive_streaming(4 * N_PERM, obs, key=SEED,
                                              telemetry=tel)
    finally:
        tel.close()
    ends = [e["data"] for e in map(json.loads, open(path))
            if e["ev"] == "null_pass_end"]
    assert len(ends) == 4
    jn, jan = np.asarray(jn), np.asarray(ja[0])
    for got in ranks:
        assert int(got["scr_done"]) == jdone == N_PERM
        np.testing.assert_array_equal(np.stack(tpv.tail_counts(
            obs, got["scr_null"])), np.stack(jpv.tail_counts(obs, jn)))
        np.testing.assert_array_equal(
            tpv.permutation_pvalues(obs, got["scr_null"]),
            jpv.permutation_pvalues(obs, jn))
        np.testing.assert_array_equal(got["scr_counts"],
                                      np.stack([js.hi, js.lo, js.eff]))
        np.testing.assert_array_equal(
            tpv.counts_pvalues(obs, *got["scr_counts"]),
            jpv.counts_pvalues(obs, js.hi, js.lo, js.eff))
        assert int(got["scr_adaptive_done"]) == ja[1]
        np.testing.assert_array_equal(np.isnan(got["scr_adaptive"]),
                                      np.isnan(jan))
        np.testing.assert_array_equal(
            np.stack(tpv.tail_counts(obs, got["scr_adaptive"])),
            np.stack(jpv.tail_counts(obs, jan)))
        assert int(got["scr_adaptive_stream_done"]) == jas.completed
        np.testing.assert_array_equal(got["scr_n_used"], jas.n_perm_used)
        np.testing.assert_array_equal(got["scr_adaptive_stream"],
                                      np.stack([jas.hi, jas.lo, jas.eff]))
        for name, end in zip(("scr_mat", "scr_stream", "scr_adaptive",
                              "scr_adaptive_stream"), ends):
            assert got[f"{name}_rescue"][:2].tolist() == [end["total"],
                                                          end["rescued"]]
