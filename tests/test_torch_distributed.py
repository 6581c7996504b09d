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
rank 0 writes the checkpoint. A peer that dies makes the survivor's next
collective raise within the group's timeout. Each run has its own
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

from netrep_tpu.data import make_mixed_pair  # noqa: E402
from netrep_tpu.parallel import distributed as jdist  # noqa: E402
from netrep_tpu_torch.ops import pvalues as tpv  # noqa: E402
from netrep_tpu_torch.parallel import distributed  # noqa: E402
from netrep_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from netrep_tpu_torch.utils.telemetry import Telemetry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 120
#: the group's collective timeout in the dead-peer run
DEAD_TIMEOUT_S = 20.0
N_PERM, SEED, CHUNK = 64, 5, 16


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


def _worker(data_path, out_dir, rank, port, mode):
    """One process of a two-process run: joins the group, builds the
    mesh of ``mode`` over its one CPU device(s), runs :func:`_runs` (or,
    in mode ``dead``, rank 1 leaves and rank 0 runs a null) and saves
    what it got to ``out_dir/rank<rank>.npz``."""
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
            timeout_s=float(d["dead_timeout_s"]) if mode == "dead" else 120.0)
        shape, per = {"perm2": ((2, 1), 1), "perm4": ((4, 1), 2),
                      "row": ((2, 2), 2), "dead": ((2, 1), 1)}[mode]
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
        else:
            ckpt_dir = os.path.join(out_dir, f"ckpt{rank}")
            os.makedirs(ckpt_dir, exist_ok=True)
            out.update(_runs(d, mesh, ckpt_dir))
            out["ckpt_files"] = np.asarray(sorted(os.listdir(ckpt_dir)))
    names = [r["ev"] for r in events]
    out["n_init"] = np.asarray(names.count("distributed_init"))
    out["n_allgather"] = np.asarray(names.count("allgather"))
    out["allgather_bytes"] = np.asarray(sum(
        r["data"]["bytes"] for r in events if r["ev"] == "allgather"))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()


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
             dead_timeout_s=DEAD_TIMEOUT_S)
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    np.savez(path, **d)
    return d, str(path)


def two_processes(data_path, out_dir, mode) -> list[dict]:
    """Run :func:`_worker` as ranks 0 and 1; both are killed if they have
    not ended within ``RUN_TIMEOUT_S``. Returns each rank's saved dict
    (rank 1 of the dead-peer run saves none)."""
    port = _free_port()
    src = "\n\n".join(inspect.getsource(f) for f in (_runs, _worker))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import os\n{src}\n_worker("
         f"{data_path!r}, {str(out_dir)!r}, {rank}, {port}, {mode!r})"],
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


def test_dead_peer_raises_within_timeout(inputs, tmp_path):
    d, data_path = inputs
    t0 = time.monotonic()
    got = two_processes(data_path, tmp_path, "dead")
    assert len(got) == 1  # rank 1 left without a word
    raised = str(got[0]["raised"])
    assert raised, "rank 0's null ran on without its peer"
    assert float(got[0]["raise_s"]) < DEAD_TIMEOUT_S + 15
    assert time.monotonic() - t0 < RUN_TIMEOUT_S
