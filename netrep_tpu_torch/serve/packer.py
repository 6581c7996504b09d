"""Cross-request packing: several preservation requests in one engine run.

The port of ``netrep_tpu/serve/packer.py``. N compatible requests (the
same test matrices and permutation pool, different module sets, seeds and
budgets) become ONE engine run over the union of their modules:

- :class:`PackedEngine` — a :class:`~netrep_tpu_torch.parallel.engine.
  PermutationEngine` whose buckets hold every request's modules, with the
  two identities of each request's own run kept exactly:

  * **slice offsets** are request-local: module k of request r slices the
    drawn permutation at the offset its own run uses, so slices of
    different requests may overlap;
  * **key groups**: the root key is one key per request, ``(G,)``, so a
    chunk's keys are ``(C, G)`` (:func:`~netrep_tpu_torch.random.
    perm_keys`), each request's column its own ``fold_in(key_r, i)``
    stream, and the draw is ``(C, G, P)``. The engine lays it out as
    ``(C, G·P)`` and every module's ``take`` positions read its request's
    part (``g·P + off + j``), so ``rebucket`` and both kernels' index
    inputs are the solo engine's.

  A packed module therefore gathers the index sets its own run gathers at
  the same permutation indices, and its statistics go through the same
  kernels: ``stat_mode`` resolves as in a solo engine (the fused-
  statistics kernel on the card by default; ``'xla'`` gives the composed
  statistics through the gather kernel). The JAX package pins its packs
  to its XLA composition, because its mega-kernel draws from one key
  stream; the port's kernels take index blocks, so grouped blocks run
  through them unchanged.

- :class:`GridPackedEngine` — one shared TEST dataset, one discovery
  source per request: the engine of a grid column. Each source's props
  are computed at build, one source on the device at a time, and its
  matrices are not kept.

- :class:`PackMonitor` — the retirement controller that
  :meth:`~netrep_tpu_torch.parallel.engine.PermutationEngine.
  run_null_monitored` folds each chunk into: each request's ceiling,
  adaptive child monitors (warm-started from priors), deadlines on an
  injectable clock, per-request cost attribution, and checkpoint state.

- :func:`run_pack` — observed pass, monitored null, then each request's
  result as its own ``module_preservation`` call gives it.

Packs run replicated and mesh-free: a mesh, ``matrix_sharding='row'`` and
``gather_mode='fused'`` are refused with the JAX package's texts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from .. import random as trandom
from ..ops import pvalues as pv
from ..ops import stats as tstats
from ..ops.sequential import StopMonitor, StopRule
from ..parallel.engine import (
    ModuleSpec, PermutationEngine, _block_positions, build_buckets,
    build_discovery, check_derived_network, props_mode,
)
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig


@dataclasses.dataclass
class RequestPlan:
    """One request's own-run identity inside a pack: the module specs (in
    the order ``module_preservation`` keeps them), the permutation pool,
    budget, seed and p-value conventions. ``base`` is the request's first
    module in the pack (:func:`assign_bases`)."""

    labels: list
    specs: list[ModuleSpec]
    counts: dict
    pool: np.ndarray
    n_perm: int
    seed: int
    alternative: str = "greater"
    adaptive: bool = False
    rule: object | None = None
    base: int = 0
    #: deadline on the monitor's clock: past it, the request's active
    #: modules are retired at the next chunk boundary and the request
    #: comes back expired; None never expires
    deadline: float | None = None
    #: warm-start ``(hi, lo, n_used)`` tallies of a prior run of the
    #: cell, seeded into the adaptive child's decisions only (reported
    #: tallies and p-values stay fresh-draw-only); ignored unless adaptive
    priors: object | None = None

    @property
    def k(self) -> int:
        return len(self.specs)

    @property
    def sizes(self) -> list[int]:
        return [m.size for m in self.specs]

    _sig: str | None = dataclasses.field(default=None, repr=False,
                                         compare=False)

    def signature(self) -> str:
        """Structural identity of the plan (labels, index sets, pool; not
        seed, budget or alternative), memoized: the JAX package's, byte
        for byte."""
        if self._sig is not None:
            return self._sig
        h = hashlib.blake2b(digest_size=8)
        for m in self.specs:
            h.update(str(m.label).encode() + b"|")
            h.update(np.ascontiguousarray(m.disc_idx, dtype=np.int64))
            h.update(np.ascontiguousarray(m.test_idx, dtype=np.int64))
        h.update(np.ascontiguousarray(self.pool, dtype=np.int64))
        self._sig = h.hexdigest()
        return self._sig


def assign_bases(plans: list[RequestPlan]) -> int:
    """Give each plan its first module's position in the pack; returns the
    pack's module count."""
    base = 0
    for p in plans:
        p.base = base
        base += p.k
    return base


class PackedEngine(PermutationEngine):
    """Permutation engine over the union of several requests' modules with
    request-local slice offsets and per-request key groups (module
    docstring).

    ``request_modules`` is one ``[ModuleSpec, ...]`` list per request, in
    :func:`assign_bases` order; the run methods' ``key`` is then the list
    of per-request seeds (or scalar :class:`~netrep_tpu_torch.random.
    ThreefryKey` s), or a ``(G,)`` key. Every request shares the
    (discovery, test) matrices and the pool. ``device`` as in
    :class:`~netrep_tpu_torch.parallel.engine.PermutationEngine`.
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corr, test_net,
                 test_data, request_modules, pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh=None, observed_cache=None):
        if mesh is not None or config.matrix_sharding == "row":
            raise ValueError(
                "packed serve engines run replicated and mesh-free (v1); "
                "drop the mesh / matrix_sharding='row'"
            )
        mods, offs, groups = [], [], []
        pool_size = int(np.asarray(pool).size)
        for g, specs in enumerate(request_modules):
            off = 0
            for m in specs:
                mods.append(m)
                offs.append(off)
                groups.append(g)
                off += m.size
            # each request against the pool: the union of request-local
            # slices may exceed it
            if off > pool_size:
                raise ValueError(
                    f"packed request {g}: module sizes (total {off}) exceed "
                    f"the null candidate pool ({pool_size})"
                )
        if not mods:
            raise ValueError("a pack needs at least one module")
        if config.gather_mode == "fused":
            raise ValueError(
                "gather_mode='fused' is not supported by the packed engine "
                "(v1); use 'direct'/'mxu'/'auto'"
            )
        self._packed_offsets = np.asarray(offs, dtype=np.int64)
        self._module_group = np.asarray(groups, dtype=np.int64)
        self.n_groups = len(request_modules)
        super().__init__(disc_corr, disc_net, disc_data, test_corr, test_net,
                         test_data, mods, pool, config=config, device=device,
                         observed_cache=observed_cache)

    # -- the two per-request identities -----------------------------------

    def _slice_offsets(self, modules) -> np.ndarray:
        return self._packed_offsets

    def _build_buckets(self, disc_corr, disc_net, disc_data, modules, pool,
                       config, dev, mesh) -> list[dict]:
        """The union buckets, each request's segment built from the shared
        discovery side exactly as its solo engine builds its buckets, so a
        module's props are its solo run's bit for bit (a bucket's props
        come from batched decompositions, whose rounding follows the
        batch). The discovery matrices are read where they lie, a host
        registration's on the host (:func:`~netrep_tpu_torch.parallel.
        engine.build_buckets`): only the buckets' blocks reach ``dev``."""
        if self.n_groups == 1:
            return super()._build_buckets(disc_corr, disc_net, disc_data,
                                          modules, pool, config, dev, mesh)
        net_beta = config.network_from_correlation
        cache = None
        if self._observed_cache is not None:
            cache = (self._observed_cache,
                     ckpt.content_digest([disc_corr, disc_net, disc_data]),
                     props_mode(disc_corr is None and disc_net is None,
                                False, net_beta, disc_data is not None))
        parts = []
        for g in range(self.n_groups):
            pos = self.request_positions(g)
            parts.append((pos, build_discovery(
                disc_corr, disc_net, disc_data, [modules[p] for p in pos],
                pool, config, dev, offsets=self._packed_offsets[pos],
                cache=cache)))
        return merge_segments(parts)

    def _observed_bucket(self, b, subs) -> torch.Tensor:
        """A union bucket's observed statistics, each request's rows
        computed as one batch of their own: the solo engine's bucket, so
        the observed values (which every tally and stop decision compares
        against) are its solo run's bit for bit."""
        groups = self._module_group[np.asarray(b.module_pos, dtype=np.int64)]
        cuts = np.flatnonzero(np.diff(groups)) + 1
        if not cuts.size:
            return super()._observed_bucket(b, subs)
        parts = []
        for lo, hi in zip([0, *cuts], [*cuts, len(groups)]):
            seg = dataclasses.replace(
                b, module_pos=b.module_pos[lo:hi],
                disc=tstats.DiscProps(*(x[lo:hi] for x in b.disc)),
                obs_idx=b.obs_idx[lo:hi], slices=b.slices[lo:hi],
                take=b.take[lo:hi])
            parts.append(super()._observed_bucket(seg, subs))
        return torch.cat(parts)

    def _take_positions(self, cap, module_pos, slices, dev) -> torch.Tensor:
        P = self.pool.size
        return _block_positions(
            cap, slices, P * self.n_groups, dev,
            [P * int(self._module_group[p]) for p in module_pos])

    def _draw(self, keys: trandom.ThreefryKey) -> torch.Tensor:
        # (C, G) keys -> (C, G, P) draws, laid end to end per permutation
        return trandom.permutation(keys, self._pool_dev).flatten(-2)

    def _root_key(self, key) -> trandom.ThreefryKey:
        """The ``(G,)`` root key: ``key`` is the per-request seed list
        (ints or scalar keys) in group order, or a ``(G,)`` key."""
        if isinstance(key, trandom.ThreefryKey):
            ks = [key] if key.shape == () else [
                trandom.ThreefryKey(w) for w in key.words]
        else:
            ks = [
                trandom.key(int(s), device=self.device)
                if isinstance(s, (int, np.integer)) else s
                for s in key
            ]
        if len(ks) != self.n_groups:
            raise ValueError(
                f"packed run needs {self.n_groups} per-request keys, "
                f"got {len(ks)}"
            )
        return trandom.ThreefryKey(torch.stack(
            [k.words.to(self.device) for k in ks]))

    def run_key(self) -> str:
        """The solo engine's ``compile_span`` key plus the pack's group
        count, so packed and solo runs never share a history."""
        return f"{super().run_key()}|packed:{self.n_groups}"

    def request_positions(self, g: int) -> np.ndarray:
        """The pack positions of request ``g``'s modules."""
        return np.flatnonzero(self._module_group == g)


def merge_segments(parts) -> list[dict]:
    """Union buckets from per-request segments ``(positions, buckets)``:
    each capacity's segments concatenated in request order (rows of
    ``disc``, ``obs_idx``, ``slices``), module positions mapped to the
    pack's."""
    merged: dict[int, list] = {}
    for pos, bks in parts:
        for b in bks:
            merged.setdefault(b["cap"], []).append(
                dict(b, module_pos=[int(pos[k]) for k in b["module_pos"]]))
    out = []
    for cap in sorted(merged):
        segs = merged[cap]
        disc = segs[0]["disc"] if len(segs) == 1 else tstats.DiscProps(
            *(torch.cat(xs) for xs in zip(*(s["disc"] for s in segs))))
        out.append(dict(
            cap=cap, disc=disc,
            module_pos=[p for s in segs for p in s["module_pos"]],
            obs_idx=np.concatenate([s["obs_idx"] for s in segs]),
            slices=[sl for s in segs for sl in s["slices"]],
        ))
    return out


class GridPackedEngine(PackedEngine):
    """Cross-pair pack: :class:`PackedEngine` with one shared TEST dataset
    and one discovery source per request — a grid column, each cell
    testing another cohort's modules in the same test cohort.

    ``disc_sources`` is one ``(corr, net, data)`` triple per request,
    aligned with ``request_modules``. Discovery matrices enter a chunk only
    through a bucket's props, one row per module, and the statistics are
    computed module by module: so a union bucket whose rows come from each
    request's own source runs every module as its solo engine does. A
    bucket's rows are request-contiguous (union order is request-major and
    capacity grouping keeps it), so each request's segment is built from
    its own source exactly as its solo engine builds it — which is also
    what makes the observed cache's keys line up across grid and solo.
    Each source is read once, at build, and copied to the device only
    while its props are computed (not at all when the cache has them);
    the engine keeps no discovery matrix.

    Beyond :class:`PackedEngine`: every request shares the pool byte for
    byte, every source and the test dataset agree on data presence, and
    matrices are materialized (data-only cells run per pair).
    """

    def __init__(self, disc_sources, test_corr, test_net, test_data,
                 request_modules, pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh=None, observed_cache=None):
        if len(disc_sources) != len(request_modules):
            raise ValueError(
                f"got {len(disc_sources)} discovery sources for "
                f"{len(request_modules)} packed requests"
            )
        if any(s[0] is None or s[1] is None for s in disc_sources):
            raise ValueError(
                "cross-pair grid packs need materialized discovery "
                "matrices; data-only cells run per-pair"
            )
        presence = {s[2] is not None for s in disc_sources}
        if len(presence) != 1 or (test_data is not None) not in presence:
            raise ValueError(
                "cross-pair grid packs need every discovery source and "
                "the test dataset to agree on data presence"
            )
        beta = config.network_from_correlation
        if beta is not None:
            # source 0 is checked by the base engine's build
            for i, (dc, dn, _dd) in enumerate(disc_sources[1:], start=1):
                check_derived_network(dc, dn, beta, f"discovery[{i}]")
        self._disc_sources = list(disc_sources)
        try:
            super().__init__(
                disc_sources[0][0], disc_sources[0][1], disc_sources[0][2],
                test_corr, test_net, test_data, request_modules, pool,
                config=config, device=device, mesh=mesh,
                observed_cache=observed_cache,
            )
        finally:
            self._disc_sources = None
        # the checkpoint identity covers every discovery source
        self._digest = ckpt.content_digest(
            [a for s in disc_sources for a in s]
            + [test_corr, test_net, test_data])

    def _build_buckets(self, disc_corr, disc_net, disc_data, modules, pool,
                       config, dev, mesh) -> list[dict]:
        bad = [m.label for m in modules if m.size < 2]
        if bad:
            raise ValueError(
                f"modules {bad} have fewer than 2 nodes present in the test "
                "dataset; preservation statistics are undefined"
            )
        if config.network_from_correlation is not None:
            check_derived_network(disc_corr, disc_net,
                                  config.network_from_correlation,
                                  "discovery")
        net_beta = config.network_from_correlation
        mode = props_mode(False, False, net_beta, disc_data is not None)
        parts = []
        for g, (dc, dn, dd) in enumerate(self._disc_sources):
            pos = self.request_positions(g)
            if not pos.size:
                continue
            cache = None
            if self._observed_cache is not None:
                cache = (self._observed_cache,
                         ckpt.content_digest([dc, dn, dd]), mode)
            bks = build_buckets(
                dc, dn, dd if disc_data is not None else None,
                [modules[p] for p in pos], pool, config, dev,
                offsets=self._packed_offsets[pos], cache=cache)
            parts.append((pos, bks))
        return merge_segments(parts)


class PackMonitor:
    """Retirement controller of a packed run: the
    :class:`~netrep_tpu_torch.ops.sequential.StopMonitor` surface that
    :meth:`~netrep_tpu_torch.parallel.engine.PermutationEngine.
    run_null_monitored` folds each chunk into (the JAX package's
    ``PackMonitor``).

    Per request, at every chunk boundary and in the order of its own run:

    1. **stop rule** (adaptive requests): a child :class:`StopMonitor` of
       the request's modules, fed exactly the rows its own run folds (the
       chunk that crosses the request's ceiling truncated to ``n_perm_r -
       folded``, as that run's tail chunk), so its decisions are that
       run's;
    2. **ceiling**: once the pack's fold reaches the request's ``n_perm``,
       its remaining modules are force-retired and leave the dispatch.

    ``n_used`` holds each module's permutation count. A plan's
    ``deadline`` is checked against ``clock()`` at every boundary; past
    it, the request's active modules are retired and its index lands in
    :attr:`expired` with the miss in seconds. With
    :meth:`enable_cost_tracking` on (``run_pack`` turns it on with
    telemetry), each chunk's live-module weights and host bytes are
    recorded, the engine loop adds the chunk's measured seconds
    (:meth:`note_chunk_cost`), and :meth:`request_costs` splits them over
    the requests so that the members sum exactly to the pack totals.
    :meth:`state_arrays` / :meth:`restore_state` ride the checkpoint's
    extras, each adaptive child under ``g<i>_``.
    """

    def __init__(self, plans: list[RequestPlan], observed: np.ndarray,
                 clock=None):
        self.plans = plans
        self.clock = clock if clock is not None else time.monotonic
        self.observed = np.asarray(observed, dtype=np.float64)
        self.n_modules = sum(p.k for p in plans)
        if self.observed.shape[0] != self.n_modules:
            raise ValueError(
                f"observed has {self.observed.shape[0]} modules, plans "
                f"describe {self.n_modules}"
            )
        self.active = np.ones(self.n_modules, dtype=bool)
        self.n_used = np.zeros(self.n_modules, dtype=np.int64)
        self.folded = 0
        self.telemetry = None
        #: plan index -> seconds past its deadline when it was cancelled
        self.expired: dict[int, float] = {}
        self._cost_enabled = False
        self._cost_chunks: list[dict] = []
        self.children: list[StopMonitor | None] = []
        for p in plans:
            if p.adaptive:
                child = StopMonitor(
                    self.observed[p.base: p.base + p.k],
                    p.alternative, p.rule or StopRule(),
                )
                if p.priors is not None:
                    child.seed_priors(*p.priors)
                self.children.append(child)
            else:
                self.children.append(None)

    # -- StopMonitor surface ----------------------------------------------

    def active_positions(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    def any_active(self) -> bool:
        return bool(self.active.any())

    def total_evaluated(self) -> int:
        return int(self.n_used.sum())

    def update(self, vals: np.ndarray, take: int) -> np.ndarray:
        """Fold one chunk (``vals`` ``(take, n_active, cells)`` in
        :meth:`active_positions` order); returns the positions retired at
        this boundary — rule decisions, ceilings and deadlines."""
        pos = self.active_positions()
        vals = np.asarray(vals, dtype=np.float64)
        done0 = self.folded
        if self._cost_enabled:
            # the chunk ran with this active set: a member's share is its
            # live modules × the chunk's permutations
            live = {}
            for gi, p in enumerate(self.plans):
                c = int(np.count_nonzero(
                    (pos >= p.base) & (pos < p.base + p.k)))
                if c:
                    live[gi] = c
            self._cost_chunks.append({"take": int(take), "live": live,
                                      "bytes": int(vals.nbytes)})
        newly: list[np.ndarray] = []
        for p, child in zip(self.plans, self.children):
            cols = np.flatnonzero((pos >= p.base) & (pos < p.base + p.k))
            if not cols.size:
                continue
            gpos = pos[cols]
            # the rows this request still owes: its own run's tail chunk
            # when the ceiling lands inside this one
            rows = int(min(take, max(0, p.n_perm - done0)))
            if rows > 0:
                if child is not None:
                    child.telemetry = self.telemetry
                    retired = child.update(vals[:rows, cols, :], rows)
                    self.n_used[p.base: p.base + p.k] = child.n_used
                    if retired.size:
                        g = p.base + retired
                        self.active[g] = False
                        newly.append(g)
                else:
                    self.n_used[gpos] += rows
            if done0 + take >= p.n_perm:
                # budget spent: the survivors leave the shared dispatch
                ceiling = (p.base + child.force_retire()
                           if child is not None else gpos)
                still = ceiling[self.active[ceiling]]
                if still.size:
                    self.active[still] = False
                    newly.append(still)
        self.folded = done0 + int(take)
        # deadlines: the boundary is the cancellation point, and the
        # request leaves through the exit the ceiling takes
        now = self.clock()
        for gi, p in enumerate(self.plans):
            if p.deadline is None or gi in self.expired or now <= p.deadline:
                continue
            span = np.arange(p.base, p.base + p.k)
            still = span[self.active[span]]
            if still.size:
                self.active[still] = False
                newly.append(still)
                self.expired[gi] = now - p.deadline
        if newly:
            return np.concatenate(newly)
        return np.empty(0, dtype=np.int64)

    # -- cost attribution --------------------------------------------------

    def enable_cost_tracking(self) -> None:
        """Record each chunk's cost weights (``run_pack`` turns it on with
        telemetry; off, nothing is recorded)."""
        self._cost_enabled = True

    def note_chunk_cost(self, dispatch_s: float,
                        transfer_s: float = 0.0) -> None:
        """Engine-loop hook: the measured dispatch and host-copy seconds
        of the chunk whose weights :meth:`update` just recorded."""
        if not self._cost_enabled:
            return
        for rec in reversed(self._cost_chunks):
            if "dispatch_s" not in rec:
                rec["dispatch_s"] = float(dispatch_s)
                rec["transfer_s"] = float(transfer_s)
                return

    #: the request_costs fields under the conservation contract
    COST_FIELDS = ("device_s", "transfer_s", "perms", "bytes_to_host",
                   "compile_s_amortized")

    def request_costs(self) -> dict | None:
        """Per-request cost attribution over the recorded chunks (None
        when tracking was off or nothing ran): ``{"members": [per plan],
        "totals": {...}, "measured_device_s": float}``. Per chunk, member
        g's weight is ``live_modules_g × take``; ``perms`` and
        ``bytes_to_host`` split by largest remainder, ``device_s`` and
        ``transfer_s`` with the remainder to the last live member, and
        ``compile_s_amortized`` (the first dispatch's surplus over the
        median of the rest) by weight share. ``totals`` are the ordered
        float64 sums of the member fields, so members sum to them
        exactly."""
        if not self._cost_enabled or not self._cost_chunks:
            return None
        G = len(self.plans)
        perms = [0] * G
        byts = [0] * G
        dev = [0.0] * G
        xfer = [0.0] * G
        disp_series: list[float] = []
        for c in self._cost_chunks:
            live = c["live"]
            take = int(c["take"])
            if not live or take <= 0:
                continue
            order = sorted(live)
            ws = {g: live[g] * take for g in order}
            W = sum(ws.values())
            d_s = float(c.get("dispatch_s", 0.0))
            t_s = float(c.get("transfer_s", 0.0))
            disp_series.append(d_s)
            for g in order:
                perms[g] += take
            b = int(c["bytes"])
            base = {g: b * ws[g] // W for g in order}
            rem = b - sum(base.values())
            for g in sorted(order, key=lambda g: (-(b * ws[g] % W), g)):
                if rem <= 0:
                    break
                base[g] += 1
                rem -= 1
            for g in order:
                byts[g] += base[g]
            for arr, cost in ((dev, d_s), (xfer, t_s)):
                acc = 0.0
                for g in order[:-1]:
                    x = cost * (ws[g] / W)
                    arr[g] += x
                    acc += x
                arr[order[-1]] += cost - acc
        if len(disp_series) >= 2:
            rest = sorted(disp_series[1:])
            comp = max(0.0, disp_series[0] - rest[len(rest) // 2])
        else:
            comp = 0.0
        wtot = [
            sum(c["live"].get(g, 0) * int(c["take"])
                for c in self._cost_chunks)
            for g in range(G)
        ]
        w_all = sum(wtot)
        comp_g = [0.0] * G
        if comp > 0 and w_all > 0:
            live_gs = [g for g in range(G) if wtot[g] > 0]
            acc = 0.0
            for g in live_gs[:-1]:
                x = comp * (wtot[g] / w_all)
                comp_g[g] = x
                acc += x
            comp_g[live_gs[-1]] = comp - acc
        members = [
            {
                "device_s": dev[g], "transfer_s": xfer[g],
                "perms": perms[g], "bytes_to_host": byts[g],
                "compile_s_amortized": comp_g[g],
                "weight": int(wtot[g]),
            }
            for g in range(G)
        ]
        totals: dict = {f: 0 for f in ("perms", "bytes_to_host")}
        totals.update({f: 0.0 for f in ("device_s", "transfer_s",
                                        "compile_s_amortized")})
        for m in members:
            for f in self.COST_FIELDS:
                totals[f] += m[f]
        totals["weight"] = int(w_all)
        return {"members": members, "totals": totals,
                "measured_device_s": sum(disp_series)}

    # -- checkpoint state --------------------------------------------------

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The pack's checkpointable state: union tallies, expiries, and
        each adaptive child's state under ``g<i>_``."""
        exp = sorted(self.expired)
        out = {
            "pack_active": self.active,
            "pack_n_used": self.n_used,
            "pack_folded": np.int64(self.folded),
            "pack_expired": np.asarray(exp, dtype=np.int64),
            "pack_expired_miss": np.asarray(
                [self.expired[g] for g in exp], dtype=np.float64),
        }
        for g, child in enumerate(self.children):
            if child is not None:
                for k, v in child.state_arrays().items():
                    out[f"g{g}_{k}"] = v
        return out

    def restore_state(self, extras: dict) -> None:
        """Restore from checkpoint extras (shape-checked); an expired
        request stays cancelled across the restart."""
        try:
            active = extras["pack_active"]
            n_used = extras["pack_n_used"]
            folded = extras["pack_folded"]
        except KeyError:
            raise ValueError(
                "checkpoint has no pack-monitor state (it was written by "
                "a non-packed run); refusing to resume"
            ) from None
        if np.asarray(active).shape != self.active.shape:
            raise ValueError(
                "checkpoint pack state has a different module count; "
                "refusing to resume"
            )
        self.active = np.asarray(active, dtype=bool)
        self.n_used = np.asarray(n_used, dtype=np.int64)
        self.folded = int(folded)
        self.expired = {
            int(g): float(m)
            for g, m in zip(np.asarray(extras.get("pack_expired", []),
                                       dtype=np.int64).ravel(),
                            np.asarray(extras.get("pack_expired_miss", []),
                                       dtype=np.float64).ravel())
        }
        for g, child in enumerate(self.children):
            if child is None:
                continue
            prefix = f"g{g}_"
            child.restore_state({k[len(prefix):]: v
                                 for k, v in extras.items()
                                 if k.startswith(prefix)})


def run_pack(engine: PackedEngine, plans: list[RequestPlan],
             telemetry=None, fault_policy=None, progress=None,
             checkpoint_path=None, checkpoint_every: int = 8192,
             clock=None) -> list[dict]:
    """Run one pack: the shared observed pass, the monitored null over the
    union buckets, then each request's result (one dict per plan, in
    order) with the numbers its own ``module_preservation`` call gives.

    ``checkpoint_path`` saves the pack at chunk boundaries (the monitor's
    state in the extras) and resumes an interrupted pack exactly. A plan
    cancelled by its deadline comes back with ``expired`` and
    ``deadline_miss_s`` instead of a result. With ``telemetry`` each
    result carries its ``cost`` share."""
    observed = np.asarray(engine.observed(), dtype=np.float64)
    monitor = PackMonitor(plans, observed, clock=clock)
    if telemetry is not None:
        monitor.enable_cost_tracking()
    n_perm_max = max(p.n_perm for p in plans)
    seeds = [p.seed for p in plans]
    nulls, completed, finished = engine.run_null_monitored(
        n_perm_max, seeds, monitor, progress=progress,
        telemetry=telemetry, fault_policy=fault_policy,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
    )
    costs = monitor.request_costs()

    def cost_of(gi: int) -> dict | None:
        if costs is None:
            return None
        return dict(costs["members"][gi], pack_totals=dict(costs["totals"]))

    out = []
    for gi, p in enumerate(plans):
        if gi in monitor.expired:
            res = {
                "expired": True,
                "deadline_miss_s": float(monitor.expired[gi]),
                "n_perm": int(p.n_perm),
                "completed": int(min(monitor.folded, p.n_perm)),
            }
            if costs is not None:
                res["cost"] = cost_of(gi)
            out.append(res)
            continue
        obs_r = observed[p.base: p.base + p.k]
        nulls_r = nulls[: p.n_perm, p.base: p.base + p.k, :]
        total_space = pv.total_permutations(p.pool.size, p.sizes)
        completed_r = min(int(completed), p.n_perm)
        if p.adaptive:
            p_values, n_used = pv.sequential_pvalues(
                obs_r, nulls_r, p.alternative, total_nperm=total_space)
            p_type = "sequential"
        else:
            p_values = pv.permutation_pvalues(
                obs_r, nulls_r, p.alternative, total_nperm=total_space)
            n_used = None
            p_type = "fixed"
        hi, lo, eff = pv.tail_counts(obs_r, nulls_r)
        n_present = np.array([p.counts[lab][0] for lab in p.labels])
        tot = np.array([p.counts[lab][1] for lab in p.labels])
        cost = cost_of(gi)
        out.append({
            **({"cost": cost} if cost is not None else {}),
            "module_labels": list(p.labels),
            "observed": obs_r,
            "p_values": p_values,
            "counts_hi": hi, "counts_lo": lo, "counts_eff": eff,
            "n_perm": int(p.n_perm),
            "completed": completed_r,
            "n_perm_used": n_used,
            "p_type": p_type,
            "alternative": p.alternative,
            "seed": int(p.seed),
            "n_vars_present": n_present,
            "prop_vars_present": n_present / tot,
            "total_size": tot,
            "total_space": total_space,
            "finished": bool(finished),
        })
    return out
