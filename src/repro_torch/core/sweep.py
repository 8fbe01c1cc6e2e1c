"""Declarative sweeps: ``SweepSpec`` -> :func:`run_sweep` ->
``SweepResult``.

A sweep is data: one frozen :class:`SweepSpec` naming the (policy ×
controller × workload × seed) grid, the metrics mode, the fault
override and the device count, validated at construction with the same
errors as ``SimConfig``.  :func:`run_sweep` executes it and returns a
:class:`SweepResult` addressed by grid coordinates.  The old
``simulate_sweep`` survives as a deprecation shim on top of this module.

The reference batches each (policy, controller) over its workloads and
seeds with ``vmap``; its rows equal the single runs bit for bit.  Here
each cell runs through the engine's own tick loop
(:func:`sim.run_ticks`) one after another on one device, so a row is
the cell's ``simulate`` bit for bit by construction.  The workload
grids go to the device once per sweep; the §III-B warmup runs once per
policy and is shared across controllers.  A sweep over more than one
device is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple, Union

from repro_torch.core import controllers as ctrl_lib
from repro_torch.core import policies as policy_lib
from repro_torch.core import registry as registry_lib
from repro_torch.core import sim
from repro_torch.core.workloads import Workload
from repro_torch.kernels import common as kernels_common
from repro_torch.obs import trace as obs_trace

# one realized row of the grid: full timelines or the streaming summary
Row = Union[sim.SimResult, sim.SummaryResult]
# grid coordinates: (policy, controller, workload name, seed)
Coord = Tuple[str, str, str, int]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One declarative sweep: the full grid, validated at construction.

    ``workloads`` accepts a single :class:`Workload` or a sequence
    (coerced to a tuple; grids must share one shape and names must be
    unique).  ``policies`` / ``controllers`` default to the config's
    single policy / controller.  ``faults`` overrides ``config.faults``
    when not ``None`` (pass ``()`` to force the zero-fault engine).
    ``devices`` must be 1: a sweep over more devices is not ported.
    ``targets`` pins the §III-B control targets, skipping the per-policy
    warmup.
    """

    config: sim.SimConfig
    workloads: Tuple[Workload, ...]
    policies: Optional[Tuple[str, ...]] = None
    controllers: Optional[Tuple[str, ...]] = None
    seeds: Tuple[int, ...] = (0,)
    metrics: str = "full"
    devices: int = 1
    faults: Optional[Tuple] = None
    do_warmup: bool = True
    targets: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        # -- workload grid ------------------------------------------------
        wls = (
            (self.workloads,)
            if isinstance(self.workloads, Workload)
            else tuple(self.workloads)
        )
        object.__setattr__(self, "workloads", wls)
        if not wls:
            raise ValueError("SweepSpec needs at least one workload")
        shapes = {tuple(w.keys.shape) for w in wls}
        if len(shapes) > 1:
            raise ValueError(
                f"SweepSpec workloads must share one grid "
                f"shape; got {sorted(shapes)}"
            )
        names = [w.name for w in wls]
        if len(set(names)) != len(names):
            raise ValueError(
                f"SweepSpec workload names must be unique; got {names}"
            )
        # -- policy / controller axes (registry-validated) ----------------
        pols = (
            (self.config.policy,)
            if self.policies is None
            else tuple(self.policies)
        )
        for p in pols:
            policy_lib.get_class(p)  # raises with alternatives
        object.__setattr__(self, "policies", pols)
        ctrls = (
            (self.config.controller,)
            if self.controllers is None
            else tuple(self.controllers)
        )
        for c in ctrls:
            ctrl_lib.get_class(c)
        object.__setattr__(self, "controllers", ctrls)
        # -- seeds / metrics / devices ------------------------------------
        seeds = tuple(int(s) for s in self.seeds)
        object.__setattr__(self, "seeds", seeds)
        if not seeds:
            raise ValueError("SweepSpec needs at least one seed")
        registry_lib.validate_choice(
            self.metrics, "metrics mode", sim.METRICS_MODES
        )
        d = self.devices
        if not isinstance(d, int) or isinstance(d, bool) or d <= 0:
            raise ValueError(
                f"SweepSpec.devices must be a positive int, got {d!r}"
            )
        if d > 1:
            raise sim._unported(f"a sweep over devices={d}", 19)
        # -- fault override: folded into the config (and validated by
        #    SimConfig.__post_init__, which canonicalizes the events)
        if self.faults is not None:
            object.__setattr__(
                self,
                "config",
                dataclasses.replace(self.config, faults=self.faults),
            )
        if self.targets is not None:
            b_tgt, p99_tgt = self.targets
            object.__setattr__(self, "targets", (float(b_tgt), float(p99_tgt)))

    # -- grid views -------------------------------------------------------
    @property
    def workload_names(self) -> Tuple[str, ...]:
        return tuple(w.name for w in self.workloads)

    @property
    def n_cells(self) -> int:
        return (
            len(self.policies)
            * len(self.controllers)
            * len(self.workloads)
            * len(self.seeds)
        )

    def coords(self) -> Iterator[Coord]:
        """Grid coordinates in execution order."""
        for p in self.policies:
            for c in self.controllers:
                for w in self.workload_names:
                    for s in self.seeds:
                        yield (p, c, w, s)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Realized grid: one :class:`Row` per (policy, controller,
    workload, seed) coordinate of the spec."""

    spec: SweepSpec
    cells: Dict[Coord, Row]

    def _pick(self, kind: str, value, options) -> str:
        if value is not None:
            return registry_lib.validate_choice(value, kind, options)
        if len(options) == 1:
            return options[0]
        raise ValueError(
            f"ambiguous {kind}: the sweep has {len(options)} "
            f"({', '.join(str(o) for o in options)}); name one"
        )

    def rows(
        self,
        policy: Optional[str] = None,
        controller: Optional[str] = None,
        workload: Optional[str] = None,
    ) -> Tuple[Row, ...]:
        """Per-seed rows of one grid cell.  Axes with a single value in
        the spec may be omitted; multi-valued axes must be named."""
        p = self._pick("policy", policy, self.spec.policies)
        c = self._pick("controller", controller, self.spec.controllers)
        w = self._pick("workload", workload, self.spec.workload_names)
        return tuple(self.cells[(p, c, w, s)] for s in self.spec.seeds)

    def row(
        self,
        policy: Optional[str] = None,
        controller: Optional[str] = None,
        workload: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> Row:
        """One realized run (seed defaulted when the spec has one)."""
        p = self._pick("policy", policy, self.spec.policies)
        c = self._pick("controller", controller, self.spec.controllers)
        w = self._pick("workload", workload, self.spec.workload_names)
        s = self._pick("seed", seed, self.spec.seeds)
        return self.cells[(p, c, w, s)]

    def items(self):
        """((policy, controller, workload, seed), row) pairs."""
        return self.cells.items()

    def to_legacy(self, single: bool):
        """The pre-SweepSpec ``simulate_sweep`` return shapes:
        ``{policy: rows}`` for a single workload, ``{policy:
        {workload: rows}}`` otherwise.  Requires a single-controller
        spec (the legacy API had no controller axis)."""
        if len(self.spec.controllers) != 1:
            raise ValueError(
                "legacy sweep shape has no controller axis; the spec "
                f"names {len(self.spec.controllers)} controllers"
            )
        (ctrl,) = self.spec.controllers
        out: Dict[str, dict] = {}
        for p in self.spec.policies:
            per_wl = {
                w: self.rows(policy=p, controller=ctrl, workload=w)
                for w in self.spec.workload_names
            }
            out[p] = per_wl[self.spec.workload_names[0]] if single else per_wl
        return out


def run_sweep(spec: SweepSpec, device=None) -> SweepResult:
    """Execute a :class:`SweepSpec` on ``device`` (the CUDA device
    unless the caller passes ``device="cpu"``).

    For each (policy, controller) in the reference's order: the warmup
    (once per policy, unless ``targets`` pins them), the cells' initial
    states, then each (workload, seed) cell through
    :func:`sim.run_ticks` in the spec's metrics mode, then the rows on
    the host, each phase in its span."""
    dev = kernels_common.resolve_device(device)
    cfg = spec.config
    kernels_common.resolve_impl(cfg.route_impl, dev, "route_impl")
    wls = spec.workloads
    # the (T, R) grids go to the device once, shared by every cell
    grids = [(w.keys.to(dev), w.mask.to(dev), w.is_write.to(dev))
             for w in wls]
    targets_by_policy: Dict[str, Tuple[float, float]] = {}
    cells: Dict[Coord, Row] = {}
    for pname in spec.policies:
        for cname in spec.controllers:
            pcfg = dataclasses.replace(cfg, policy=pname, controller=cname)
            if spec.targets is not None:
                b_tgt, p99_tgt = spec.targets
            else:
                # the warmup runs the bare "hash" policy, so it depends on
                # neither the policy's routing nor the controller: one
                # pass per policy, shared across the controller axis
                if pname not in targets_by_policy:
                    with obs_trace.span(
                        "sweep/warmup", cat="warmup", policy=pname
                    ):
                        targets_by_policy[pname] = sim._targets(
                            pcfg, spec.do_warmup, dev
                        )
                b_tgt, p99_tgt = targets_by_policy[pname]
            with obs_trace.span(
                "sweep/init_states",
                cat="host",
                policy=pname,
                controller=cname,
                seeds=len(spec.seeds),
            ):
                # one state a cell: a run updates its (N,) tables in place
                states = [
                    sim.init_state(
                        dataclasses.replace(pcfg, seed=s), b_tgt, p99_tgt,
                        dev,
                    )
                    for _ in wls
                    for s in spec.seeds
                ]
            with obs_trace.span(
                "sweep/execute",
                cat="execute",
                policy=pname,
                controller=cname,
                metrics=spec.metrics,
                devices=spec.devices,
                workloads=len(wls),
                seeds=len(spec.seeds),
            ):
                runs = []
                for w, grid in zip(wls, grids):
                    for s in spec.seeds:
                        scfg = dataclasses.replace(pcfg, seed=s)
                        final, outs = sim.run_ticks(
                            scfg, states.pop(0), *grid,
                            metrics=spec.metrics,
                        )
                        # a full row keeps the final cache, a summary row
                        # nothing of the final state
                        cache = (sim._final_cache(pcfg, final)
                                 if spec.metrics == "full" else None)
                        runs.append((w.name, scfg, cache, outs))
                sim._synchronize(dev)
            with obs_trace.span(
                "sweep/host_slice",
                cat="host",
                policy=pname,
                controller=cname,
                cells=len(wls) * len(spec.seeds),
            ):
                for name, scfg, cache, outs in runs:
                    if spec.metrics == "summary":
                        # outs is the (SummaryAcc, KnobTrace) pair
                        row = sim._to_summary(scfg, *outs)
                    else:
                        row = sim._to_result(scfg, outs, cache)
                    cells[(pname, cname, name, scfg.seed)] = row
    return SweepResult(spec=spec, cells=cells)
