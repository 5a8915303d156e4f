"""Declarative campaign grids and their expansion into prediction jobs.

A :class:`CampaignSpec` is a small JSON-able description of a sweep; every
axis is a list and the grid is the cross product — except axes joined in
a ``zip`` group, which are paired element-wise (the paper's Fig 9 pairs
each scale-out workload with its own fabric; a cross product cannot
express that).  Expansion produces :class:`JobSpec` records made only of
primitives, so they pickle cleanly into worker processes and serialize
verbatim into result rows.

The port's copy of the reference's ``campaign/spec.py``.  Its one
difference: a spec that names an estimator kind the port has not ported
yet (``learned``) fails validation with
``NotImplementedError`` naming the slice that brings it.
"""
from __future__ import annotations

import itertools
import json
import os
from dataclasses import asdict, dataclass, field

# the estimator/topology vocabularies are OPEN: the registries are the
# single source of truth (builders resolves through the same objects, so
# validation and execution cannot disagree), and membership checks never
# import a backend module — ``validate`` stays usable without numpy
from ..core.catalog import SystemRegistry, default_registry
from ..core.registry import ESTIMATORS, TOPOLOGIES

SLICER_NAMES = ("linear", "dep", "dependency-aware")


def __getattr__(name: str):
    """Back-compat: the historical closed-vocabulary tuples now reflect
    the live registries (``from repro_torch.campaign.spec import
    ESTIMATOR_KINDS`` keeps working and includes plugin kinds)."""
    if name == "ESTIMATOR_KINDS":
        return ESTIMATORS.kinds()
    if name == "TOPOLOGY_KINDS":
        return TOPOLOGIES.kinds()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

#: the grid axes, in canonical (expansion) order — ``zip`` groups may
#: only name these, and expansion enumerates them in exactly this order
AXIS_FIELDS = ("workloads", "systems", "estimators", "slicers",
               "topologies", "overlap", "straggler_factor", "compression")


@dataclass(frozen=True)
class WorkloadSpec:
    """One workload axis entry.  Exactly one source family must be given:

    * ``stablehlo_path`` / ``hlo_path`` — pre-exported IR text on disk;
    * ``arch`` (+ ``seq``/``batch``/``mode``/``mesh``/…) — the port's
      export (a trace on fake tensors) of a registered model config.  ``mode="forward"`` exports one forward pass;
      ``mode="train"`` exports a *full train step* — loss + gradients +
      optimizer update, with abstract optimizer state and mesh shardings
      threaded through the lowering.  ``arch`` ids cover the LM registry
      ("llama3-1b", …) and the ResNet family ("resnet50", …; train-only,
      ``img`` sets the image size).  ``mode="prefill"``/``"decode"`` are
      the *serving* shapes: a framework-free synthesized step from the model
      config's layer dims — prefill processes ``batch × seq`` prompt
      tokens at once; decode emits one token per sequence against a
      ``seq``-deep KV cache (the KV-cache-bound regime), so ``batch``
      and ``seq`` are the serving sweep axes;
    * ``gemm`` — a synthesized single-``dot_general`` StableHLO workload
      (``{"m":.., "n":.., "k":.., "dtype":"bf16"}``) for operator-level
      sweeps like the paper's Fig 10 — no framework required.

    ``mesh`` is the device-mesh shape for arch exports: 2 entries map to
    ("data", "model") axes, 3 to ("pod", "data", "model").  The port
    exports the global step as the raw text and the per-rank program of
    the data mesh as the optimized text (a ``model`` or ``pod`` axis above
    1 raises ``NotImplementedError``).

    ``fidelity`` is the *default* program fidelity for this workload; an
    :class:`EstimatorSpec` may override it (the paper's estimator classes
    consume different IR stages: analytical -> optimized, profiling -> raw).
    """
    name: str
    stablehlo_path: str | None = None
    hlo_path: str | None = None
    arch: str | None = None
    gemm: dict | None = None         # {"m","n","k","dtype"} synthesis
    seq: int = 512
    batch: int = 4
    img: int = 224                   # resnet archs: input image size
    mode: str = "forward"            # "forward"|"train"|"prefill"|"decode"
    mesh: tuple | None = None        # device mesh shape for arch exports
    optimizer: str = "adamw"         # train-mode optimizer ("adamw"/"adafactor")
    fidelity: str | None = None      # default: optimized if available

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        """Build from the JSON dict form (mesh lists become tuples)."""
        d = dict(d)
        if d.get("mesh") is not None:
            d["mesh"] = tuple(int(x) for x in d["mesh"])
        return cls(**d)

    def validate(self) -> None:
        """Reject specs that would run wrong or not at all (exactly one
        source family, known mode/optimizer, sane mesh/gemm fields)."""
        families = [bool(self.stablehlo_path or self.hlo_path),
                    self.arch is not None, self.gemm is not None]
        if sum(families) == 0:
            raise ValueError(
                f"workload {self.name!r}: need stablehlo_path, hlo_path, "
                "arch, or gemm")
        if sum(families) > 1:
            raise ValueError(
                f"workload {self.name!r}: give exactly one source family "
                "(stablehlo_path/hlo_path, arch, or gemm) — extra sources "
                "would be silently ignored")
        if self.mode not in ("forward", "train", "prefill", "decode"):
            raise ValueError(
                f"workload {self.name!r}: mode must be 'forward', "
                f"'train', 'prefill', or 'decode', got {self.mode!r}")
        if self.mode in ("prefill", "decode") and self.arch is None:
            raise ValueError(
                f"workload {self.name!r}: mode {self.mode!r} needs an "
                "arch (the serving step is synthesized from the model "
                "config's layer shapes)")
        if self.gemm is not None:
            missing = [k for k in ("m", "n", "k") if k not in self.gemm]
            if missing:
                raise ValueError(
                    f"workload {self.name!r}: gemm spec missing {missing}")
        if self.mesh is not None and len(self.mesh) not in (2, 3):
            raise ValueError(
                f"workload {self.name!r}: mesh must have 2 (data, model) "
                f"or 3 (pod, data, model) entries, got {self.mesh}")
        if self.optimizer not in ("adamw", "adafactor"):
            raise ValueError(
                f"workload {self.name!r}: unknown optimizer "
                f"{self.optimizer!r}")


@dataclass(frozen=True)
class EstimatorSpec:
    """One estimator axis entry.

    kinds: ``roofline`` (options: mode, include_overheads), ``systolic``
    (options: preset), ``mixed`` (systolic primary + roofline fallback;
    options: preset), ``profiling`` (each region run on the calibrated
    host, the card, and roofline-projected onto the grid system unless
    that is ``host``; options: runs).
    """
    kind: str = "roofline"
    options: tuple = ()              # sorted (key, value) pairs — hashable
    fidelity: str | None = None      # override workload fidelity

    @classmethod
    def from_dict(cls, d: dict) -> "EstimatorSpec":
        """Build from the JSON dict form (options dict becomes sorted
        key/value pairs so the spec stays hashable and picklable)."""
        d = dict(d)
        opts = d.pop("options", {}) or {}
        return cls(options=tuple(sorted(opts.items())), **d)

    @property
    def options_dict(self) -> dict:
        """The options pairs as a plain dict."""
        return dict(self.options)

    #: option names the builtin estimator kinds consume — the only ones
    #: :attr:`label` spells out readably
    _LABEL_OPTIONS = ("mode", "include_overheads", "preset", "runs")

    @property
    def label(self) -> str:
        """Unique within any well-formed estimator axis: every field that
        distinguishes two entries appears (summaries and consumer index
        dicts key rows on this).

        Builtin option names render readably; any OTHER options — a
        plugin kind's knobs, a ``table`` estimator's profile path —
        contribute a stable 8-hex digest, so two custom-kind entries
        differing only in such options cannot alias to one label (which
        would silently merge their rows in every label-keyed consumer).
        """
        opts = self.options_dict
        bits = [self.kind]
        if opts.get("mode"):
            bits.append(str(opts["mode"]))
        if opts.get("include_overheads"):
            bits.append("ovh")
        if opts.get("preset"):
            bits.append(str(opts["preset"]))
        if opts.get("runs"):
            bits.append(f"runs{opts['runs']}")
        extra = tuple((k, v) for k, v in self.options
                      if k not in self._LABEL_OPTIONS)
        if extra:
            import hashlib
            bits.append(hashlib.sha1(
                repr(extra).encode()).hexdigest()[:8])
        label = "-".join(bits)
        if self.fidelity:
            label += f"@{self.fidelity}"
        return label


@dataclass(frozen=True)
class TopologySpec:
    """One topology axis entry.

    ``auto`` derives the topology family from the grid system's
    interconnect record (all-to-all node for GPUs, torus for TPUs), which
    is what keeps a single grid meaningful across architectures.
    Explicit kinds: ``a2a``, ``dragonfly``, ``torus``, ``multipod``.
    """
    kind: str = "auto"
    params: tuple = ()               # sorted (key, value) pairs

    @classmethod
    def from_dict(cls, d: dict) -> "TopologySpec":
        """Build from the JSON dict form (list params, e.g. torus dims,
        become tuples; params become sorted pairs)."""
        d = dict(d)
        params = d.pop("params", {}) or {}
        for k, v in list(params.items()):
            if isinstance(v, list):
                params[k] = tuple(v)
        return cls(params=tuple(sorted(params.items())), **d)

    @property
    def params_dict(self) -> dict:
        """The params pairs as a plain dict."""
        return dict(self.params)

    @property
    def label(self) -> str:
        """Short id used in result rows (kind + device count if given)."""
        n = self.params_dict.get("num_devices")
        return f"{self.kind}{n}" if n else self.kind


@dataclass(frozen=True)
class JobSpec:
    """One fully expanded grid point — primitives only, picklable."""
    job_id: int
    workload: str
    fidelity: str
    system: str
    estimator: EstimatorSpec
    slicer: str
    topology: TopologySpec
    overlap: bool = False
    straggler_factor: float = 1.0
    compression: float = 1.0

    def to_row(self) -> dict:
        """The job's axes as a flat result-row prefix."""
        return {
            "job_id": self.job_id,
            "workload": self.workload,
            "fidelity": self.fidelity,
            "system": self.system,
            "estimator": self.estimator.label,
            "slicer": self.slicer,
            "topology": self.topology.label,
            "overlap": self.overlap,
            "straggler_factor": self.straggler_factor,
            "compression": self.compression,
        }

    def cache_group(self, regions_key) -> tuple:
        """The identity under which jobs share an exact (H, C, R) cache
        keyset: same regions R, same system (H), same estimator spec
        (C + config).  ``regions_key`` is any hashable identity for R —
        the runner passes the plan's fingerprint set, so two slicings
        with identical regions land in one group.  Jobs in one cache
        group differ only in topology/overlap/straggler/compression —
        axes the compute cache never sees — so a group's first job
        evaluates every key and its siblings are pure hits."""
        return (regions_key, self.system, self.estimator)


@dataclass
class CampaignSpec:
    """The declarative grid.  Every axis is a list; grid = cross product
    of the axes, except that axes named together in a ``zip_axes`` group
    (JSON key ``"zip"``) are paired element-wise — entry *i* of each
    zipped axis only ever appears with entry *i* of its partners.

    Zipped axes must have equal lengths.  Per-element knobs that vary
    *with* a zipped axis live on the element specs themselves (e.g. each
    :class:`WorkloadSpec` carries its own ``mesh``/``batch``), so a
    (workload, fabric) pairing like the paper's Fig 9 scale-out is one
    spec: zip ``workloads`` with ``topologies`` and give each workload
    its own mesh and batch.
    """
    name: str = "campaign"
    workloads: list[WorkloadSpec] = field(default_factory=list)
    systems: list[str] = field(default_factory=lambda: ["a100"])
    estimators: list[EstimatorSpec] = field(
        default_factory=lambda: [EstimatorSpec()])
    slicers: list[str] = field(default_factory=lambda: ["linear"])
    topologies: list[TopologySpec] = field(
        default_factory=lambda: [TopologySpec()])
    overlap: list[bool] = field(default_factory=lambda: [False])
    straggler_factor: list[float] = field(default_factory=lambda: [1.0])
    compression: list[float] = field(default_factory=lambda: [1.0])
    zip_axes: list[tuple] = field(default_factory=list)  # JSON key: "zip"
    #: extra system-catalog files/dirs (JSON records, see docs/extending.md)
    #: whose ids the ``systems`` axis may then use; relative paths resolve
    #: against the spec file when loaded via :meth:`from_json`
    system_catalog: list[str] = field(default_factory=list)

    #: the spec file's directory when loaded via :meth:`from_json` (a
    #: plain class attribute — unannotated, so *not* a dataclass field or
    #: spec key) — backends resolve their own relative paths (e.g. a
    #: ``table`` estimator's profile JSON) against it via
    #: ``BuildContext.base_dir``
    base_dir = None

    @classmethod
    def from_dict(cls, d: dict, *, session=None,
                  provided: set[str] | frozenset = frozenset()
                  ) -> "CampaignSpec":
        """Build and validate from the JSON dict form; unknown keys are
        rejected so spec typos fail fast.  ``session`` scopes validation
        to a session's scoped registries; ``provided`` names
        workloads supplied in-memory (no spec source required)."""
        d = dict(d)
        zip_groups = d.pop("zip", [])
        known = {f for f in cls.__dataclass_fields__} - {"zip_axes"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown campaign spec keys: {sorted(unknown)}")
        spec = cls(
            name=d.get("name", "campaign"),
            workloads=[WorkloadSpec.from_dict(w)
                       for w in d.get("workloads", [])],
            systems=list(d.get("systems", ["a100"])),
            estimators=[EstimatorSpec.from_dict(e)
                        for e in d.get("estimators", [{}])],
            slicers=list(d.get("slicers", ["linear"])),
            topologies=[TopologySpec.from_dict(t)
                        for t in d.get("topologies", [{}])],
            overlap=[bool(o) for o in d.get("overlap", [False])],
            straggler_factor=[float(s)
                              for s in d.get("straggler_factor", [1.0])],
            compression=[float(c) for c in d.get("compression", [1.0])],
            zip_axes=[tuple(g) for g in zip_groups],
            system_catalog=[str(p) for p in d.get("system_catalog", [])],
        )
        spec.validate(provided, session=session)
        return spec

    @classmethod
    def from_file_dict(cls, d: dict, path: str, *, session=None,
                       provided: set[str] | frozenset = frozenset()
                       ) -> "CampaignSpec":
        """:meth:`from_dict` for a dict that came from a spec *file*:
        relative ``system_catalog`` paths resolve against the file and
        the spec remembers its ``base_dir`` (callers that already parsed
        the JSON — e.g. suite loading — use this to avoid re-reading)."""
        d = dict(d)
        base = os.path.dirname(os.path.abspath(path))
        if d.get("system_catalog"):
            d["system_catalog"] = [
                p if os.path.isabs(p) else os.path.join(base, p)
                for p in d["system_catalog"]]
        spec = cls.from_dict(d, session=session, provided=provided)
        spec.base_dir = base
        return spec

    @classmethod
    def from_json(cls, path: str, *, session=None,
                  provided: set[str] | frozenset = frozenset()
                  ) -> "CampaignSpec":
        """Load and validate a spec file (see ``docs/campaign.md``);
        relative ``system_catalog`` paths resolve against the file."""
        with open(path) as f:
            d = json.load(f)
        return cls.from_file_dict(d, path, session=session,
                                  provided=provided)

    def to_dict(self) -> dict:
        """JSON-ready dict form; round-trips through :meth:`from_dict`."""
        d = asdict(self)
        for e in d["estimators"]:
            e["options"] = dict(e["options"])
        for t in d["topologies"]:
            t["params"] = dict(t["params"])
        zip_groups = d.pop("zip_axes")
        if zip_groups:
            d["zip"] = [list(g) for g in zip_groups]
        if not d.get("system_catalog"):
            d.pop("system_catalog", None)
        return d

    def system_registry(self,
                        base: SystemRegistry | None = None
                        ) -> SystemRegistry:
        """The catalog this spec's ``systems`` axis resolves against:
        ``base`` (a session's registry, default the shipped catalog)
        overlaid with the spec's own ``system_catalog`` files.

        The catalog files are read from disk once per spec instance (the
        campaign path calls this at load-validate, run-validate, and job
        build); only the cheap scope assembly repeats."""
        base = base if base is not None else default_registry()
        if not self.system_catalog:
            return base
        records = getattr(self, "_catalog_records", None)
        if records is None:
            probe = SystemRegistry(self.system_catalog)
            records = [(sid, probe.get(sid), probe.source(sid))
                       for sid in probe.names()]
            self._catalog_records = records
        scope = base.scope()
        for sid, system, source in records:
            scope.register(sid, system, source=source, replace=True)
        return scope

    def validate(self, provided: set[str] | frozenset = frozenset(), *,
                 session=None) -> None:
        """Reject grids that could not run: empty axes, sourceless
        workloads, and axis values outside the live vocabularies
        (registered estimator/topology kinds, slicer names, catalog
        system ids) — so validation catches typos that would otherwise
        only surface as all-error rows at run time.  Unknown kinds report
        the registry's did-you-mean; a kind the port has not ported yet
        raises ``NotImplementedError`` naming the slice that brings it.

        ``provided``: workload names supplied in-memory to the runner —
        those need no on-disk/arch source in the spec.  ``session``: an
        object whose scoped registries (plugin kinds, user catalogs) this
        spec should validate against."""
        estimators = getattr(session, "estimators", None) or ESTIMATORS
        topologies = getattr(session, "topologies", None) or TOPOLOGIES
        systems = self.system_registry(getattr(session, "systems", None))
        if not self.workloads:
            raise ValueError("campaign spec: at least one workload required")
        for w in self.workloads:
            if w.name not in provided:
                w.validate()
        for axis in ("systems", "estimators", "slicers", "topologies",
                     "overlap", "straggler_factor", "compression"):
            if not getattr(self, axis):
                raise ValueError(f"campaign spec: axis {axis!r} is empty")
        self._validate_zip()
        for e in self.estimators:
            if e.kind not in estimators:
                raise ValueError(
                    f"campaign spec: {estimators.unknown_message(e.kind)}")
            pending = estimators.pending_message(e.kind)
            if pending is not None:
                raise NotImplementedError(f"campaign spec: {pending}")
        for t in self.topologies:
            if t.kind not in topologies:
                raise ValueError(
                    f"campaign spec: {topologies.unknown_message(t.kind)}")
        for s in self.slicers:
            if s not in SLICER_NAMES:
                raise ValueError(
                    f"campaign spec: unknown slicer {s!r}; "
                    f"have {SLICER_NAMES}")
        for name in self.systems:
            if name not in systems:
                raise ValueError(
                    f"campaign spec: {systems.unknown_message(name)}")

    def _validate_zip(self) -> None:
        """Reject malformed zip groups: unknown axis names, axes claimed
        by more than one group (or twice in one), groups of fewer than
        two axes, and — the silent-mispairing hazard — member axes of
        unequal lengths."""
        seen: dict[str, int] = {}
        for gi, group in enumerate(self.zip_axes):
            if len(group) < 2:
                raise ValueError(
                    f"campaign spec: zip group {list(group)} needs at "
                    "least two axes to pair")
            for axis in group:
                if axis not in AXIS_FIELDS:
                    raise ValueError(
                        f"campaign spec: zip group {list(group)} names "
                        f"unknown axis {axis!r}; axes are {AXIS_FIELDS}")
                if axis in seen:
                    where = ("twice in one group" if seen[axis] == gi
                             else "in more than one zip group")
                    raise ValueError(
                        f"campaign spec: axis {axis!r} appears {where} — "
                        "each axis can be zipped at most once")
                seen[axis] = gi
            lengths = {axis: len(getattr(self, axis)) for axis in group}
            if len(set(lengths.values())) > 1:
                detail = ", ".join(f"{a}={n}" for a, n in lengths.items())
                raise ValueError(
                    f"campaign spec: zip group {list(group)} pairs axes "
                    f"of unequal lengths ({detail}) — zipped axes are "
                    "matched element-wise and must have the same length")

    def _axis_blocks(self) -> list[list[dict]]:
        """The grid's independent blocks, in canonical axis order.

        Each block is a list of ``{axis_field: element}`` dicts: an
        unzipped axis contributes one single-key dict per element; a zip
        group contributes one multi-key dict per paired index.  The grid
        is the cross product of the blocks, so with no zip groups the
        enumeration order is exactly the legacy full cross product.  A
        group is anchored at the canonical position of its earliest
        member axis."""
        group_of = {axis: tuple(g) for g in self.zip_axes for axis in g}
        blocks: list[list[dict]] = []
        consumed: set[str] = set()
        for name in AXIS_FIELDS:
            if name in consumed:
                continue
            group = group_of.get(name)
            if group is None:
                blocks.append([{name: v} for v in getattr(self, name)])
            else:
                consumed.update(group)
                n = len(getattr(self, name))
                blocks.append([{axis: getattr(self, axis)[i]
                                for axis in group} for i in range(n)])
        return blocks

    @property
    def num_points(self) -> int:
        """Grid size: the product of the block lengths (a zip group of
        axes counts once, not once per member)."""
        n = 1
        for block in self._axis_blocks():
            n *= len(block)
        return n

    def expand(self) -> list[JobSpec]:
        """The grid, in deterministic canonical axis order: cross product
        of all axes, with zipped axes advancing together."""
        jobs: list[JobSpec] = []
        for i, combo in enumerate(itertools.product(*self._axis_blocks())):
            d: dict = {}
            for part in combo:
                d.update(part)
            w, est = d["workloads"], d["estimators"]
            fidelity = est.fidelity or w.fidelity or "optimized"
            jobs.append(JobSpec(
                job_id=i, workload=w.name, fidelity=fidelity,
                system=d["systems"], estimator=est, slicer=d["slicers"],
                topology=d["topologies"], overlap=d["overlap"],
                straggler_factor=d["straggler_factor"],
                compression=d["compression"]))
        return jobs
