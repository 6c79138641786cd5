"""Named scenarios and named sweeps: the port's copy of
``repro.scenario.registry``.

``scenarios.get("paper_table3")`` returns a fresh, validated
:class:`ScenarioSpec`; ``scenarios.get_sweep("codec_x_protocol")`` a
:class:`~repro_torch.scenario.sweep.SweepSpec`. The entries are declared as
the reference declares them (payload codes and architecture names, the same
descriptions), so their ``to_dict`` equals the reference's. The port
registers the scenarios its runner, trainer and executors drive (the
paper's cell and its flooding baseline, the codec, churn, link-failure and
underlay workloads, segmented gossip, the 1000-node scale cell, the
sparse 100k and 1M cells, the asynchronous stragglers, the mesh smoke) and
all six of the reference's sweeps, in the reference's order.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Mapping

from ..core.graph import TopologySpec
from ..opt import OptimizerSpec
from .spec import ChurnEvent, ScenarioSpec
from .sweep import SweepSpec

_REGISTRY: Dict[str, Callable[[], ScenarioSpec]] = {}
_SWEEPS: Dict[str, Callable[[], SweepSpec]] = {}


def register(name: str) -> Callable:
    """Decorator: register a zero-arg ScenarioSpec factory under ``name``."""

    def deco(fn: Callable[[], ScenarioSpec]) -> Callable[[], ScenarioSpec]:
        _REGISTRY[name] = fn
        return fn

    return deco


def get(name: str) -> ScenarioSpec:
    """A fresh spec for a registered scenario."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; known: {names()}") from None
    return factory().validate()


def names() -> List[str]:
    return sorted(_REGISTRY)


def register_sweep(name: str) -> Callable:
    """Decorator: register a zero-arg SweepSpec factory under ``name``."""

    def deco(fn: Callable[[], SweepSpec]) -> Callable[[], SweepSpec]:
        _SWEEPS[name] = fn
        return fn

    return deco


def get_sweep(name: str) -> SweepSpec:
    """A fresh spec for a registered sweep."""
    try:
        factory = _SWEEPS[name]
    except KeyError:
        raise ValueError(f"unknown sweep {name!r}; known: {sweep_names()}") from None
    return factory().validate()


def sweep_names() -> List[str]:
    return sorted(_SWEEPS)


class _Scenarios(Mapping):
    """The registered scenarios as a read-only mapping (name -> a fresh spec)."""

    def __getitem__(self, name: str) -> ScenarioSpec:
        if name not in _REGISTRY:
            raise KeyError(name)
        return get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(names())

    def __len__(self) -> int:
        return len(_REGISTRY)


SCENARIOS: Mapping[str, ScenarioSpec] = _Scenarios()


# ---------------------------------------------------------------------------
# The scenarios the port drives
# ---------------------------------------------------------------------------


@register("paper_table3")
def _paper_table3() -> ScenarioSpec:
    return ScenarioSpec(
        name="paper_table3",
        overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
        protocol="mosgu",
        payload="b0",  # EfficientNet-B0, 21.2 MB (Table II)
        rounds=1,
        description=(
            "The paper's Tables III-V measurement cell: MOSGU full "
            "dissemination of EfficientNet-B0 over ER(10) on the 3-subnet "
            "testbed derived from the overlay's cost model."))


@register("paper_flooding_baseline")
def _paper_flooding() -> ScenarioSpec:
    return ScenarioSpec(
        name="paper_flooding_baseline",
        overlay=TopologySpec(kind="complete", n=10, seed=3),
        protocol="flooding",
        payload="b0",
        rounds=1,
        description=(
            "The paper's broadcast baseline: uncoordinated flooding on the "
            "complete overlay — maximal link contention, the column MOSGU "
            "is compared against."))


@register("quantized_table3")
def _quantized_table3() -> ScenarioSpec:
    return ScenarioSpec(
        name="quantized_table3",
        overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
        protocol="mosgu",
        payload="b0",
        codec="int8",
        rounds=1,
        description=(
            "paper_table3 under int8 wire quantization (per-chunk absmax "
            "scales): ~4x fewer bytes per transfer, so the Tables III-V "
            "metrics re-derive under compression — same schedule, same "
            "transmissions, a fraction of the round time."))


@register("topk_sweep")
def _topk_sweep() -> ScenarioSpec:
    return ScenarioSpec(
        name="topk_sweep",
        overlay=TopologySpec(kind="watts_strogatz", n=10, seed=4),
        protocol="dissemination",
        payload="v2",  # MobileNetV2, 14 MB
        codec="topk",
        rounds=3,
        description=(
            "Top-k sparsified gossip (~10x compression at the default 5% "
            "density): the queue engine carries per-node error-feedback "
            "residuals across all three rounds, so coordinates dropped in "
            "one round are compensated in the next (DGC/EF-SGD)."))


@register("churn_storm")
def _churn_storm() -> ScenarioSpec:
    return ScenarioSpec(
        name="churn_storm",
        overlay=TopologySpec(kind="watts_strogatz", n=12, seed=2),
        protocol="dissemination",
        payload="v2",  # MobileNetV2, 14 MB
        rounds=6,
        churn=(
            ChurnEvent(1, "leave", 3),
            # node 2 is the moderator by round 2 (round-robin 0 -> 1 -> 2):
            # its departure forces an emergency re-election
            ChurnEvent(2, "leave", 2),
            ChurnEvent(3, "leave", 7),
            ChurnEvent(4, "rejoin", 3),
            ChurnEvent(5, "rejoin", 2),
        ),
        description=(
            "Nodes leave and rejoin mid-training — including the moderator "
            "at round 2 (emergency re-election) — and the schedule is "
            "recomputed on every churn round."))


@register("lossy_links")
def _lossy_links() -> ScenarioSpec:
    return ScenarioSpec(
        name="lossy_links",
        overlay=TopologySpec(kind="erdos_renyi", n=10, seed=5),
        protocol="dissemination",
        payload="v3s",
        rounds=2,
        drop_rate=0.1,
        drop_seed=7,
        executors=("engine", "event"),
        description=(
            "10% transient link failures: the queue engine keeps dropped "
            "entries at the FIFO head and retransmits (paper III-D), and "
            "the event engine retransmits at the failed delivery's virtual "
            "timestamp; dissemination still completes every round."))


@register("hetero_edge")
def _hetero_edge() -> ScenarioSpec:
    return ScenarioSpec(
        name="hetero_edge",
        overlay=TopologySpec(kind="watts_strogatz", n=12, seed=6, n_subnets=4),
        protocol="dissemination",
        payload="v2",
        underlay="edge",
        rounds=2,
        description=(
            "Heterogeneous edge deployment: per-device access rates drawn "
            "3-16 MB/s from the underlay seed, four sites homed on one hub "
            "router (star fabric) — the slowest device's access link, not "
            "the trunk, bounds the round."))


@register("campus_wan")
def _campus_wan() -> ScenarioSpec:
    return ScenarioSpec(
        name="campus_wan",
        overlay=TopologySpec(kind="erdos_renyi", n=12, seed=3, n_subnets=4),
        protocol="mosgu",
        payload="b0",
        underlay="wan",
        rounds=1,
        description=(
            "Four campuses chained over 8 MB/s long-haul trunks (line "
            "fabric): cross-campus transfers traverse up to three trunks "
            "at 1.2 s/hop, so the MST schedule's preference for cheap "
            "intra-site edges matters far more than on the paper's LAN."))


@register("segmented_sweep")
def _segmented_sweep() -> ScenarioSpec:
    return ScenarioSpec(
        name="segmented_sweep",
        overlay=TopologySpec(kind="complete", n=10, seed=0),
        protocol="segmented",
        n_segments=4,
        payload="v3l",
        rounds=2,
        description=(
            "Segmented gossip (Hu et al.): 4 per-model segments pipelined "
            "through the colored MST — 4x the transfers at 1/4 the bytes "
            "each, same total traffic, higher link utilization."))


@register("scale_1000")
def _scale_1000() -> ScenarioSpec:
    return ScenarioSpec(
        name="scale_1000",
        overlay=TopologySpec(kind="watts_strogatz", n=1000, seed=1),
        protocol="dissemination",
        payload=21.2,
        rounds=1,
        executors=("plan", "engine"),  # the fluid sim is impractical at N=1000
        description=(
            "Sweep scale: the same one-policy definition at N=1000 on the "
            "vectorized counting path and the runtime queue engine."))


@register("scale_100k")
def _scale_100k() -> ScenarioSpec:
    return ScenarioSpec(
        name="scale_100k",
        overlay=TopologySpec(kind="knn", n=100_000, seed=1, k=8,
                             n_subnets=100),
        protocol="mosgu_exchange",
        mst_algorithm="boruvka",
        coloring_algorithm="jones_plassmann",
        payload=21.2,
        rounds=2,
        churn=(ChurnEvent(1, "leave", 1234), ChurnEvent(1, "leave", 4242),
               ChurnEvent(1, "leave", 99_000)),
        executors=("plan",),  # counting-only at this scale
        description=(
            "The sparse-planner scale target: a 100k-node approximate k-NN "
            "overlay planned entirely in CSR (vectorized Borůvka MST + "
            "Jones–Plassmann coloring), with round-1 churn exercising the "
            "incremental replanner. No dense matrix is ever materialized."))


@register("scale_1m")
def _scale_1m() -> ScenarioSpec:
    return ScenarioSpec(
        name="scale_1m",
        overlay=TopologySpec(kind="ring", n=1_000_000, seed=1, k=4),
        protocol="mosgu_exchange",
        mst_algorithm="boruvka",
        coloring_algorithm="jones_plassmann",
        payload=21.2,
        rounds=1,
        executors=("plan",),
        description=(
            "Counting-only smoke at the ROADMAP's million-node target: one "
            "MOSGU exchange round planned on a ring-lattice CSR overlay — "
            "exists to keep the sparse path honest about O(edges) scaling."))


@register("mesh_smoke")
def _mesh_smoke() -> ScenarioSpec:
    return ScenarioSpec(
        name="mesh_smoke",
        overlay=TopologySpec(kind="complete", n=4, seed=0),
        protocol="tree_allreduce",
        payload="smollm-360m",  # arch payload: param_count x 2 bytes on wire
        rounds=2,
        churn=(ChurnEvent(1, "leave", 3),),
        executors=("plan", "jax"),
        description=(
            "The JAX collectives executor on a 4-device mesh: churn-masked "
            "tree all-reduce produces the exact FedAvg mean of the healthy "
            "members while the masked node keeps its local params."))


# ---------------------------------------------------------------------------
# Named sweeps (the reference's six)
# ---------------------------------------------------------------------------


@register_sweep("table3_full")
def _table3_full() -> SweepSpec:
    return SweepSpec(
        name="table3_full",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
            payload="b0", rounds=1),
        grid={
            "topology": ("complete", "erdos_renyi", "watts_strogatz",
                         "barabasi_albert"),
            "payload": ("v3s", "v2", "b0", "v3l"),
            "protocol": ("broadcast_exchange", "mosgu_exchange"),
        },
        description=(
            "The paper's Tables III-V grid in one call: topology family x "
            "payload size x {broadcast, MOSGU} per-round exchange — 32 "
            "cells, one MST/coloring per topology thanks to the shared plan "
            "cache. Run on netsim for the timing columns, plan for counts."))


@register_sweep("payload_latency_curve")
def _payload_latency_curve() -> SweepSpec:
    return SweepSpec(
        name="payload_latency_curve",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
            protocol="mosgu", rounds=1),
        grid={"payload": ("v3s", "v2", "b0", "v3l", "b1", "b2", "b3")},
        description=(
            "The paper's transfer-time-vs-model-size figure: full MOSGU "
            "dissemination of every Table II payload over the same overlay "
            "— the schedule is computed once and reused for all 7 cells."))


@register_sweep("codec_x_protocol")
def _codec_x_protocol() -> SweepSpec:
    return SweepSpec(
        name="codec_x_protocol",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
            payload="b0", rounds=1),
        grid={
            "codec": ("fp32", "bf16", "int8", "int4", "topk"),
            "protocol": ("dissemination", "segmented"),
        },
        description=(
            "Beyond-paper: wire codec x gossip protocol on the paper cell — "
            "how compression interacts with segmentation (per-chunk scale "
            "overhead is paid per segment). Byte accounting is exact on "
            "every executor."))


@register_sweep("wan_sweep")
def _wan_sweep() -> SweepSpec:
    return SweepSpec(
        name="wan_sweep",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
            protocol="mosgu", rounds=1),
        grid={
            "underlay": ("paper_lan", "wan", "edge", "congested"),
            "payload": ("v3s", "b0", "b3"),
        },
        description=(
            "The paper's transfer-time question asked across underlays: "
            "full MOSGU dissemination per network preset x payload size "
            "(12 cells, one plan). On the plan executor the whole grid is "
            "one analytic timing profile per underlay; netsim "
            "cross-validates the fluid round times."))


@register("async_stragglers")
def _async_stragglers() -> ScenarioSpec:
    return ScenarioSpec(
        name="async_stragglers",
        overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3),
        protocol="mosgu",
        payload="b0",
        rounds=6,
        max_staleness=1,
        compute_time_s=5.0,
        compute_jitter_s=4.0,
        executors=("event",),
        description=(
            "Asynchronous rounds under straggler injection: per-node "
            "compute 5-9 s (seeded uniform jitter), a one-round staleness "
            "window, so fast nodes start round r+1 segment sends while "
            "stragglers finish round r. Steady-state rounds/sec is the "
            "metric; estimate_throughput must land within ±15%."))


@register_sweep("async_vs_sync")
def _async_vs_sync() -> SweepSpec:
    return SweepSpec(
        name="async_vs_sync",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=10, seed=3,
                                 n_subnets=3),
            payload="b0", rounds=8,
            compute_time_s=5.0, compute_jitter_s=4.0,
            executors=("event",)),
        grid={
            "max_staleness": (0, 1, 2),
            "protocol": ("mosgu", "segmented", "flooding"),
            "underlay": ("paper_lan", "wan", "edge"),
        },
        description=(
            "Async vs sync on the event engine: staleness window x gossip "
            "protocol x underlay preset (27 cells) under straggler "
            "injection. staleness=0 is today's barrier; 1-2 let fast nodes "
            "run ahead. Measures steady-state rounds/sec and pipeline-fill "
            "latency; estimate_throughput must track the engine within "
            "±15% on every cell (BENCH_async.json + CI enforce it)."))


@register_sweep("optimized_vs_mst")
def _optimized_vs_mst() -> SweepSpec:
    return SweepSpec(
        name="optimized_vs_mst",
        base=ScenarioSpec(
            overlay=TopologySpec(kind="erdos_renyi", n=12, seed=3, p=0.55,
                                 n_subnets=4),
            protocol="mosgu", payload="b0", rounds=1),
        grid={
            "underlay": ("wan", "edge"),
            "optimizer": (
                None,
                OptimizerSpec(objective="round_time", strategy="anneal",
                              steps=400, init_temp=30.0, cooling=0.985,
                              seed=0),
            ),
        },
        description=(
            "Analytic-guided overlays vs the paper's MST on heterogeneous "
            "underlays: the same ER(12) universe per preset, planned as a "
            "plain ms-cost MST (optimizer=None) and as the repro.opt "
            "annealed working subgraph scored by closed-form round time. "
            "Overlay ping costs never see trunk hop counts or access "
            "rates, so the two diverge: the optimized overlay must be >= "
            "1.15x faster on the oracle AND confirmed faster by the fluid "
            "simulator (benchmarks/opt_bench.py gates both in CI)."))
