"""Numpy control plane of the port: graphs (dense and CSR), MSTs and
colorings, the sparse planner and its incremental replanning, the plan IR
and its slot plans, the moderator, the queue engine and the MOSGU facade,
the network timing model, the fluid simulator and the event engine (copies
of ``repro.core``).
"""
from .events import AsyncEventEngine, RoundTiming, plan_slots, policy_slots  # noqa: F401
from .graph import (  # noqa: F401
    Graph,
    TopologySpec,
    build_mst,
    color_graph,
    is_proper_coloring,
    make_topology,
    mst_boruvka,
    mst_kruskal,
    mst_prim,
    slot_length_for_colors,
    slot_length_s,
    subnet_of,
)
from .gossip import GossipEngine, GossipNode, QueueEntry, SlotReport, fedavg  # noqa: F401
from .moderator import ConnectivityReport, Moderator, SchedulePacket  # noqa: F401
from .network import (  # noqa: F401
    NETWORK_PRESETS,
    CompiledNetwork,
    NetworkSpec,
    ThroughputEstimate,
    TimingEstimate,
    TimingProfile,
    as_network_model,
    estimate_throughput,
    estimate_timing,
    get_preset,
    register_preset,
    router_graph_edges,
    slot_length_for_network,
)
from .plan import (  # noqa: F401
    BroadcastOncePolicy,
    CommPolicy,
    Deliveries,
    DisseminationPolicy,
    FloodingPolicy,
    MstExchangePolicy,
    ReplayPolicy,
    SegmentedGossipPolicy,
    SlotSends,
    TreeAllreducePolicy,
    compile_policy,
    make_policy,
    measure_policy,
)
from .protocol import MOSGUConfig, MOSGUProtocol  # noqa: F401
from .replan import MemberPlan, SparsePlanner, plan_equal  # noqa: F401
from .schedule import (  # noqa: F401
    PermStep,
    Slot,
    SlotPlan,
    compile_dissemination,
    compile_flooding,
    compile_segmented,
    compile_tree_allreduce,
    decompose_matchings,
    link_contention_profile,
    plan_to_perm_steps,
)
from .sparse import CSRGraph  # noqa: F401
