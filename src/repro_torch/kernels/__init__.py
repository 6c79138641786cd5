"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout mirrors ``repro.kernels``: per group, ``ref.py`` holds the plain
versions, one module per kernel binds its CUDA source (``csrc/*.cu``), and
``ops.py`` dispatches — a CPU tensor to the plain version, a CUDA tensor to
the kernel (or a raise; there is no fallback).

``LAUNCHES`` counts kernel launches, one per call of the C entry point, so a
run can show that its path went through the kernels; ``SHAPES`` counts the
same launches by shape (the wrapper's key: ``(rows, size, bits)`` for
quantize, ``(rows, (size, ...), bits)`` for dequantize, which decodes a
group of leaves a launch, ``(rows, size, block, k)`` for top-k, the tensor
shape elsewhere), so a kernel's time can be weighted by the shapes the path
gives it.

Every kernel also has a cost function beside its wrapper, the FLOPs and
bytes of one launch (:class:`Cost`; each input read once, each output
written once), the one source of a kernel's cost: ``chip_smoke.py``'s
bounds and the op counter (``launch/op_analysis.py``) read it. The ops
bracket each call in :class:`kernel_call`, so a counter sees the kernel
once, by its cost, whichever route computes it: the kernel, the plain
version or the fake route. A ``FakeTensor`` (the dry run,
``launch/dryrun.py``) takes the fake route, whatever device it claims: the
wrapper allocates the kernel's outputs and workspaces and launches nothing.

A DTensor never reaches a wrapper (the wrappers launch on ``data_ptr()``):
the ops take a DTensor through ``local_map`` (:func:`run_local`), so each
rank runs the same kernel on its plain local shards, and the launch counts,
the fake route and a counter's costs all see local shapes. :func:`on_card`
raises by name for a DTensor on any device.
"""
from collections import Counter
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

KERNEL_NAMES = (
    "quantize", "dequantize", "topk_select", "gossip_mix", "flash_attention", "selective_scan",
    "flash_attention_bwd", "selective_scan_bwd")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
SHAPES: Dict[str, Counter] = {name: Counter() for name in KERNEL_NAMES}


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    """One launch of kernel ``name`` at ``shape``; the wrappers call it where
    they launch, and nowhere else."""
    LAUNCHES[name] += 1
    SHAPES[name][tuple(shape)] += 1


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def launch_shapes() -> Dict[str, Dict[Tuple[int, ...], int]]:
    return {name: dict(SHAPES[name]) for name in KERNEL_NAMES}


class Cost(NamedTuple):
    """One launch's operations and the bytes it must move."""

    flops: float
    bytes: float


class kernel_call:
    """Brackets one call of kernel ``name`` on any route. With a counter
    active (a dispatch mode with ``enter_kernel(name, cost)`` and
    ``exit_kernel()``: ``launch.op_analysis.OpCounter``), ``cost_fn(*args)``
    gives its :class:`Cost` (None: the wrapper launches nothing at these
    shapes), and the counter takes the call as one launch at that cost, not
    the aten ops inside it. Without one it costs a look at an empty mode
    stack."""

    __slots__ = ("name", "cost_fn", "args", "live")

    def __init__(self, name: str, cost_fn: Callable[..., Optional[Cost]], *args: Any) -> None:
        self.name, self.cost_fn, self.args = name, cost_fn, args

    def __enter__(self) -> None:
        self.live = [m for m in _get_current_dispatch_mode_stack()
                     if hasattr(m, "enter_kernel")]
        if self.live:
            cost = self.cost_fn(*self.args)
            for c in self.live:
                c.enter_kernel(self.name, cost)

    def __exit__(self, *exc: Any) -> None:
        for c in self.live:
            c.exit_kernel()


class whole_op:
    """Brackets one elementwise aten op that a trace may see decomposed:
    with a counter active (a dispatch mode with ``enter_op(name, bytes)``),
    the op counts once, moving ``tensors`` tensors of ``x``'s size (its
    operands read and its output written; a rank's local bytes for a
    DTensor), and not the ops it dispatches. On fake CUDA tensors the card's
    PyTorch hands ``softplus`` to a counter as ``gt``, ``exp``, ``log1p``
    and ``where``, where its real tensors run one kernel."""

    __slots__ = ("name", "n_bytes", "live")

    def __init__(self, name: str, x: torch.Tensor, tensors: int = 2) -> None:
        local = x.to_local() if isinstance(x, DTensor) else x
        self.name, self.n_bytes = name, tensors * local.numel() * local.element_size()

    def __enter__(self) -> None:
        self.live = [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "enter_op")]
        for c in self.live:
            c.enter_op(self.name, self.n_bytes)

    def __exit__(self, *exc: Any) -> None:
        for c in self.live:
            c.exit_kernel()


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor, name: str) -> bool:
    """Whether ``t`` goes to the kernel's wrapper: a CUDA tensor (the
    kernel, or a raise) or a fake one (the fake route); a CPU tensor goes to
    the plain version. A DTensor, or any other device, raises."""
    if isinstance(t, DTensor):
        raise TypeError(f"{name}: a DTensor reached the kernel's op; a meshed call runs "
                        "each rank's local shards through the op's local_map route")
    if t.device.type == "cuda" or is_fake(t):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")


def run_local(fn: Callable[..., Any], mesh: Any, in_placements: Tuple[Any, ...],
              out_placements: Any, *args: Any) -> Any:
    """``fn`` on each rank's local shards of ``args`` (``local_map``): every
    tensor argument is first redistributed to its entry of ``in_placements``
    (None for a non-tensor argument; a plain tensor is taken as replicated),
    and the outputs come back as DTensors with ``out_placements``; the
    gradients go back as :func:`grad_placements` places them."""
    def place(a: Any, p: Any) -> Any:
        if p is None or not isinstance(a, torch.Tensor):
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return a if tuple(a.placements) == tuple(p) else a.redistribute(mesh, p)

    args = tuple(place(a, p) for a, p in zip(args, in_placements))
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements(in_placements),
                     device_mesh=mesh)(*args)


def grad_placements(in_placements: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """The placements of each input's gradient out of a ``local_map``: an
    input replicated over a mesh dimension that another input splits gets
    each rank's share of its gradient there, a partial sum (a norm's
    scale, the router, the scan's A and D on batch-split rows, a kv head
    read by query heads split over "model"); as placed elsewhere."""
    split = {i for p in in_placements if p is not None
             for i, q in enumerate(p) if isinstance(q, Shard)}
    return tuple(None if p is None else tuple(
        Partial() if i in split and isinstance(q, Replicate) else q for i, q in enumerate(p))
        for p in in_placements)
