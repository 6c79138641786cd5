"""Mamba1 (S6) and Mamba2 blocks of the port (``repro.models.mamba``).

The full-sequence Mamba1 block runs its recurrence through the
selective-scan op (the Hopper kernel on the card, its plain version on the
CPU) where the JAX package runs ``chunked_selective_scan``; the scan returns
y in f32 with ``D x`` added, and the block gates it with ``silu(z)`` before
rounding to the model dtype, as the JAX block does. A differentiated call
goes through the op's autograd Function, whose backward is the scan's
backward kernel on the card.

The Mamba2 block (zamba2) has a scalar decay per head of 64 channels and one
group of B and C (d_state wide) shared by every head. The JAX package runs
its recurrence in jnp, outside any Pallas kernel, so the port's is plain
PyTorch too: the chunked matrix ("SSD") form of :func:`ssd_scan`, not a loop
over time steps and not the associative scan's (b, chunk, heads, 64, n)
intermediates. The selective-scan kernel is Mamba1's (a decay per channel
and state, at most 32 states) and does not take it.

On a mesh the JAX package's hints pin the post-conv activations and dt to
``d_inner`` over "model" (Mamba1; Mamba2's x and y by heads), so the scan
op runs each rank's channels (``kernels/scan/ops.py``).

The one-token decode steps stay plain PyTorch, as the JAX package's are.
Projections are separate weights (wx / wz / wB / wC / wdt_in, and wdt for
Mamba2), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import run_local, whole_op

from ..kernels.scan.ops import selective_scan_op
from .layers import Params, dense_init, gather_tokens, reduce_partial, shard_hint


def init_mamba1(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
                dt_rank: int, conv_width: int, dtype: torch.dtype) -> Params:
    dev = gen.device
    return {
        "wx": dense_init(gen, (d_model, d_inner), dtype),
        "wz": dense_init(gen, (d_model, d_inner), dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner), dtype, scale=0.5),
        "wdt_in": dense_init(gen, (d_inner, dt_rank), dtype),
        "wB": dense_init(gen, (d_inner, d_state), dtype),
        "wC": dense_init(gen, (d_inner, d_state), dtype),
        "dt_proj": dense_init(gen, (dt_rank, d_inner), dtype),
        "dt_bias": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
                           ).expand(d_inner, d_state).contiguous(),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype),
    }


class _Softplus(torch.autograd.Function):
    """``F.softplus`` and its backward (``aten.softplus_backward``, as
    autograd takes it), each one op to a counter however the trace
    dispatches it (:class:`~repro_torch.kernels.whole_op`)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        with whole_op("softplus", x):
            return F.softplus(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # in x's layout: a fake trace computes the op by a decomposition
        # whose output strides need not follow a permuted g as the kernel's do
        g = g.contiguous()
        with whole_op("softplus_backward", x, 3):
            return torch.ops.aten.softplus_backward(g, x, 1.0, 20.0)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Softplus.apply(x)
    with whole_op("softplus", x):
        return F.softplus(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq. x (b, s, di); w (width, di); cache
    (b, width-1, di) holds the previous inputs. Returns (out, new cache)."""
    width = w.shape[0]
    if cache is not None:
        pad = cache.to(x.dtype)
    elif isinstance(x, DTensor):  # placed as x (a plain tensor is not whole on a rank)
        pad = torch.zeros_like(x[:, :width - 1])
    else:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)  # (b, s + width - 1, di)
    s = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out, xp[:, xp.shape[1] - (width - 1):, :]


def _mamba1_ssm_inputs(params: Params, xc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dt (b, s, di), B and C (b, s, n), all f32, from the post-conv
    activations xc (b, s, di). On a mesh, ``wdt_in``, ``wB`` and ``wC`` are
    row-parallel over a ``d_inner``-split xc: their partial sums are reduced
    before dt's column-parallel ``dt_proj`` and the scan."""
    dt_low = reduce_partial((xc @ params["wdt_in"]).float())
    dt = _softplus(dt_low @ params["dt_proj"].float() + params["dt_bias"])
    Bm = reduce_partial((xc @ params["wB"]).float())
    Cm = reduce_partial((xc @ params["wC"]).float())
    return dt, Bm, Cm


def mamba1_forward(params: Params, x: torch.Tensor, d_state: int, dt_rank: int) -> torch.Tensor:
    """Full-sequence Mamba1 block. x: (b, s, d_model)."""
    x = gather_tokens(x)
    xi = x @ params["wx"]
    z = x @ params["wz"]
    xc, _ = _causal_conv(xi, params["conv_w"])
    xc = shard_hint(F.silu(xc), "batch", None, "model")
    dt, Bm, Cm = _mamba1_ssm_inputs(params, xc)
    dt = shard_hint(dt, "batch", None, "model")
    y, _ = selective_scan_op(dt, Bm, Cm, xc, params["A_log"], params["D"],
                             out_dtype=torch.float32)
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"]


def init_mamba1_cache(batch: int, d_inner: int, d_state: int, conv_width: int,
                      dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    }


def mamba1_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  d_state: int, dt_rank: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (b, 1, d_model); returns (out, new cache)."""
    xi = x @ params["wx"]
    z = x @ params["wz"]
    xc, new_conv = _causal_conv(xi, params["conv_w"], cache["conv"])
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba1_ssm_inputs(params, xc)
    A = -torch.exp(params["A_log"])  # (di, n)
    dA = torch.exp(dt[:, 0, :, None] * A)  # (b, di, n)
    dBx = (dt[:, 0] * xc[:, 0].float())[:, :, None] * Bm[:, 0, None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
    y = y + params["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}


# -- Mamba2 (zamba2): scalar decay per head, one group of B and C ----------------------

MAMBA2_HEAD_DIM = 64
SSD_CHUNK = 64  # steps a chunk: the (L, L) decay tiles and the chunk states weigh alike


def init_mamba2(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
                conv_width: int, dtype: torch.dtype) -> Params:
    """A_log = 0 (A = -1), dt_bias = 0 and D = 1 a head, as in the JAX package."""
    dev = gen.device
    n_heads = d_inner // MAMBA2_HEAD_DIM
    return {
        "wx": dense_init(gen, (d_model, d_inner), dtype),
        "wz": dense_init(gen, (d_model, d_inner), dtype),
        "wB": dense_init(gen, (d_model, d_state), dtype),
        "wC": dense_init(gen, (d_model, d_state), dtype),
        "wdt": dense_init(gen, (d_model, n_heads), dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner), dtype, scale=0.5),
        "A_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype),
    }


def _mamba2_inputs(params: Params, x: torch.Tensor, conv_cache: Optional[torch.Tensor] = None):
    """(xc (b, s, di) post-conv, z (b, s, di), B and C (b, s, n) f32, dt (b, s,
    heads) f32, the new conv cache). B, C and dt come from the block's input,
    xc from the conv, as in the JAX block."""
    xc, new_conv = _causal_conv(x @ params["wx"], params["conv_w"], conv_cache)
    xc = F.silu(xc)
    z = x @ params["wz"]
    Bm = (x @ params["wB"]).float()
    Cm = (x @ params["wC"]).float()
    dt = _softplus((x @ params["wdt"]).float() + params["dt_bias"])
    return xc, z, Bm, Cm, dt, new_conv


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): out[..., i, j] = a[j+1] + ... + a[i] for j
    <= i (0 on the diagonal), -inf above it. Summed along the rows of a masked
    copy, not as a difference of cumulative sums, so a short span keeps its
    precision however long the chunk."""
    T = a.shape[-1]
    below = torch.ones((T, T), dtype=torch.bool, device=a.device).tril(-1)
    x = a[..., :, None].expand(*a.shape, T).masked_fill(~below, 0.0)
    out = torch.cumsum(x, dim=-2)
    return out.masked_fill(~torch.ones_like(below).tril(), -torch.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> torch.Tensor:
    """The Mamba2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t =
    h_t C_t from h = 0, in chunks of ``SSD_CHUNK`` steps. xh (b, s, H, P), dt (b,
    s, H), A (H,) <= 0, B and C (b, s, N), all f32; returns y (b, s, H, P)
    f32 (D x not added).

    Within a chunk y = (C B^T o L) (dt x) with L = exp(segsum(dt A)), which is
    at most 1 (dt A <= 0); each chunk's own end state is (decay to its end o
    dt x)^T B; a (chunks + 1)-square decay matrix over the chunk totals
    carries the states across chunks, and a chunk's rows read the state it
    starts from through C, decayed to each row. s is padded with dt = 0
    steps (no decay, no input) to whole chunks.

    DTensors (a meshed block) run each rank's batch rows and heads
    (``local_map``): the recurrence is per head, B and C are shared."""
    if isinstance(xh, DTensor):
        return _ssd_local(xh, dt, A, Bm, Cm)
    b, s, H, P = xh.shape
    n, chunk = Bm.shape[-1], SSD_CHUNK
    pad = (-s) % chunk
    if pad:
        xh, dt = F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    c = (s + pad) // chunk
    X = (xh * dt[..., None]).reshape(b, c, chunk, H, P).permute(0, 3, 1, 2, 4)  # (b, H, c, l, P)
    a = (dt * A).reshape(b, c, chunk, H).permute(0, 3, 1, 2)  # (b, H, c, l)
    Bc, Cc = Bm.reshape(b, c, chunk, n), Cm.reshape(b, c, chunk, n)
    a_cum = torch.cumsum(a, dim=-1)
    # within each chunk
    scores = (Cc @ Bc.transpose(-1, -2))[:, None] * torch.exp(_segsum(a))  # (b, H, c, l, l)
    y = scores @ X
    del scores
    # each chunk's own end state, then the states every chunk starts from
    decay_end = torch.exp(a_cum[..., -1:] - a_cum)  # (b, H, c, l)
    own = (X * decay_end[..., None]).transpose(-1, -2) @ Bc[:, None]  # (b, H, c, P, N)
    own = torch.cat([torch.zeros_like(own[:, :, :1]), own], dim=2)
    carry = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # (b, H, c + 1, c + 1)
    start = (carry @ own.flatten(-2)).unflatten(-1, (P, n))[:, :, :-1]  # (b, H, c, P, N)
    y = y + (Cc[:, None] @ start.transpose(-1, -2)) * torch.exp(a_cum)[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(b, c * chunk, H, P)[:, :s]


def _ssd_local(xh: DTensor, dt: DTensor, A: DTensor, Bm: DTensor, Cm: DTensor) -> DTensor:
    """:func:`ssd_scan` on each rank's batch rows and heads, placed by xh's
    placements (batch, heads or replicated a mesh dimension)."""
    mesh = xh.device_mesh
    r = Replicate()
    by = {Shard(0): (Shard(0), r, Shard(0)),  # batch: (dt, A, B and C)
          Shard(2): (Shard(2), Shard(0), r),  # heads
          r: (r, r, r)}
    px = tuple(xh.placements)
    if any(p not in by for p in px):
        raise ValueError(f"ssd_scan: xh splits on batch or heads only, got {px}")
    pdt, pa, pbc = (tuple(by[p][i] for p in px) for i in range(3))
    return run_local(ssd_scan, mesh, (px, pdt, pa, pbc, pbc), (px,), xh, dt, A, Bm, Cm)


def mamba2_forward(params: Params, x: torch.Tensor, d_state: int) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (b, s, d_model)."""
    b, s, _ = x.shape
    d_inner = params["out_proj"].shape[0]
    x = gather_tokens(x)
    xc, z, Bm, Cm, dt, _ = _mamba2_inputs(params, x)
    xc = shard_hint(xc, "batch", None, "model")
    xh = xc.reshape(b, s, d_inner // MAMBA2_HEAD_DIM, MAMBA2_HEAD_DIM).float()
    xh = shard_hint(xh, "batch", None, "model", None)
    A = -torch.exp(params["A_log"])
    y = ssd_scan(xh, dt, A, Bm, Cm) + params["D"][:, None] * xh
    y = shard_hint(y.reshape(b, s, d_inner), "batch", None, "model")
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"]


def init_mamba2_cache(batch: int, d_inner: int, d_state: int, conv_width: int,
                      dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner // MAMBA2_HEAD_DIM, MAMBA2_HEAD_DIM, d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  d_state: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (b, 1, d_model); returns (out, new cache)."""
    b = x.shape[0]
    d_inner = params["out_proj"].shape[0]
    xc, z, Bm, Cm, dt, new_conv = _mamba2_inputs(params, x, cache["conv"])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[:, 0] * A)  # (b, h)
    xh = xc[:, 0].reshape(b, d_inner // MAMBA2_HEAD_DIM, MAMBA2_HEAD_DIM).float()
    dBx = (dt[:, 0, :, None] * xh)[..., None] * Bm[:, 0][:, None, None, :]
    h = dA[..., None, None] * cache["ssm"] + dBx
    y = torch.einsum("bhdn,bn->bhd", h, Cm[:, 0]) + params["D"][:, None] * xh
    y = (y.reshape(b, 1, d_inner) * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}
