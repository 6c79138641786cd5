"""Sharded serving of the port on four gloo ranks on the CPU: a (2, 2)
("data", "model") mesh (``launch/mesh.py::make_local_mesh``), the params
split by ``param_spec_tree`` (``distribute_tree``), the batch by
``batch_spec``, the decode cache made by ``Model.init_cache`` on the mesh
(each rank's shards of ``cache_spec_tree``), against the unsharded port on
the same seeded inputs.

One spawned group of four processes (a ``FileStore`` under ``tmp_path``)
runs every case, is joined with a timeout and destroys its group; the
pytest worker never holds a process group. Rank 0 writes what it measured,
and the tests below read it.

Six families at their f32 smoke widths (batch 4, 32 tokens): smollm-360m
(dense), falcon-mamba-7b (ssm), qwen3-moe-30b-a3b (moe) at
``moe_capacity_factor=100`` as ``tests/test_models.py`` decodes it and with
6 query / 3 kv heads (the smoke width's 4 / 4 divides "model"; 3 kv heads do
not, so the flash route takes each rank's query heads' kv heads by
expansion and the decode cache splits head_dim, as qwen3-moe's 4 kv heads
over 16 ranks do), zamba2-7b (hybrid), whisper-tiny (its decode cross cache
filled from a seed) and paligemma-3b (prefix; one kv head, so the flash
route slices it). Each splits at least one leaf on "model"; the moe
experts split on "data".

* prefill logits and 8 decode steps' logits within 1e-5 x max |logit| of
  the unsharded port (the all-reduced row-parallel products sum in another
  order);
* the collectives that ``CommDebugMode`` counts, per layer (a 2-layer run
  less a 1-layer run) and outside the layers, equal the table
  :data:`COMMS` (gloo has no all-to-all: DTensor moves a shard between
  dimensions as an all-gather there, so the moe's expert all-to-alls count
  as all-gathers); an extra all-gather (a silent replication) fails;
* the kernel ops see the ranks' local shapes: a rank's flash and scan
  FLOPs under the op counter are the unsharded call's over 4 (the batch over
  "data", the heads or channels over "model");
* a DTensor that reaches a kernel op (flash attention's and the scan's
  autograd Functions, the codec ops, the mix) raises by name.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402

FAMILIES = {
    "dense": ("smollm-360m", {}),
    "ssm": ("falcon-mamba-7b", {}),
    "moe": ("qwen3-moe-30b-a3b", {"moe_capacity_factor": 100.0, "n_heads": 6,
                                  "n_kv_heads": 3}),
    "hybrid": ("zamba2-7b", {}),
    "audio": ("whisper-tiny", {}),
    "vlm": ("paligemma-3b", {}),
}
B, S, CACHE, STEPS = 4, 32, 16, 8
TOL = 1e-5  # of max |logit|
WORLD = 4
TIMEOUT_S = 240

# collectives a run counts: per layer, and outside the layers (the embedding's
# all-reduce over the vocab split, the readout's gather), for the prefill and
# for one decode step. all_gather here includes gloo's all-to-all fallback.
AR, AG, RS = "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"
COMMS = {
    # dense layer, prefill: the sequence gathered ahead of attention and the
    # MLP, each row-parallel output reduce-scattered back to the sequence
    # split; decode: each row-parallel output all-reduced
    "dense": {"prefill": ({AG: 2, RS: 2}, {AR: 1, AG: 1}),
              "decode": ({AR: 2}, {AR: 1})},
    # Mamba1: the sequence gathered, dt_low, B and C all-reduced (row-parallel
    # x_proj over d_inner), out_proj reduce-scattered
    "ssm": {"prefill": ({AG: 1, AR: 3, RS: 1}, {AR: 1, AG: 1}),
            "decode": ({AR: 4}, {AR: 1})},
    # moe: attention as dense; tokens gathered for the router, the expert
    # inputs to the expert split and back (all-to-alls, gloo: gathers), the
    # experts' d_ff-split outputs all-reduced, the routing sums all-reduced;
    # decode with an hd-split cache: q to the hd split (an all-to-all), the
    # scores all-reduced, the output gathered
    "moe": {"prefill": ({AG: 4, RS: 1, AR: 2}, {AR: 1, AG: 1}),
            "decode": ({AR: 4, AG: 4}, {AR: 1})},
    # hybrid super-block (Mamba2 block + shared attention block): the
    # sequence gathered for the Mamba2 block, its out_proj reduce-scattered,
    # then a dense block
    "hybrid": {"prefill": ({AG: 3, RS: 3}, {AR: 1, AG: 1}),
               "decode": ({AR: 3}, {AR: 1})},
    # whisper decoder layer: self, cross and MLP; outside: the encoder's two
    # layers (2 gathers and 2 reduce-scatters each) and its output gathered
    "audio": {"prefill": ({AG: 3, RS: 3}, {AR: 1, AG: 6, RS: 4}),
              "decode": ({AR: 3}, {AR: 1})},
    # paligemma: a dense layer; decode with the one kv head's hd split: q to
    # the hd split (an all-to-all), the scores all-reduced, the output
    # gathered, the two row-parallel outputs all-reduced
    "vlm": {"prefill": ({AG: 2, RS: 2}, {AR: 1, AG: 1}),
            "decode": ({AR: 3, AG: 2}, {AR: 1})},
}


def _counts(comm):
    return {str(k).rsplit(".", 1)[-1]: v for k, v in comm.get_comm_counts().items() if v}


def _diff(a, b):
    out = {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}
    return {k: v for k, v in out.items() if v}


def _family(family, mesh):
    """One family: the measurements rank 0 reports."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_arch
    from repro_torch.dfl.sharding import (batch_axes, batch_spec, cache_spec_tree,
                                          distribute_tree, param_spec_tree, placements)
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import Batch, build_model

    arch, over = FAMILIES[family]
    out = {}
    for n_layers in (2, 1):
        kw = dict(over)
        if family == "hybrid":  # attn_every 2: two layers make one super-block
            kw["n_layers"] = 2 * n_layers
        else:
            kw["n_layers"] = n_layers
        cfg = get_arch(arch).smoke_variant().replace(**kw)
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
        extra = {}
        if family == "audio":
            extra["encoder_frames"] = torch.randn(B, cfg.n_frames, cfg.d_model, generator=g)
        if family == "vlm":
            extra["patch_embeddings"] = torch.randn(B, cfg.n_patches, cfg.d_model, generator=g)
        cache = model.init_cache(B, CACHE)
        if family == "audio":
            for k in ("cross_k", "cross_v"):
                cache[k] = torch.randn(cache[k].shape, generator=g)
        with torch.no_grad(), OpCounter() as ref_counter:
            ref, _ = model.forward(params, Batch(tokens, **extra))
        refs, c = [], cache
        with torch.no_grad():
            for t in range(STEPS if n_layers == 2 else 1):
                pos = torch.full((B,), t, dtype=torch.int64)
                lg, c = model.decode_step(params, tokens[:, t:t + 1], pos, c)
                refs.append(lg)

        model.set_mesh_context(mesh, batch_axes(mesh, B))
        try:
            specs = param_spec_tree(cfg, params, mesh)
            dp = distribute_tree(mesh, params, specs)
            dt = distribute_tensor(tokens, mesh, placements(mesh, batch_spec(mesh, B, 2)))
            dx = {k: distribute_tensor(v, mesh, placements(mesh, batch_spec(mesh, B, 3)))
                  for k, v in extra.items()}
            with torch.no_grad(), CommDebugMode() as comm, OpCounter() as counter:
                logits, _ = model.forward(dp, Batch(dt, **dx))
            prefill_comm = _counts(comm)
            dcache = model.init_cache(B, CACHE)
            if family == "audio":
                cspecs = cache_spec_tree(cfg, cache, mesh, B)
                for k in ("cross_k", "cross_v"):
                    dcache[k] = distribute_tensor(cache[k], mesh, placements(mesh, cspecs[k]))
            errs, decode_comm, c = [], None, dcache
            with torch.no_grad():
                for t, want in enumerate(refs):
                    pos = torch.full((B,), t, dtype=torch.int64)
                    with CommDebugMode() as comm:
                        lg, c = model.decode_step(dp, dt[:, t:t + 1], pos, c)
                    if decode_comm is None:
                        decode_comm = _counts(comm)
                    errs.append(float((lg.full_tensor() - want).abs().max()
                                      / want.abs().max()))
            full = logits.full_tensor()
        finally:
            model.set_mesh_context(None)
        out[n_layers] = {"prefill": prefill_comm, "decode": decode_comm}
        if n_layers == 2:
            model_dim = mesh.mesh_dim_names.index("model")
            split = [".".join(p) for p, pl in _walk(dp) if isinstance(pl[model_dim], Shard)]
            kernel = "selective_scan" if family == "ssm" else "flash_attention"
            out.update(
                prefill_err=float((full - ref).abs().max() / ref.abs().max()),
                decode_errs=errs,
                model_split=split,
                expert_placements=([str(x) for x in dp["blocks"]["moe"]["wg"].placements]
                                   if family == "moe" else None),
                kernel_flops=(counter.stats.flops_by_op[kernel],
                              ref_counter.stats.flops_by_op[kernel]),
                kernel_calls=(counter.stats.launches[kernel], ref_counter.stats.launches[kernel]),
                logits_type=type(logits).__name__,
            )
    per_layer = {k: _diff(out[2][k], out[1][k]) for k in ("prefill", "decode")}
    outside = {k: _diff(out[1][k], per_layer[k]) for k in ("prefill", "decode")}
    return {"per_layer": per_layer, "outside": outside,
            **{k: v for k, v in out.items() if not isinstance(k, int)}}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tuple(tree.placements)


def _raises_by_name(mesh):
    """Each kernel op given a DTensor: the message it raised (or "no raise")."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels.attention.ops import FlashAttention
    from repro_torch.kernels.codec import ops as codec_ops
    from repro_torch.kernels.mixing.ops import gossip_mix_op
    from repro_torch.kernels.scan.ops import SelectiveScan

    rep = [Replicate(), Replicate()]

    def d(*shape):
        return distribute_tensor(torch.randn(*shape), mesh, rep)

    q = d(1, 8, 2, 32)
    calls = {
        "flash_attention": lambda: FlashAttention.apply(q, q, q, True, 0, 0.0),
        "selective_scan": lambda: SelectiveScan.apply(
            d(1, 8, 4), d(1, 8, 2), d(1, 8, 2), d(1, 8, 4), d(4, 2), d(4), torch.float32),
        "codec": lambda: codec_ops.quantize_op(d(2, 64)),
        "gossip_mix": lambda: gossip_mix_op(d(1, 2, 8), torch.full((2,), 0.5)),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "no raise"
        except TypeError as e:
            out[name] = str(e)
    return out


def _worker(rank, path, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh((2, 2), device="cpu")
        results = {"families": {f: _family(f, mesh) for f in FAMILIES},
                   "raises": _raises_by_name(mesh)}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import torch.distributed as dist

    tmp = tmp_path_factory.mktemp("mesh_serve")
    out_path = str(tmp / "results.json")
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), out_path), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the gloo ranks ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert not dist.is_initialized()
    with open(out_path) as f:
        return json.load(f)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_logits_match_unsharded(results, family):
    r = results["families"][family]
    assert r["logits_type"] == "DTensor"
    assert r["prefill_err"] <= TOL, r["prefill_err"]
    assert len(r["decode_errs"]) == STEPS and max(r["decode_errs"]) <= TOL, r["decode_errs"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_a_leaf_splits_on_model(results, family):
    r = results["families"][family]
    assert r["model_split"], family
    if family == "moe":
        # (layer, expert@data, d, d_ff@model)
        assert r["expert_placements"] == ["S(1)", "S(3)"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_collectives_per_layer(results, family, kind):
    r = results["families"][family]
    per_layer, outside = COMMS[family][kind]
    assert r["per_layer"][kind] == per_layer, r["per_layer"][kind]
    assert r["outside"][kind] == outside, r["outside"][kind]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kernel_ops_see_local_shapes(results, family):
    r = results["families"][family]
    meshed, whole = r["kernel_flops"]
    calls, whole_calls = r["kernel_calls"]
    assert calls == whole_calls > 0
    assert meshed * 4 == whole, (meshed, whole)


@pytest.mark.parametrize("op", ["flash_attention", "selective_scan", "codec", "gossip_mix"])
def test_a_dtensor_at_a_kernel_op_raises_by_name(results, op):
    msg = results["raises"][op]
    assert "a DTensor reached the kernel's op" in msg, msg
