"""The reference against the port's plain CPU path at a tiny size."""
import time

import pytest
import torch

import spec
from conftest import tiny_cell
from reference import dfl as ref_dfl
from reference.weights import flatten, make_params

CELLS = ["falcon-mamba.tree", "falcon-mamba.int8-dissemination"]


@pytest.mark.parametrize("cell", CELLS)
def test_weights_have_the_ports_layout(cell):
    from repro_torch.models.model import Model

    driver = spec.load_module("drivers", "dfl_train")
    _, cfg, _, _ = tiny_cell(cell, "bfloat16")
    ours = flatten(make_params(cfg, 5, "cpu"))
    theirs = flatten(Model(driver.port_config(cfg), device="cpu").init(
        torch.Generator().manual_seed(5)))
    assert [(p, t.shape, t.dtype) for p, t in ours] == [(p, t.shape, t.dtype) for p, t in theirs]


def test_int8_wire_is_the_ports():
    from repro_torch.compress.codec import make_codec

    gen = torch.Generator().manual_seed(0)
    rows = torch.randn((4, 5000), generator=gen) * torch.logspace(-3, 1, 5000)
    rows[1, 1024:2048] = 0.0  # an all-zero chunk
    want = make_codec("int8").roundtrip_group([rows])[0]
    assert torch.equal(ref_dfl.int8_roundtrip(rows), want)


@pytest.mark.parametrize("mode,codec", [("tree_allreduce", ""), ("dissemination", "int8"),
                                        ("dissemination", "")])
def test_gossip_is_the_ports(mode, codec):
    from repro_torch.compress.codec import make_codec
    from repro_torch.dfl.collectives import GossipPlan, gossip_exchange

    master = torch.randn((4, 3, 700), generator=torch.Generator().manual_seed(1))
    got = gossip_exchange(mode, GossipPlan.build(4), {"w": master},
                          codec=make_codec(codec) if codec else None)["w"]
    torch.testing.assert_close(ref_dfl.gossip(master, mode, codec), got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port(cell):
    """The port's plain CPU path in f32 (f32 moments) against the reference:
    the three numbers at rounding. The int8 wire rounds each element to a
    step of its chunk's absmax / 127, so f32 rounding moves an element across
    a step now and then (3e-5 of a leaf's change here)."""
    driver = spec.load_module("drivers", "dfl_train")
    _, cfg, traffic, limits = tiny_cell(cell, "float32")
    cfg["optimizer"] = dict(cfg["optimizer"], moment_dtype="float32")
    ctx = driver.run(limits, cfg, traffic, 2 ** 31 + 11, 0.1, False, time.perf_counter(), "cpu")
    values = {r["name"]: r["value"] for r in ctx["checked"]}
    assert max(values.values()) < 1e-4, values
    assert ctx["correct"] and ctx["steps"] >= 1


# a dense (attention) configuration at a tiny size: the reference's other
# family, which no cell runs yet, against the port's granite preset
DENSE = {"name": "dense-tiny", "reference": "dense", "port_arch": "granite-3-2b",
         "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
         "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 300,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "dtype": "float32", "remat": False}


def test_dense_reference_follows_the_port():
    driver = spec.load_module("drivers", "dfl_train")
    _, falcon, traffic, limits = tiny_cell(CELLS[1], "float32")
    cfg = dict(DENSE, optimizer=dict(falcon["optimizer"], moment_dtype="float32"))
    ctx = driver.run(limits, cfg, traffic, 17, 0.1, False, time.perf_counter(), "cpu")
    values = {r["name"]: r["value"] for r in ctx["checked"]}
    assert max(values.values()) < 1e-4, values


@pytest.mark.parametrize("cell", CELLS)
def test_nodes_start_apart_and_the_program_starts_there(cell):
    """Each node's start differs from the seed's weights by its drift, the
    same on both sides; the program's rows hold them before its first step."""
    driver = spec.load_module("drivers", "dfl_train")
    _, cfg, traffic, _ = tiny_cell(cell, "bfloat16")
    base = dict(flatten(make_params(cfg, 9, "cpu")))
    starts = [dict(flatten(driver.node_start(cfg, traffic, 9, i, "cpu")))
              for i in range(traffic["nodes"])]
    table = base["embed/table"].float()
    moved = [(s["embed/table"].float() - table).std() for s in starts]
    assert all(0.5 * traffic["node_drift"] < m < 2 * traffic["node_drift"] for m in moved)
    assert not torch.equal(starts[0]["embed/table"], starts[1]["embed/table"])
    again = dict(flatten(driver.node_start(cfg, traffic, 9, 1, "cpu")))
    assert all(torch.equal(again[p], starts[1][p]) for p in again)

    state, _, _ = driver.start_state(driver.build(cfg, traffic, "cpu"), cfg, traffic, 9, "cpu")
    for tree in (state.params, state.opt_state["master"]):
        for path, rows in flatten(tree):
            for i, s in enumerate(starts):
                assert torch.equal(rows[i], s[path].to(rows.dtype)), (path, i)
