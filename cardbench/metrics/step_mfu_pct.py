"""step_mfu_pct (per layer, the whole step on the device): the model FLOPs
of a step over the window's mean step time (the CUDA events of
``step_ms_p90``, steps outside the profiler) and the card's bf16 dense
peak.

Model FLOPs, forward and backward with nothing recomputed: 6 x the
parameters of every matrix product x the tokens (the tied head counted once
as the logits' product over the published vocabulary; the embedding lookup
and norms none), plus attention's 12 x head_dim x heads operations a visible
(query, key) pair a sequence a layer (Q K^T and P V forward, twice that
backward). A Mamba1 layer's products are its seven projections; its
convolution and scan, elementwise, are left out.
"""
import peaks


def model_flops(hp, traffic) -> float:
    rows = traffic["nodes"] * traffic["rows_per_node"]
    s = traffic["seq_len"]
    d, n_layers, vocab = hp["hidden_size"], hp["num_hidden_layers"], hp["vocab_size"]
    attn = 0
    if "num_attention_heads" in hp:
        h, kv = hp["num_attention_heads"], hp["num_key_value_heads"]
        hd, ff = d // h, hp["intermediate_size"]
        per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff
        attn = 12 * hd * h * (s * (s + 1) // 2) * rows * n_layers
    else:
        di, n, r = hp["intermediate_size"], hp["state_size"], hp["time_step_rank"]
        per_layer = 2 * d * di + di * r + 2 * di * n + r * di + di * d
    return 6.0 * (n_layers * per_layer + d * vocab) * rows * s + attn


def read(ctx):
    ms = ctx["step_ms"]
    if not ms:
        return None
    step_s = sum(ms) / len(ms) / 1e3
    return 100.0 * model_flops(ctx["hyper"], ctx["traffic"]) / step_s / peaks.BF16_FLOPS
